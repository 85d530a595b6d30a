"""Device ms a traced step inside the program's `model.route` spans (nested
in `model.moe`) under `train.step`: each expert layer's router product,
sigmoid, top-k, weight normalisation, and the sort that dispatches its rows
(the rows' gather runs with the held experts, chunk by chunk).  The backward's work runs on autograd's thread, where no model
span is open, so this reads the forward only."""
from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, ('model.route',))
