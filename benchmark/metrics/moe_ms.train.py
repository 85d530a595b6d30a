"""Device ms a traced step inside the program's `model.moe` spans under
`train.step`: every expert layer's block in the loss forward (its norms,
the router, the dispatch, the held experts' grouped products, the combine,
the shared expert, the residual).  The backward's work runs on autograd's
thread, where no model span is open, so this reads the forward only."""
from benchmark.harness.spans import span_ms


def read(r):
    return span_ms(r, ('model.moe',))
