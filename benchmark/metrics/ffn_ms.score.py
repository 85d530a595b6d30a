"""Device ms a traced batch inside the program's `model.ffn` spans under
`score.batch`: every layer's feed-forward block (norm, both products,
dropout, residual add)."""
from benchmark.harness.spans import ffn_ms as read  # noqa: F401
