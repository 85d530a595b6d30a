"""Device ms a traced batch inside the program's `model.attn` spans under
`score.batch`: every layer's attention block (norm, projections, attention,
dropout, residual add)."""
from benchmark.harness.spans import attention_ms as read  # noqa: F401
