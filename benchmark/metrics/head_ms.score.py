"""Device ms a traced batch inside the program's `model.head` span under
`score.batch`: everything after the last layer (final norm, logits, CE,
argmax, accuracy)."""
from benchmark.harness.spans import head_ms as read  # noqa: F401
