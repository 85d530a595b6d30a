"""Device ms a traced step inside the program's `train.forward` span: the
model's loss forward in `Trainer.train_step`."""
from benchmark.harness.spans import forward_ms as read  # noqa: F401
