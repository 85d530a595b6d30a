"""Device ms a traced step inside the program's `train.optimizer` span: the
logged gradient norm and the AdamW step with its clip in `Trainer.train_step`."""
from benchmark.harness.spans import optimizer_ms as read  # noqa: F401
