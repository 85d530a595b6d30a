"""Device ms a traced step inside the program's `train.backward` span: the
gradients (`torch.autograd.grad`), the zero fill of unread leaves and the
sum over data ranks in `Trainer.train_step`."""
from benchmark.harness.spans import backward_ms as read  # noqa: F401
