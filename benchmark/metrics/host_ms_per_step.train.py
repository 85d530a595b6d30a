"""The benchmark's host-clock span around each Trainer.train_step call, summed
over the window's steps, per step."""
from benchmark.harness.readers import host_ms_per_unit as read  # noqa: F401
