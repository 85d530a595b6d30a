"""The model's forward FLOPs per batch times the window's batches, over its
time and the published bf16 peak."""
from benchmark.harness.readers import mfu_pct as read  # noqa: F401
