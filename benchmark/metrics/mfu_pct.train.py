"""The model's forward and backward FLOPs per step (no recompute) times the
window's steps, over its time and the published bf16 peak."""
from benchmark.harness.readers import mfu_pct as read  # noqa: F401
