"""The attention ops' least time (forward and backward) over their kernels'
device time in the traced steps."""
from benchmark.harness.readers import attn_roofline_pct as read  # noqa: F401
