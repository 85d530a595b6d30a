"""The attention forward op's least time over its kernels' device time in the
traced batches."""
from benchmark.harness.readers import attn_roofline_pct as read  # noqa: F401
