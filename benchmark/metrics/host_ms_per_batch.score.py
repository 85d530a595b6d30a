"""The benchmark's host-clock span around each score_batch call, summed over
the window's batches, per batch."""
from benchmark.harness.readers import host_ms_per_unit as read  # noqa: F401
