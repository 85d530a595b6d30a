"""The share of the window's time a step in which no device operation ran (busy
time from the traced steps)."""
from benchmark.harness.readers import device_idle_pct as read  # noqa: F401
