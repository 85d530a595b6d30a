"""Checkpoints and the JAX weight bridge (counterpart of musicnlp_tpu.utils)."""
