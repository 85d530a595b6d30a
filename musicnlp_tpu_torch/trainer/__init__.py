"""Scoring, metrics and generation (counterpart of musicnlp_tpu.trainer)."""
