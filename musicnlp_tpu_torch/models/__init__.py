"""Models (counterpart of musicnlp_tpu.models)."""
