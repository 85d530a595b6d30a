"""Plain-PyTorch ops and the K1 kernel wrapper (counterpart of musicnlp_tpu.ops)."""
