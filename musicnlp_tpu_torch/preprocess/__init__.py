"""Key finding, the detokenizer, transforms and the columnar datasets: copies of
the pure-Python modules of `musicnlp_tpu.preprocess` (the extractor comes later)."""
