"""Extraction (`MusicExtractor`, the native `FastMidiExtractor`, the batch
extraction `MusicExport`), key finding, the detokenizer, transforms and the
columnar datasets: copies of the pure-Python modules of
`musicnlp_tpu.preprocess`."""
