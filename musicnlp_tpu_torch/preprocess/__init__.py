"""Extraction (`MusicExtractor`, the native `FastMidiExtractor`, the batch
extraction `MusicExport`), key finding, the detokenizer, transforms, the
columnar datasets and the legacy melody grid: copies of the pure-Python modules of
`musicnlp_tpu.preprocess`."""
from musicnlp_tpu_torch.preprocess.melody_grid import (
    GridVocab, MelodyGridDataset, MelodyGridExtractor, grid_decode,
)
