"""Scoring, metrics and generation (counterpart of musicnlp_tpu.trainer)."""
from musicnlp_tpu_torch.trainer.melody_w2v import PitchEmbedding
