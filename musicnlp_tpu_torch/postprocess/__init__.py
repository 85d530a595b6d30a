"""Corpus statistics, dataset reports and training-curve summaries: copies of
`musicnlp_tpu.postprocess` (host-side; matplotlib is imported only inside the
plotting functions)."""
from musicnlp_tpu_torch.postprocess.music_stats import MusicStats
from musicnlp_tpu_torch.postprocess.music_visualize import MusicVisualize
from musicnlp_tpu_torch.postprocess.train_plot import (
    load_train_log, plot_train_curves, summarize_run,
)
