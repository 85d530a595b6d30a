"""Independent streams from one run seed: weights, dropout, rows, samples."""
from __future__ import annotations

import numpy as np

STREAMS = {'weights': 1, 'dropout': 2, 'rows': 3, 'sample': 4}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of the run seed (any whole number)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
