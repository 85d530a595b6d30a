"""Copy of `musicnlp_tpu/utils/seq_metrics.py` (pure Python): the port keeps its own copy
and imports nothing from the JAX package; only the import paths differ
(held against the original by tests/test_torch_postprocess.py).

Small token-sequence / distribution comparison metrics.

Shared by the int8 decode certification (tests/test_int8_generation_cert.py,
scripts/int8_spot_tpu.py) and the real-corpus distributional scoring
(scripts/train_real.py) so the edge-case handling (empty strings, zero
counts) lives in exactly one place.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ['norm_edit_distance', 'js_divergence']


def norm_edit_distance(a: str, b: str) -> float:
    """Token-level Levenshtein distance normalized by the longer length.

    0.0 for identical (or both-empty) token sequences, 1.0 for fully
    disjoint ones.  O(len(a)*len(b)) single-row DP.
    """
    a, b = a.split(), b.split()
    if not a and not b:
        return 0.0
    dp = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, dp[0] = dp[0], i
        for j, y in enumerate(b, 1):
            prev, dp[j] = dp[j], min(dp[j] + 1, dp[j - 1] + 1,
                                     prev + (x != y))
    return dp[-1] / max(len(a), len(b))


def js_divergence(p: Dict, q: Dict) -> float:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between two count
    dicts; keys missing on one side count as 0 (epsilon-smoothed)."""
    keys = sorted(set(p) | set(q))
    a = np.array([float(p.get(k, 0)) for k in keys]) + 1e-12
    b = np.array([float(q.get(k, 0)) for k in keys]) + 1e-12
    a, b = a / a.sum(), b / b.sum()
    m = (a + b) / 2

    def kl(x, y):
        return float(np.sum(x * np.log2(x / y)))

    return 0.5 * kl(a, m) + 0.5 * kl(b, m)
