"""The numbers `correct` compares, worked out from the program's outputs
and the plain reference's."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

LOGIT_POSITIONS = 2048      # positions of a batch whose logits the check compares


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    """Whether every compared number is within its limit: `correct`."""
    return all(c['value'] <= c['limit'] for c in checks.values())


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Iterable[str]] = None,
               med_of: Optional[Dict[str, float]] = None) -> Tuple[float, str]:
    """The largest gap over the leaves `keep` between the two sides' norms
    of a leaf, over the reference's norm of that leaf or of the median leaf
    (of `med_of`, by default of `keep`), whichever is larger; and the leaf."""
    keys = list(keep) if keep is not None else list(ref)
    med = statistics.median((med_of or {k: ref[k] for k in keys}).values())
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median over leaves of the gap `worst_leaf` takes the largest of."""
    med = statistics.median(ref.values())
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


def moving_leaves(ref_grad: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others move under AdamW by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= share * med]


def logit_positions(valid: np.ndarray, salt: int, k: int = LOGIT_POSITIONS) -> np.ndarray:
    """[n, 2] (row, position) pairs, row-major, drawn from where `valid` holds
    (positions whose next label counts); `salt` and the rows fix the draw."""
    at = np.argwhere(valid)
    rng = np.random.default_rng([salt, len(at)])
    return at[np.sort(rng.choice(len(at), size=min(k, len(at)), replace=False))]


def logit_gap(prog: Optional[torch.Tensor], ref: torch.Tensor) -> float:
    """The median over positions of the distance between the two sides'
    logits ([n, V] each) over the spread of the reference's (its distance
    from its own mean); 1e30 where the program gave none or other positions."""
    if prog is None or tuple(prog.shape) != tuple(ref.shape):
        return 1e30
    prog, ref = prog.double(), ref.double()
    spread = torch.linalg.vector_norm(ref - ref.mean(-1, keepdim=True), dim=-1)
    dist = torch.linalg.vector_norm(prog - ref, dim=-1)
    return float((dist / spread.clamp_min(1e-30)).median())
