"""What a run and the reference may not load, compared by whole top-level
module names (the part before the first dot): the program's name begins
with the JAX package's, and must not match it."""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List, Set

FORBIDDEN_RUN = ('jax', 'jaxlib', 'flax', 'musicnlp_tpu')
FORBIDDEN_REFERENCE = FORBIDDEN_RUN + ('musicnlp_tpu_torch',)


def top(name: str) -> str:
    return name.split('.')[0]


def loaded(forbidden: Iterable[str] = FORBIDDEN_RUN) -> List[str]:
    """Loaded modules whose top-level name is one of `forbidden`."""
    bad = set(forbidden)
    return sorted(n for n in list(sys.modules) if top(n) in bad)


def imported_tops(path: Path) -> Set[str]:
    """Top-level names of every module a source file imports anywhere in it."""
    tree = ast.parse(Path(path).read_text(), str(path))
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out
