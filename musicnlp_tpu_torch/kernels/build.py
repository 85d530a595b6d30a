"""Builds the port's CUDA kernels from `musicnlp_tpu_torch/csrc/` and loads them.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled with `nvcc` for
Hopper (`sm_90a`) into `build/kernels/lib<name>-<digest>.so` at the root of
the checkout, at first use, and opened with `ctypes`.  The digest covers the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import: the CPU tests import every module
on machines without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ['SOURCES', 'build', 'load']

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = ('flash_rel_attn_fwd',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_LIBS: Dict[str, ctypes.CDLL] = {}


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    h.update((CSRC / f'{name}.cu').read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:12]}.so'


def build(name: str) -> dict:
    """Compile `csrc/<name>.cu` unless it is built.  Returns {'seconds',
    'ptxas', 'cached'}; raises with the compiler's output if nvcc fails."""
    out = _lib_path(name)
    if out.exists():
        return dict(seconds=0.0, ptxas='', cached=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}:\n{proc.stdout}')
    os.replace(tmp, out)
    return dict(seconds=time.perf_counter() - t0, ptxas=proc.stdout, cached=False)


def load(name: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu` with `name`'s C signature set."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _LIBS[name] = lib
    return lib
