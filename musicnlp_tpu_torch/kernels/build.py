"""Builds the port's CUDA kernels from `musicnlp_tpu_torch/csrc/` and loads them.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled with `nvcc` for
Hopper (`sm_90a`) into `build/kernels/lib<name>-<digest>.so` at the root of
the checkout, at first use (or all at once by `build_all`, one `nvcc` per
source started together), and opened with `ctypes`.  The digest covers the
source, every shared header `csrc/*.cuh` and the flags, so an edited source
or header is rebuilt and a stale library is never loaded.  Nothing here runs
at import: the CPU tests import every module on machines without `nvcc`.
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

__all__ = ['SOURCES', 'build', 'build_all', 'lib_path', 'load']

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
SOURCES = ('flash_rel_attn_fwd', 'flash_rel_attn_bwd', 'chunked_window_attn_fwd',
           'chunked_window_attn_bwd', 'mask_chain', 'muladd_chain', 'bias_act')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_LIBS: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is (or will be) built."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in [CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:12]}.so'


def _nvcc() -> str:
    return shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, dict]:
    """Compile every `csrc/<name>.cu` that is not built, one `nvcc` process
    per source, all started together.  Returns {name: {'seconds', 'ptxas',
    'cached'}}; raises with the compiler's output if an nvcc fails (after all
    have ended)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            info[name] = dict(seconds=0.0, ptxas='', cached=True)
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed for {name}:\n{log}')
            continue
        os.replace(tmp, out)
        info[name] = dict(seconds=time.perf_counter() - t0, ptxas=log, cached=False)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return info


def build(name: str) -> dict:
    """Compile `csrc/<name>.cu` unless it is built (see `build_all`)."""
    return build_all((name,))[name]


def load(name: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu` with `name`'s C signature set."""
    lib = _LIBS.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(lib_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _LIBS[name] = lib
    return lib
