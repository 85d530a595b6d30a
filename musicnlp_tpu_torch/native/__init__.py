"""The port's native (C++) host libraries: the MIDI extraction kernel and
the WordPiece trainer / encoder.

Counterpart of `musicnlp_tpu/native/__init__.py`.  `native/<name>.cpp`
(copies of the JAX package's sources) is compiled with
`g++ -O3 -std=c++17 -shared -fPIC` into `build/native/lib<name>-<digest>.so`
at the root of the checkout, at first use, and opened with `ctypes`.  The
digest covers the source and the flags, so an edited source is rebuilt and a
stale library is never loaded; nothing is written into the package
directory.  A build or load failure raises with the compiler's output (the
JAX loader returns None instead).  `_py_wordpiece.py` is the plain Python
version of the WordPiece library, which the tests hold it against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ['load_midi_extract_lib', 'load_wordpiece_lib', 'lib_path']

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
GXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

_LIBS: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    """Where `native/<name>.cpp` is (or will be) built."""
    h = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    h.update((SRC_DIR / f'{name}.cpp').read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:12]}.so'


def _load(name: str) -> ctypes.CDLL:
    """Compile `native/<name>.cpp` unless built, then dlopen it; raises on failure."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = lib_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        proc = subprocess.run(['g++', *GXX_FLAGS, str(SRC_DIR / f'{name}.cpp'), '-o', str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed for native/{name}.cpp:\n{proc.stderr}')
        os.replace(tmp, out)
    lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib


def load_midi_extract_lib() -> ctypes.CDLL:
    """The native MIDI extraction kernel (built if needed), `me_extract`'s
    signature set."""
    lib = _load('midi_extract')
    c_i64 = ctypes.c_longlong
    lib.me_extract.restype = c_i64
    lib.me_extract.argtypes = [ctypes.POINTER(ctypes.c_uint8), c_i64, c_i64, c_i64,
                               ctypes.POINTER(ctypes.c_int32), c_i64]
    return lib


def load_wordpiece_lib() -> ctypes.CDLL:
    """The native WordPiece trainer and encoder (built if needed), with the
    signatures of `wp_train`, `wp_encoder_new`, `wp_encoder_free` and
    `wp_encode` set."""
    lib = _load('wordpiece')
    c_i64, c_i32p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_longlong)
    c_i8p = ctypes.POINTER(ctypes.c_int8)
    lib.wp_train.restype = c_i64
    lib.wp_train.argtypes = [c_i32p, c_i64p, c_i64p, c_i64, c_i64, c_i64,
                             c_i32p, c_i64, c_i64p, c_i8p, c_i64]
    lib.wp_encoder_new.restype = ctypes.c_void_p
    lib.wp_encoder_new.argtypes = [c_i32p, c_i64p, c_i8p, c_i64]
    lib.wp_encoder_free.restype = None
    lib.wp_encoder_free.argtypes = [ctypes.c_void_p]
    lib.wp_encode.restype = c_i64
    lib.wp_encode.argtypes = [ctypes.c_void_p, c_i32p, c_i64, c_i32p, c_i64]
    return lib
