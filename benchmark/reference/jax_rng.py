"""JAX's default PRNG (threefry2x32) in numpy: the benchmark's frozen copy.

The plain Reformer reference (`reformer.py` here) draws its LSH rotations with
it, so that it works them out itself and shares no code with the program.

The Reformer's LSH rotations are `jax.random.normal(fold_in(PRNGKey(seed),
layer), (R, D, nb // 2), float32)` (`musicnlp_tpu/models/reformer.py`), fixed
per layer and never trained, so a model trained by the JAX package hashes
with exactly these numbers.  This module reproduces them without JAX:
`threefry_2x32` (Salmon et al., Random123: 20 rounds, key schedule with the
0x1BD11BDA parity constant), `prng_key` / `fold_in` (the raw uint32 key
pair), `random_bits` in the `jax_threefry_partitionable` layout (counter =
the flat index of each element as a 64-bit (hi, lo) pair; 32-bit output =
the two hash words xor-ed), and `normal` (mantissa-filled uniform on
(-1, 1), then sqrt(2) * erfinv with XLA's f32 erfinv polynomial).  Bits,
keys and uniforms are exact; `normal` agrees with JAX to a few ulp (the
polynomial runs on numpy's log1p / sqrt).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ['prng_key', 'fold_in', 'random_bits', 'uniform', 'normal', 'threefry_2x32']

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 hash of counter pairs (x0, x1) under key (k0, k1)."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`'s raw key: (seed >> 32, seed & 0xFFFFFFFF)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in`: the hash of the counter pair (0, data)."""
    a, b = threefry_2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32-bit random bits in the partitionable layout."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = threefry_2x32(key, hi, lo)
    return (a ^ b).reshape(shape)


def uniform(key: np.ndarray, shape: Sequence[int], minval: float, maxval: float) -> np.ndarray:
    """f32 uniform on [minval, maxval): 23 random mantissa bits under exponent 0."""
    bits = random_bits(key, shape)
    fl = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, fl * (hi - lo) + lo)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erfinv (Giles' single-precision polynomial), in f32."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt, np.float32(a), np.float32(b)) + p * w).astype(np.float32)
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).astype(np.float32)
