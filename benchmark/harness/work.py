"""The yardstick: published peaks, the least time of a call, the operations
and bytes of each attention op at a cell's shapes, and a step's model FLOPs.
Which calls a forward makes and what it multiplies are its family's
(`families/<family>.py`); the functions here delegate to it.

The peaks and `bounds` are copied from the bring-up smoke test
(`chip_smoke.py`), K1's and K2's work from its `k1_work` / `k2_work`, K3's
and K4's from its K3 / K4 cases, and the visible-pair counts from the
program's `_key_mask` (`ops/flash_attention.py`) and `visible_pairs`
(`ops/chunked_attention_kernel.py`), so that a change to the program cannot
move them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.harness import families

# NVIDIA H100 SXM data sheet, dense: bf16 / f16 tensor cores, f32 outside
# them, HBM3; an f32 call also gets the 3xTF32 rate its kernels can reach
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
ELEMENT = {'bfloat16': 2, 'float16': 2, 'float32': 4}

Call = Tuple[float, float, str]          # (flops, bytes, dtype) of one kernel call


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of a call: the larger of its operations at the dtype's
    peak (f32: at 3xTF32) and its bytes at the memory rate."""
    peak = TF32X3_FLOPS if dtype == 'float32' else PEAK_FLOPS[dtype]
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


# ------------------------------------------------------------ visible pairs
def causal_pairs(T: int, S: int, M: int, mem_valid: int, window: int) -> int:
    """Pairs (q, k) of K1 / K2: 0 <= M + q - k (< window), k >= M - mem_valid."""
    n = 0
    for q in range(T):
        hi = M + q                                 # largest visible k
        lo = max(M - mem_valid, 0)
        if window:
            lo = max(lo, M + q - window + 1)
        n += max(0, min(hi, S - 1) - lo + 1)
    return n


def window_pairs(T: int, chunk: int) -> int:
    """Pairs of a chunked-window call with positions in order: each query
    sees the earlier keys of its chunk, itself and the chunk before."""
    n_chunks = T // chunk
    own = chunk * (chunk + 1) // 2
    return n_chunks * own + (n_chunks - 1) * chunk * chunk


# ------------------------------------------------------------ op work
def rel_attn_fwd(BN: int, T: int, S: int, M: int, H: int, N: int, dtype: str,
                 mem_valid: int = 0, window: int = 0) -> Call:
    """K1: 3 H-long products (AC, BD, PV) per visible pair; rw, rr, k, v,
    the distance table [N, T+S, H] read once, ctx written once, lse f32."""
    e = ELEMENT[dtype]
    flops = 3 * 2 * H * causal_pairs(T, S, M, mem_valid, window) * BN
    nbytes = e * (2 * BN * T * H + 2 * BN * S * H + N * (T + S) * H + BN * T * H) + 4 * BN * T
    return flops, nbytes, dtype


def rel_attn_bwd(BN: int, T: int, S: int, M: int, H: int, N: int, dtype: str,
                 mem_valid: int = 0, window: int = 0) -> Call:
    """K2: 8 H-long products per visible pair (AC and BD again, dP, dV, dK,
    dRW, dRR, dG); rw, rr, out, dO, k, v, G, lse read once; drw, drr in the
    input dtype and dk, dv, dG in f32 written once."""
    e = ELEMENT[dtype]
    g = N * (T + S) * H
    flops = 8 * 2 * H * causal_pairs(T, S, M, mem_valid, window) * BN
    nbytes = (e * (4 * BN * T * H + 2 * BN * S * H + g) + 4 * BN * T
              + e * 2 * BN * T * H + 4 * (2 * BN * S * H + g))
    return flops, nbytes, dtype


def window_attn_fwd(G: int, T: int, D: int, chunk: int, dtype: str) -> Call:
    """K3: QK and PV per visible pair; q, k, v in, ctx out, two int32
    position rows in and the f32 lse out."""
    e = ELEMENT[dtype]
    return 2 * 2 * D * window_pairs(T, chunk) * G, (4 * e * D + 3 * 4) * G * T, dtype


def window_attn_bwd(G: int, T: int, D: int, chunk: int, dtype: str) -> Call:
    """K4: 5 products per visible pair; q, k, v, out, dO in the input dtype,
    positions, lse and dlse read, dq in the input dtype and dk, dv in f32
    written."""
    e = ELEMENT[dtype]
    return 5 * 2 * D * window_pairs(T, chunk) * G, (6 * e * D + 4 * 4 + 2 * 4 * D) * G * T, dtype


def attention_calls(config: Dict, B: int, T: int, backward: bool) -> Dict[str, List[Call]]:
    """{op: its calls in one forward (and backward)} at batch B, length T:
    `attention_calls` of the configuration's family."""
    return families.get(config['family']).attention_calls(config, B, T, backward)


def bytes_bound_lsh(call: Call) -> bool:
    """Whether a chunked-window call's bound is its bytes even were every
    pair of its windows visible (so the estimated pair count cannot move it)."""
    flops, nbytes, dtype = call
    peak = TF32X3_FLOPS if dtype == 'float32' else PEAK_FLOPS[dtype]
    return 2 * flops / peak <= nbytes / HBM_BYTES_PER_S


# ------------------------------------------------------------ model FLOPs
def matmul_params(config: Dict) -> int:
    """Weights that multiply every token (projections, feed-forwards, head):
    `matmul_params` of the configuration's family."""
    return families.get(config['family']).matmul_params(config)


def forward_flops(config: Dict, B: int, T: int) -> float:
    """One forward at batch B, length T: `forward_flops` of the
    configuration's family."""
    return families.get(config['family']).forward_flops(config, B, T)


def weight_and_attention_flops(params: int, calls: Dict[str, List[Call]], B: int, T: int
                               ) -> float:
    """2 per weight and token, and the attention's products over their
    visible pairs (`calls` of one forward, counted as the kernels' ops count
    them, less K2's recomputed scores): the part of a forward that every
    family has."""
    flops = 2.0 * params * B * T
    for cs in calls.values():
        flops += sum(c[0] for c in cs)
    return flops


def train_flops(config: Dict, B: int, T: int) -> float:
    """Forward and backward, no recompute: three forwards."""
    return 3.0 * forward_flops(config, B, T)


def peak_flops(config: Dict) -> float:
    return PEAK_FLOPS[config['model']['dtype']]
