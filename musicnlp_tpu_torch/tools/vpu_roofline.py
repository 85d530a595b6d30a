"""Roofline of the chunked-attention kernel's mask / softmax chain on the card.

Counterpart of `scripts/vpu_roofline.py`.  That script asked, on the TPU,
whether the position-compare / exp / softmax passes inside K3's programs were
at the vector unit's floor.  This tool asks the same of the H100: it runs
K3's chain with no dot products (K5, `csrc/mask_chain.cu`) and a bare
multiply-add chain (K6, `csrc/muladd_chain.cu`) K times over the script's
shapes -- G = 64 "programs" of [M, C, W] = [8, 64, 128] f32, positions
kp = arange(W) - C, qp = arange(C), s from a seeded `torch.Generator` --
and differences K = 256 and K = 1024 to cancel the launch.  K5 runs the
chain with the bf16 K3's own arithmetic per element (`k3_tc`: one FFMA for
the fold and scale, the compares and selects, exp2f of (x - max) log2 e,
one reciprocal per row, a bf16 conversion), so its time is the share of
K3's time that the chain takes.

    python -m musicnlp_tpu_torch.tools.vpu_roofline [--out PATH]

writes one JSON object (default `build/vpu_roofline.json`):
  * `shape`, `grid`: [M, C, W] and G, as in the script;
  * `mask_chain_ns_per_pass`: card time of one chain pass over one
    [8, 64, 128] program, (t(1024) - t(256)) / (G * 768).  On the TPU the 64
    programs ran one after another; on the card they run at once on every
    SM, so this is the card's time amortised per program-pass;
    `mask_chain_bound_ns_per_pass` is the least such time (`bound`);
  * `muladd_ns_per_pass`: the same for one multiply-add pass, and
    `muladd_elems_per_sec` = 65,536 / that, in 10^9 elements per second
    (the script's unit);
  * the card's own in-situ comparator in place of the script's TPU constants:
    `insitu_k3_lsh_ms`, K3's time at the 22-04 LSH shape (G 768, T 2048,
    D 64, chunk 64, bf16, permuted positions and the self bias), and
    `insitu_k3_ns_per_program` = that time over the 768 * 32 / 8 = 3,072
    [8, 64, 128] program-equivalents it covers; `mask_chain_share_of_k3` is
    the chain's time per program over K3's: the share of K3 that its mask /
    softmax chain takes;
  * each timing is the median of `REPEATS` (5) calls, timed with CUDA
    events after a warm-up call.
It needs the card: without CUDA it raises.

The bound (`bound`) counts, per element and pass, the instructions that any
kernel of the chain within the tolerance must issue, each on the pipe that
executes it on compute capability 9.0 (lanes per SM per clock: NVIDIA's CUDA
C++ Programming Guide, arithmetic-instruction throughput; the four warp
schedulers of an SM dispatch 32 lanes per clock each, Hopper architecture
white paper):
  K5  FMA pipe (FFMA / FADD / FMUL, 128 lanes): 5 -- fold and scale in one
        FFMA, the self add, x - max, the sum, * 1/l.  log2 e costs no
        instruction: it folds into the constants that are pre-scaled anyway
        (s0 / 8, the fold constant, 1e4 and -1e9), so x is in log2 units and
        p = exp2(x - max), the difference still taken before any scaling
        (`tests/test_torch_k5_schedule.py` holds that chain within one bf16
        ulp of the plain version).  K5 itself multiplies (x - max) by log2 e,
        as K3 does: one FMUL more than the bound;
      ALU pipe (ISETP / FSEL / FMNMX / F2FP, 64 lanes): 5 -- the causal and
        the self compare, the mask select, the max, the bf16 conversion;
      MUFU (16 lanes): 1 ex2;
      dispatch (every instruction, 128 lanes): 11, which bounds it.
  K6  FMA pipe: 1 FFMA (dispatch 1).
Per-row work (shuffles, the reciprocal, the loop) is left out: it depends on
how many values a lane holds.  `sass_loop` counts what a kernel issues.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

from musicnlp_tpu_torch import resolve_device
from musicnlp_tpu_torch.ops import roofline_kernels as rk

__all__ = ['M', 'C', 'W', 'G', 'K_PAIR', 'REPEATS', 'chain_inputs', 'run_chain', 'run_muladd',
           'k3_lsh_ms', 'card_rates', 'bound', 'sass_loop', 'count_mma',
           'tensor_core_counts', 'roofline', 'main']

M, C, W = 8, 64, 128            # [m, c, 2c] of the base/2048 LSH kernel
G = 64                          # programs per call
K_PAIR = (256, 1024)
REPEATS = 5                     # timed calls per figure (median), after one warm-up
K3_PROGRAMS = 768 * (2048 // 64) // M      # [8, 64, 128] program-equivalents in one K3 call
# instructions per element and pass, by the pipe that executes them (module docstring)
OPS = {'mask_chain': dict(fma=5, alu=5, mufu=1), 'muladd_chain': dict(fma=1, alu=0, mufu=0)}
LANES_PER_SM = dict(fma=128, alu=64, mufu=16, dispatch=128)  # Hopper SM, per clock
LANE_VALUES = dict(mask_chain=32, muladd_chain=8)            # values each lane carries
HBM_BYTES_PER_S = 3.35e12                                   # H100 SXM (NVIDIA data sheet)
OUT_DEFAULT = Path(__file__).resolve().parents[2] / 'build' / 'vpu_roofline.json'


def chain_inputs(device, seed: int = 0):
    """(s [G, M, C, W] f32, kp [G, M, W], qp [G, M, C] int32) on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = torch.randn(G, M, C, W, generator=gen, device=device)
    kp = (torch.arange(W, dtype=torch.int32, device=device) - C).expand(G, M, W).contiguous()
    qp = torch.arange(C, dtype=torch.int32, device=device).expand(G, M, C).contiguous()
    return s, kp, qp


def _median_seconds(fn: Callable[[], object]) -> float:
    """Median over REPEATS calls of one call's card time (CUDA events), after
    one warm-up call."""
    fn()
    times = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def run_chain(K: int, device=None) -> float:
    """Seconds of one K5 call with K passes (median)."""
    s, kp, qp = chain_inputs(resolve_device(device), seed=0)
    return _median_seconds(lambda: rk.mask_chain(s, kp, qp, K))


def run_muladd(K: int, device=None) -> float:
    """Seconds of one K6 call with K passes (median)."""
    s = chain_inputs(resolve_device(device), seed=1)[0]
    return _median_seconds(lambda: rk.muladd_chain(s, K))


def k3_lsh_ms(device=None) -> float:
    """K3's time at the 22-04 LSH shape, in ms (median): G 768, T 2048, D 64,
    chunk 64, bf16, shared-QK keys and a random permutation of positions per
    row (the bucket sort's), scale 1 and the self bias."""
    from musicnlp_tpu_torch.ops.chunked_attention import SELF_BIAS
    from musicnlp_tpu_torch.ops.chunked_attention_kernel import chunked_window_attn_fwd
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    Gk, T, D = 768, 2048, 64
    q, v = (torch.randn(Gk, T, D, generator=gen, device=dev) for _ in range(2))
    k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) / D ** 0.5
    pos = torch.argsort(torch.rand(Gk, T, generator=gen, device=dev), dim=-1)
    pos = pos.to(torch.int32).contiguous()
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    return 1e3 * _median_seconds(lambda: chunked_window_attn_fwd(
        q, k, v, pos, pos, chunk=64, scale=1.0, self_bias=SELF_BIAS))


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(device=None) -> Dict[str, float]:
    """The card's own peak rates: SMs (torch) x lanes per SM per clock of each
    pipe x the maximum SM clock (nvidia-smi), and the HBM rate."""
    dev = resolve_device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(_nvidia_smi('clocks.max.sm').split()[0]) * 1e6
    return dict(sms=sms, clock_hz=clock_hz, bytes_per_s=HBM_BYTES_PER_S,
                **{f'{pipe}_per_s': lanes * sms * clock_hz
                   for pipe, lanes in LANES_PER_SM.items()})


def bound(name: str, K: int, elems: int, rates: Dict[str, float]) -> Dict[str, object]:
    """The least time of a `name` call with K passes over `elems` elements:
    the largest of each pipe's instructions (`OPS`) at its rate, all of them
    at the dispatch rate, and the bytes (s and the output once; K5's
    positions are < 1% and counted too).  `pipe` names the one that bounds."""
    ops = OPS[name]
    n = elems * K
    times = {pipe: ops[pipe] * n / rates[f'{pipe}_per_s'] for pipe in ops}
    times['dispatch'] = sum(ops.values()) * n / rates['dispatch_per_s']
    nbytes = 8 * elems + (4 * (G * M * W + G * M * C) if name == 'mask_chain' else 0)
    times['bytes'] = nbytes / rates['bytes_per_s']
    pipe = max(times, key=times.get)
    return dict(bound_ms=1e3 * times[pipe],
                bound_by='bytes' if pipe == 'bytes' else 'operations', pipe=pipe,
                **{f'{k}_ms': 1e3 * v for k, v in times.items()}, ops_per_elem_pass=ops)


def _cuobjdump() -> str:
    return shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')


_INSTR = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(.*?);')
_TARGET = re.compile(r'BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))')
_LABEL = re.compile(r'^\s*(\.L_x_\d+):')


def _opcode(instr: str) -> str:
    """The opcode of a SASS instruction with its modifiers, predicate dropped."""
    return re.sub(r'^@!?U?P\w+\s+', '', instr).split()[0]


def _sass(name: str) -> str:
    """`cuobjdump -sass` of the built library of `csrc/<name>.cu` (built if needed)."""
    from musicnlp_tpu_torch.kernels.build import build, lib_path
    build(name)
    return subprocess.run([_cuobjdump(), '-sass', str(lib_path(name))], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_loop(name: str) -> Dict[str, object]:
    """The SASS of `csrc/<name>.cu`'s kernel (`cuobjdump -sass` of the built
    library): its longest backward branch is the K loop; returns the
    instructions in one trip (one pass), per value a lane carries
    (`LANE_VALUES`: per element and pass) and by opcode, and the SASS text."""
    sass = _sass(name)
    body = sass[sass.index(f'{name}_kernel'):]
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        if line.lstrip().startswith('Function :') and instrs:
            break                                  # the next kernel
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            instrs.append((addr, m.group(2).strip()))
    loops = []
    for addr, text in instrs:
        t = _TARGET.search(text)
        if t:
            target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
            if target is not None and target <= addr:
                loops.append((addr - target, target, addr))
    if not loops:
        raise RuntimeError(f'no backward branch in the SASS of {name}_kernel')
    _, lo, hi = max(loops)
    trip = [text for addr, text in instrs if lo <= addr <= hi]
    opcodes: Dict[str, int] = {}
    for text in trip:
        op = _opcode(text).split('.')[0]
        opcodes[op] = opcodes.get(op, 0) + 1
    return dict(instructions_per_pass=len(trip),
                instructions_per_element=len(trip) / LANE_VALUES[name],
                opcodes=dict(sorted(opcodes.items())), loop=[hex(lo), hex(hi)], sass=sass)


_FUNCTION = re.compile(r'^\s*Function\s*:\s*(\S+)')


def count_mma(sass: str) -> Dict[str, int]:
    """Tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) in each kernel
    function of a `cuobjdump -sass` listing, by mangled function name."""
    counts: Dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
            continue
        ins = _INSTR.search(line)
        if fn is not None and ins:
            if _opcode(ins.group(2).strip()).startswith(('HMMA', 'HGMMA')):
                counts[fn] += 1
    return counts


def tensor_core_counts(name: str) -> Dict[str, int]:
    """`count_mma` of the built library of `csrc/<name>.cu` (built if needed)."""
    return count_mma(_sass(name))


def roofline(k3_ms: Optional[float] = None, device=None) -> Dict[str, object]:
    """The tool's JSON object (see the module docstring).  `k3_ms`: K3's
    measured time at the LSH shape, if the caller has it; else measured here."""
    dev = resolve_device(device)
    k1, k2 = K_PAIR
    t1, t2 = run_chain(k1, dev), run_chain(k2, dev)
    per_pass = (t2 - t1) / (G * (k2 - k1))
    m1, m2 = run_muladd(k1, dev), run_muladd(k2, dev)
    per_muladd = (m2 - m1) / (G * (k2 - k1))
    elems = M * C * W
    if k3_ms is None:
        k3_ms = k3_lsh_ms(dev)
    k3_program_ns = k3_ms * 1e6 / K3_PROGRAMS
    # the K-differenced bound: operations bound it (the bytes cancel in t2 - t1)
    bound_pass = bound('mask_chain', k2 - k1, G * elems, card_rates(dev))
    return dict(
        device=torch.cuda.get_device_name(dev), shape=[M, C, W], grid=G, k=[k1, k2],
        repeats=REPEATS, mask_chain_s=[t1, t2], muladd_s=[m1, m2],
        mask_chain_ns_per_pass=per_pass * 1e9,
        mask_chain_bound_ns_per_pass=bound_pass['bound_ms'] * 1e6 / (G * (k2 - k1)),
        muladd_ns_per_pass=per_muladd * 1e9,
        muladd_elems_per_sec=elems / per_muladd / 1e9,
        insitu_k3_lsh_ms=k3_ms, insitu_k3_programs=K3_PROGRAMS,
        insitu_k3_ns_per_program=k3_program_ns,
        mask_chain_share_of_k3=per_pass * 1e9 / k3_program_ns,
        note=('mask_chain_ns_per_pass is the card time of one pass of K3\'s compare / exp / '
              'softmax chain over one [8, 64, 128] program, amortised over the 64 programs '
              'the card runs at once, with the bf16 K3\'s own arithmetic per element (exp2f, '
              'one reciprocal per row, a bf16 conversion); insitu_k3_ns_per_program is K3\'s '
              'own time per program-equivalent on this card, and mask_chain_share_of_k3 is '
              'the share of it that the chain takes'))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog='python -m musicnlp_tpu_torch.tools.vpu_roofline',
                                description=__doc__.splitlines()[0])
    p.add_argument('--out', default=str(OUT_DEFAULT), help='JSON output path')
    a = p.parse_args(argv)
    res = roofline()
    print(json.dumps(res))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, 'w') as f:
        json.dump(res, f, indent=2)
    print('wrote', a.out)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
