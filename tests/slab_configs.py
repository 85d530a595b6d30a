"""The instance tables of the slab kernels, read from their CUDA sources
(`with_cfg` in `csrc/flash_rel_attn_fwd.cu`, `csrc/flash_rel_attn_bwd.cu`,
`csrc/chunked_window_attn_fwd.cu` and `csrc/chunked_window_attn_bwd.cu`),
so that the tests that emulate or check the kernels' tiling follow the
table the C entry points launch from.

`with_cfg(D, f)` calls f with `Cfg<W, Z...>` for the head dim D: f32 by the
cases of its `if constexpr (kF32<E>)` block, then (every file) by the
return that follows, `f(Cfg<...>{})` or `D <= n ? f(Cfg<...>{}) :
f(Cfg<...>{})`, after its guard `D <= 128 || D % 128` (a head dim it
refuses).  Names in a Cfg resolve from the file's `constexpr int`s.  No
file here imports jax: the card's tests read the tables too."""
import re
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'musicnlp_tpu_torch' / 'csrc'


def _block(text, start):
    """The text inside the braces that open at or after `start`."""
    i = text.index('{', start)
    depth = 0
    for j in range(i, len(text)):
        depth += {'{': 1, '}': -1}.get(text[j], 0)
        if depth == 0:
            return text[i + 1:j], j + 1
    raise ValueError('unbalanced braces')


@lru_cache(maxsize=None)
def _table(name):
    src = (CSRC / f'{name}.cu').read_text()
    consts = {k: int(v) for k, v in re.findall(r'\b([A-Z][A-Z0-9]*) = (\d+)\b', src)}
    body, _ = _block(src, src.index('cudaError_t with_cfg('))
    f32, end = _block(body, body.index('if constexpr (kF32<E>)'))
    rest = body[end:]
    if rest.lstrip().startswith('else'):
        rest, _ = _block(rest, 0)
    cfg = lambda s: tuple(consts[x] if x in consts else int(x) for x in s.split(', '))
    cases = {int(d): cfg(c) for d, c in
             re.findall(r'case (\d+): return f\(Cfg<([\w, ]+)>\{\}\);', f32)}
    switch_end = _block(f32, f32.index('switch'))[1] if 'switch' in f32 else 0

    def tail(text):
        m = re.search(r'return (?:D|H) <= (\d+) \? f\(Cfg<([\w, ]+)>\{\}\) : '
                      r'f\(Cfg<([\w, ]+)>\{\}\);', text)
        if m:
            return lambda d: cfg(m[2]) if d <= int(m[1]) else cfg(m[3])
        m = re.search(r'return f\(Cfg<([\w, ]+)>\{\}\);', text)
        return (lambda d: cfg(m[1])) if m else None

    assert re.search(r'if \((?:D|H) <= 128 \|\| (?:D|H) % 128\) return cudaErrorInvalidValue;',
                     rest)
    return cases, tail(f32[switch_end:]), tail(rest)


def with_cfg(name, D, f32):
    """The Cfg<W, Z...> values `with_cfg` of `csrc/<name>.cu` picks for head
    dim D in f32 (f32=True) or 16 bits -> (W, Z...); ValueError where it
    refuses D."""
    cases, f32_tail, tail = _table(name)
    if f32 and D in cases:
        return cases[D]
    if D <= 128 or D % 128:
        raise ValueError(f'{name}: no slab instance at head dim {D}')
    return (f32_tail if f32 and f32_tail else tail)(D)
