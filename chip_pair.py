"""Times `chip_smoke.py`'s timed f32 and small f16 K4 cases in the checkout at ROOT
(default: this one), so that two checkouts can be compared within one call
on the card, in the order parent, change, change, parent:

    python chip_pair.py build/parent; python chip_pair.py
    python chip_pair.py; python chip_pair.py build/parent

ROOT's `chip_smoke.py` builds ROOT's kernels and runs each case as phase 2b
does (held against the plain version, timed).  Prints the card, then one
line `PAIR <root> {case: [ms, max relative error]}`.  Needs one CUDA card."""
import json
import os
import sys

CASES = [   # name, dtype, G, T, D, chunk, lsh, pads, seed: phase 2b's timed K4 cases
    ('chunk128-d128-f32', 'float32', 16, 2048, 128, 128, True, 40, 151),
    ('d256-lsh-f32', 'float32', 48, 2048, 256, 64, True, 40, 149),
    ('lsh-f32', 'float32', 768, 2048, 64, 64, True, 0, 42),
    ('chunk128-f32', 'float32', 24, 2048, 64, 128, False, 0, 141),
    ('lsh-f16', 'float16', 48, 2048, 64, 64, True, 0, 144),
    ('chunk16-padded-f16', 'float16', 8, 480, 32, 16, True, 9, 146),
]


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from musicnlp_tpu_torch.kernels.build import build_all
    if not torch.cuda.is_available():
        print('chip_pair: CUDA is not available', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_power(), flush=True)
    build_all()
    cs.tensor_core_check({})
    out = {}
    for name, dtype, G, T, D, chunk, lsh, pads, seed in CASES:
        r = cs.k4_case(torch.device('cuda'), name, getattr(torch, dtype), G, T, D, chunk, lsh,
                       pads, seed, timed=True)
        out[name] = [r['ms'], max(r['rel_err'].values())]
    print('PAIR', root, json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
