"""Times `chip_smoke.py`'s K1, K3 and K4 cases below in the checkout at ROOT
(default: this one), so that two checkouts can be compared within one call
on the card, in the order parent, change, change, parent:

    python chip_pair.py build/parent; python chip_pair.py
    python chip_pair.py; python chip_pair.py build/parent

ROOT's `chip_smoke.py` builds ROOT's kernels and runs each case as phases 2
/ 2b do (held against the plain version, timed; SDPA as the yardstick).
Prints the card, then one line `PAIR <root> {case: [ms, max error, plain
ms, SDPA ms]}` (K1 / K3: ctx's largest absolute error; K4: the largest
relative error of dq, dk, dv).  Needs one CUDA card."""
import json
import os
import sys

K1_CASES = [   # name, dtype, B, N, T, M, H, clamp, mem_valid, window, seed: phase 2's
    ('d256-f32', 'float32', 2, 4, 1024, 0, 256, 1024, 0, 0, 19),
    ('d128-f32', 'float32', 2, 8, 1024, 0, 128, 1024, 0, 0, 13),
    ('d384-f32', 'float32', 2, 4, 1024, 0, 384, 1024, 0, 0, 22),
    ('base-f32', 'float32', 8, 12, 1024, 0, 64, 1024, 0, 0, 2),
    ('d256-bf16', 'bfloat16', 2, 4, 1024, 0, 256, 1024, 0, 0, 17),
    ('d384-bf16', 'bfloat16', 2, 4, 1024, 0, 384, 1024, 0, 0, 21),
    ('train-bf16', 'bfloat16', 21, 12, 1024, 0, 64, 1024, 0, 0, 7),     # k1_tc, the preset
]
K3_CASES = [   # name, dtype, G, T, D, chunk, lsh, pads, seed: phase 2b's
    ('d256-lsh-f32', 'float32', 48, 2048, 256, 64, True, 40, 138),
    ('d256-local-f32', 'float32', 24, 2048, 256, 64, False, 0, 140),
    ('d256-lsh-bf16', 'bfloat16', 48, 2048, 256, 64, True, 40, 136),
    ('lsh-f32', 'float32', 768, 2048, 64, 64, True, 0, 32),
    ('local-f32', 'float32', 384, 2048, 64, 64, False, 0, 34),
    ('lsh-padded-f32', 'float32', 96, 2048, 64, 64, True, 300, 36),
    ('chunk128-f32', 'float32', 24, 2048, 64, 128, False, 0, 131),
    ('chunk16-padded-f32', 'float32', 8, 480, 32, 16, True, 9, 135),
    ('d32-chunk32-single-block', 'float32', 8, 32, 32, 32, True, 4, 37),
    ('lsh-bf16', 'bfloat16', 768, 2048, 64, 64, True, 0, 31),            # k3_tc, the preset
    ('local-bf16', 'bfloat16', 384, 2048, 64, 64, False, 0, 33),         # k3_tc, the preset
    ('chunk128-bf16', 'bfloat16', 24, 2048, 64, 128, False, 0, 132),     # k3_union_tc
]
K4_CASES = [   # name, dtype, G, T, D, chunk, lsh, pads, seed: phase 2b's
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
    dev = torch.device('cuda')
    out = {}
    for name, dtype, *shape in K1_CASES:
        r = cs.k1_case(dev, name, getattr(torch, dtype), *shape, timed=True)
        out['k1-' + name] = [r['ms'], r['max_abs_err'], r['plain_ms'], r['library_ms']]
    for name, dtype, *shape in K3_CASES:
        r = cs.k3_case(dev, name, getattr(torch, dtype), *shape, timed=True)
        out['k3-' + name] = [r['ms'], r['max_abs_err'], r['plain_ms'], r['library_ms']]
    for name, dtype, *shape in K4_CASES:
        r = cs.k4_case(dev, name, getattr(torch, dtype), *shape, timed=True)
        out['k4-' + name] = [r['ms'], max(r['rel_err'].values()), r['plain_ms'],
                             r['library_ms']]
    print('PAIR', root, json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
