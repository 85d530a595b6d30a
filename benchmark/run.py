"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Caches that a run may build (Triton's,
torch's extension and kernel caches, the CUDA JIT cache) are fixed
directories under the checkout's `build/`, beside the kernels the program
builds there.  See `benchmark/README.md`.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (('TRITON_CACHE_DIR', 'triton'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('PYTORCH_KERNEL_CACHE_PATH', 'torch_kernels'), ('CUDA_CACHE_PATH', 'cuda_jit')):
    os.environ[var] = os.path.join(ROOT, 'build', 'bench_cache', sub)
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, ROOT)

if __name__ == '__main__':
    from benchmark.harness.runner import main
    sys.exit(main(t_start=T_START))
