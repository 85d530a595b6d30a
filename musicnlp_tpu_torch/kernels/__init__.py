"""Build and load of the hand-written CUDA kernels in ../csrc."""
