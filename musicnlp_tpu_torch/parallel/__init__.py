"""Data and tensor parallelism over process groups (`parallel/mesh.py`)."""
from musicnlp_tpu_torch.parallel.mesh import (
    Mesh, batch_specs, gather_pytree, init_distributed, make_mesh, make_multislice_mesh,
    param_specs, replicated_specs, shard_pytree,
)
