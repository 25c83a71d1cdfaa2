"""Parallel training and evaluation over torch.distributed: the (data,
model) mesh, multi-process initialisation, and sequence-parallel decoder
attention (counterpart of `petr_tpu/parallel/`)."""
from petr_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    make_mesh,
    replicate,
    shard_batch,
    use_mesh,
)
