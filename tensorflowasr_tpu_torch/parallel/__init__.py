from tensorflowasr_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
]
