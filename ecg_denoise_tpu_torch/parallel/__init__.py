from ecg_denoise_tpu_torch.parallel import multihost
from ecg_denoise_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_gradients,
    make_mesh,
    replicate_state,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate_state",
           "all_reduce_gradients", "multihost"]
