from ecg_denoise_tpu_torch.parallel import multihost
from ecg_denoise_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_gradients,
    gather_named,
    gather_state,
    make_mesh,
    replicate_state,
    shard_batch,
    shard_state_dp_tp,
    tp_param_spec,
    tp_param_specs,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate_state",
           "all_reduce_gradients", "tp_param_spec", "tp_param_specs",
           "shard_state_dp_tp", "gather_state", "gather_named", "multihost"]
