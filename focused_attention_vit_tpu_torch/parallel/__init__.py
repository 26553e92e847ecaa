"""Data, tensor and fully sharded parallelism over ``torch.distributed``
(port of ``focused_attention_vit_tpu/parallel``: the mesh, the multihost
start-up and the sharding layer; sequence and pipeline parallelism are not
ported yet)."""

from focused_attention_vit_tpu_torch.parallel.mesh import make_mesh
from focused_attention_vit_tpu_torch.parallel.multihost import (
    global_batch_from_host_data,
    host_batch_slice,
    initialize,
)
from focused_attention_vit_tpu_torch.parallel.sharding import (
    apply_tensor_parallel,
    make_sharded_train_step,
    param_sharding_rules,
    shard_params,
    shard_state,
    state_shardings,
)

__all__ = [
    "make_mesh",
    "initialize",
    "host_batch_slice",
    "global_batch_from_host_data",
    "apply_tensor_parallel",
    "param_sharding_rules",
    "shard_params",
    "shard_state",
    "state_shardings",
    "make_sharded_train_step",
]
