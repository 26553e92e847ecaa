"""Process-group start-up and the per-rank batch (port of
``focused_attention_vit_tpu/parallel/multihost.py``).

The JAX package runs one controller per host over a global array; the port
runs one process per device, each holding its own rows. :func:`initialize`
joins the group from the environment's rendezvous, as ``torchrun`` and
:mod:`.launch` set it (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, or an explicit ``init_method``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def default_backend() -> str:
    """``nccl`` where CUDA is available, else ``gloo``."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group``, once per process:
    ``coordinator_address`` is an ``init_method`` URL (default: the
    environment's ``MASTER_ADDR``/``MASTER_PORT``), ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``; ``backend``
    to NCCL on CUDA and gloo on the CPU."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend or default_backend(),
        init_method=coordinator_address or "env://",
        world_size=int(num_processes if num_processes is not None
                       else os.environ["WORLD_SIZE"]),
        rank=int(process_id if process_id is not None
                 else os.environ["RANK"]))


def host_batch_slice(global_batch: int, mesh=None) -> Tuple[int, int]:
    """``(start, size)`` of this rank's rows of a global batch, over the
    ``data`` dimension of ``mesh`` (default: every rank of the group is a
    data rank)."""
    if mesh is not None:
        n, i = mesh.size(0), mesh.get_local_rank("data")
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} data ranks")
    per = global_batch // n
    return i * per, per


def global_batch_from_host_data(local_array, mesh=None, pspec=None):
    """The identity: each rank keeps its own shard of the batch and the
    process group, not a global array, joins them (JAX assembles one
    ``jax.Array`` from the hosts' shards here). ``mesh`` and ``pspec`` are
    accepted for the JAX signature."""
    return local_array
