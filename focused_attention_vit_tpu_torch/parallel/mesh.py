"""Mesh construction (port of ``focused_attention_vit_tpu/parallel/mesh.py``).

One mesh, two named dimensions: ``data`` (the batch and the gradient sum)
and ``model`` (tensor parallelism), a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group. ``model`` is the inner dimension, over adjacent ranks, so that the
tensor-parallel collectives stay between neighbours (on one host, over
NVLink). Sequence and pipeline parallelism are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from focused_attention_vit_tpu_torch import NotPortedError


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, sp: int = 1,
              pp: int = 1, axis_names: Sequence[str] = ("data", "model"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the ``n_devices`` ranks of the
    initialised process group (default: all of them; it must be all).

    ``tp`` is the size of ``model`` and must divide the rank count.
    ``device_type`` defaults to ``"cuda"`` under NCCL and ``"cpu"`` under
    gloo. ``sp > 1`` and ``pp > 1`` raise ``NotPortedError``."""
    for flag, value in (("sp", sp), ("pp", pp)):
        if value > 1:
            raise NotPortedError(
                f"--{flag} {value!r} is not ported yet: the PyTorch port's "
                f"mesh has the data and model dimensions only (see "
                f"ROADMAP.md)")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group "
            "(parallel.multihost.initialize, cli.main or torchrun)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n % (tp * sp * pp):
        raise ValueError(
            f"tp={tp} * sp={sp} * pp={pp} must divide device count {n}")
    if n != world:
        raise ValueError(
            f"the mesh spans every rank of the process group: n_devices={n} "
            f"but the group has {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.as_tensor(np.arange(n).reshape(n // tp, tp))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))
