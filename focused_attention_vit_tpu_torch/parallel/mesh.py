"""Mesh construction (port of ``focused_attention_vit_tpu/parallel/mesh.py``).

One mesh, named dimensions ``data`` (the batch and the gradient sum),
``model`` (tensor parallelism) and, when asked for, ``seq`` (sequence
parallelism, :mod:`.sequence`) and ``stage`` (pipeline parallelism,
:mod:`.pipeline`): a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the process group. The later dimensions are the inner ones, over
adjacent ranks, so that the tensor-parallel collectives, the halos and the
stage hand-offs stay between neighbours (on one host, over NVLink).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, sp: int = 1,
              pp: int = 1, axis_names: Sequence[str] = ("data", "model"),
              device_type: Optional[str] = None,
              unit_dims: Sequence[str] = ()) -> DeviceMesh:
    """A ``(data, model[, seq][, stage])`` mesh of shape
    ``[n/(tp·sp·pp), tp(, sp)(, pp)]`` over the ``n_devices`` ranks of the
    initialised process group (default: all of them; it must be all), as
    JAX's ``make_mesh``: ``seq`` is there when ``sp > 1``, ``stage`` when
    ``pp > 1``, and each also when named in ``unit_dims`` (a dimension of
    size 1, which drives the SP or PP path on one device).
    ``device_type`` defaults to ``"cuda"`` under NCCL and ``"cpu"`` under
    gloo."""
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
    shape = [n // (tp * sp * pp), tp]
    names = list(axis_names)
    for name, size in (("seq", sp), ("stage", pp)):
        if size > 1 or name in unit_dims:
            shape.append(size)
            names.append(name)
    grid = torch.as_tensor(np.arange(n).reshape(shape))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))
