"""Differentiable collectives over one dimension of a mesh, for sequence
and pipeline parallelism.

``torch.distributed`` moves values and no gradients. JAX's ``ppermute``
and ``psum`` carry their transposes into the backward; these
``torch.autograd.Function`` s do the same by hand:

* :func:`shift`: each rank's tensor goes to the next (``+1``) or previous
  (``-1``) rank of the group, not circularly (the end rank receives
  zeros); the backward shifts the gradient the other way.
* :func:`all_sum`: the sum over the group; its backward is the sum again.
* :func:`broadcast`: the tensor of one rank on every rank; its backward
  sums the gradients onto that rank (the others' inputs get zeros).
* :func:`all_gather`: the ranks' blocks joined along a dimension; the
  backward gives each rank the sum of the gradients of its own block.

Every rank of the group calls each function at the same point of its
program, in the forward and, through autograd, in the backward. A group
is a :class:`Axis`: a process group, its size and this rank's index in it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One dimension of a mesh as this rank sees it: the process group of
    the ranks that differ from it only there, its size ``n`` and this
    rank's ``index`` along it (``ranks``: the group's global ranks by
    index)."""

    group: object
    n: int
    index: int
    ranks: tuple

    @classmethod
    def of(cls, mesh, dim: str) -> "Axis":
        group = mesh.get_group(dim)
        return cls(group, mesh.size(mesh.mesh_dim_names.index(dim)),
                   mesh.get_local_rank(dim),
                   tuple(dist.get_process_group_ranks(group)))


def send_recv(send: Optional[torch.Tensor], to: Optional[int],
              recv: Optional[torch.Tensor], frm: Optional[int],
              group) -> None:
    """Send ``send`` to global rank ``to`` and receive into ``recv`` from
    ``frm`` (either side None: none), both in flight at once."""
    ops = []
    if send is not None and to is not None:
        ops.append(dist.P2POp(dist.isend, send, to, group))
    if recv is not None and frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _shift(x: torch.Tensor, axis: Axis, offset: int) -> torch.Tensor:
    """``x`` of rank ``index - offset`` (zeros where there is none)."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    dst, src = axis.index + offset, axis.index - offset
    send_recv(x, axis.ranks[dst] if 0 <= dst < axis.n else None,
              out, axis.ranks[src] if 0 <= src < axis.n else None,
              axis.group)
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset):
        ctx.axis, ctx.offset = axis, offset
        return _shift(x, axis, offset)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.axis, -ctx.offset), None, None


def shift(x: torch.Tensor, axis: Axis, offset: int = 1) -> torch.Tensor:
    """Rank ``i`` receives rank ``i - offset``'s ``x`` (``offset`` +1 or
    -1); a rank with no such neighbour receives zeros."""
    return _Shift.apply(x, axis, offset)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = x.contiguous().clone()
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad, None


def all_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the group, on every rank."""
    return _AllSum.apply(x, axis)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, src):
        ctx.axis, ctx.src = axis, src
        out = x.contiguous().clone()
        dist.broadcast(out, axis.ranks[src], group=axis.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.axis.group)
        if ctx.axis.index != ctx.src:
            grad = torch.zeros_like(grad)
        return grad, None, None


def broadcast(x: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of the group (every rank passes
    a tensor of the same shape and dtype)."""
    return _Broadcast.apply(x, axis, src)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        parts: List[torch.Tensor] = [torch.empty_like(x.contiguous())
                                     for _ in range(axis.n)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad.chunk(ctx.axis.n, ctx.dim)[ctx.axis.index], None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in rank order."""
    return _AllGather.apply(x, axis, dim)
