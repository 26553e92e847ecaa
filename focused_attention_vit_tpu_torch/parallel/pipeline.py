"""Pipeline parallelism (PP): GPipe over a ``stage`` group (port of
``focused_attention_vit_tpu/parallel/pipeline.py``).

The ``depth`` blocks split over the n ranks of the group: stage r holds
blocks ``[r·depth/n, (r+1)·depth/n)`` (:func:`stage_blocks`; the model's
other blocks become :class:`RemoteBlock` placeholders,
:func:`hold_stage_blocks`, so memory scales). The batch runs as M
microbatches through a fill-drain schedule of M + n - 1 ticks: at tick t
stage r applies its blocks to microbatch t - r, received from stage r-1
(stage 0 reads it from the input), and hands the result to stage r+1; the
last stage keeps the outputs, which then reach every stage by a broadcast.
Unlike JAX's SPMD program, a stage skips the ticks that have no microbatch
for it (JAX computes them on garbage and masks them out).

The backward is the reverse schedule, written out (:class:`_Schedule`):
each microbatch's graph is kept from the forward, and, last microbatch
first, stage r receives its output's gradient from stage r+1, runs
``torch.autograd.backward`` through its blocks (their parameters' ``.grad``
add up) and sends the input's gradient to stage r-1. The schedule is one
``torch.autograd.Function``, so ``loss.backward()`` drives it like any
other layer. Dropout folds (tick, stage) into the seed of each
microbatch's streams, as JAX folds them into its key.

Hand-offs are point-to-point (``batch_isend_irecv``) between neighbours,
so ``stage`` is the mesh's innermost dimension.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from focused_attention_vit_tpu_torch.parallel import collectives
from focused_attention_vit_tpu_torch.parallel.collectives import Axis


def stage_blocks(depth: int, axis: Axis) -> range:
    """The indices of the blocks stage ``axis.index`` holds."""
    if depth % axis.n:
        raise ValueError(
            f"depth={depth} must divide by {axis.n} pipeline stages")
    k = depth // axis.n
    return range(axis.index * k, (axis.index + 1) * k)


class RemoteBlock(nn.Module):
    """The place of a block that another stage holds: no parameters."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"this block is held by pipeline stage "
                           f"{self.stage}")


def stage_sharding_rules(model: nn.Module, axis: Axis) -> Dict[str, int]:
    """The stage that holds each block parameter of ``model`` (by
    ``named_parameters()`` name of the full model); the counterpart of
    JAX's ``stage_sharding_rules``, which puts the stacked depth axis over
    ``stage``. Parameters outside the blocks are on every stage."""
    depth = len(model.blocks)
    k = depth // axis.n
    stage_blocks(depth, axis)  # the divisibility check
    return {f"blocks.{name}": int(name.split(".")[0]) // k
            for name, _ in model.blocks.named_parameters()}


def hold_stage_blocks(model: nn.Module, axis: Axis) -> None:
    """Replace the blocks other stages hold by :class:`RemoteBlock` s, in
    place; parameter names stay the full model's."""
    mine = stage_blocks(len(model.blocks), axis)
    k = len(mine)
    for j in range(len(model.blocks)):
        if j not in mine:
            model.blocks[j] = RemoteBlock(j // k)


def _tick_rng(rng, base: Optional[tuple], tick: int, stage: int, device):
    """The dropout streams of one (tick, stage): the forward's seeds with
    both folded in (a tensor-parallel rank's local streams likewise)."""
    if rng is None:
        return None
    from focused_attention_vit_tpu_torch.models.layers import DropoutRNG
    from focused_attention_vit_tpu_torch.train.steps import fold_in

    shared, local = base

    def seed(s):
        return fold_in(fold_in(s, tick), stage)

    return DropoutRNG(seed(shared), device,
                      local=None if local is None
                      else DropoutRNG(seed(local), device))


def _draw(gen) -> int:
    return int(torch.randint(0, 2**62, (), generator=gen))


class _Schedule:
    """The fill-drain schedule of one forward, and its reverse."""

    def __init__(self, apply_block, blocks, axis: Axis, m: int, rng):
        self.apply_block, self.axis, self.m = apply_block, axis, m
        self.blocks = [blocks[j] for j in stage_blocks(len(blocks), axis)]
        self.rng = rng
        self.base = None if rng is None else (
            _draw(rng.host), None if rng.local is None
            else _draw(rng.local.host))
        self.graphs: Dict[int, tuple] = {}

    def _stage(self, x, tick):
        r = _tick_rng(self.rng, self.base, tick, self.axis.index, x.device)
        for block in self.blocks:
            x = self.apply_block(block, x, r)
        return x

    def _recv(self, like, frm):
        buf = torch.empty_like(like)
        collectives.send_recv(None, None, buf, self.axis.ranks[frm],
                              self.axis.group)
        return buf

    def _send(self, x, to):
        collectives.send_recv(x.contiguous(), self.axis.ranks[to], None,
                              None, self.axis.group)

    def forward(self, x: torch.Tensor, keep: bool) -> torch.Tensor:
        n, s, m = self.axis.n, self.axis.index, self.m
        xm = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        outputs = torch.zeros_like(xm)
        for mb in range(m):
            inp = xm[mb] if s == 0 else self._recv(xm[mb], s - 1)
            if keep:
                inp = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = self._stage(inp, s + mb)
                self.graphs[mb] = (inp, out)
            else:
                out = self._stage(inp, s + mb)
            if out.dtype != inp.dtype:
                raise TypeError(f"a stage changed the activations' dtype "
                                f"from {inp.dtype} to {out.dtype}")
            if s < n - 1:
                self._send(out.detach(), s + 1)
            else:
                outputs[mb] = out.detach()
        return outputs.reshape(x.shape)

    def backward(self, grad: torch.Tensor) -> torch.Tensor:
        n, s, m = self.axis.n, self.axis.index, self.m
        gm = grad.reshape(m, grad.shape[0] // m, *grad.shape[1:])
        gx = torch.zeros_like(gm)
        for mb in reversed(range(m)):
            inp, out = self.graphs.pop(mb)
            g = gm[mb] if s == n - 1 else self._recv(out, s + 1)
            torch.autograd.backward(out, g)
            gin = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if s > 0:
                self._send(gin, s - 1)
            else:
                gx[mb] = gin
        return gx.reshape(grad.shape)


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: ``anchor`` (a scalar that
    requires grad) keeps the node in the graph when ``x`` does not."""

    @staticmethod
    def forward(ctx, x, anchor, schedule):
        ctx.schedule = schedule
        return schedule.forward(x, keep=True)

    @staticmethod
    def backward(ctx, grad):
        return ctx.schedule.backward(grad.contiguous()), None, None


def spmd_pipeline(apply_block: Callable, blocks, x: torch.Tensor, mesh,
                  axis: str = "stage", microbatches: Optional[int] = None,
                  rng=None) -> torch.Tensor:
    """Run the ``depth`` blocks of ``blocks`` (an ``nn.ModuleList`` whose
    other stages' entries may be :class:`RemoteBlock` s) over ``x``
    ``[B, S, D]`` as a pipeline over the ``axis`` dimension of ``mesh``
    (or an :class:`~.collectives.Axis`). ``apply_block(block, x, rng)``
    applies one block; ``rng`` (a ``DropoutRNG`` or None) seeds each
    (tick, stage). M = ``microbatches`` or the stage count must divide
    the batch, and the stage count the depth (JAX's errors).

    Every stage passes an ``x`` of the same shape (only stage 0's values
    are read) and gets the output ``[B, S, D]``, equal to applying the
    blocks in order to each microbatch (exactly, in eval). Every rank of
    the group calls it, and calls the backward."""
    ax = mesh if isinstance(mesh, Axis) else Axis.of(mesh, axis)
    stage_blocks(len(blocks), ax)
    m = microbatches or ax.n
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch={b} must divide by {m} microbatches")
    schedule = _Schedule(apply_block, blocks, ax, m, rng)
    grad = torch.is_grad_enabled() and (
        x.requires_grad
        or any(p.requires_grad for blk in schedule.blocks
               for p in blk.parameters()))
    if grad:
        anchor = torch.zeros((), device=x.device, requires_grad=True)
        out = _Pipeline.apply(x, anchor, schedule)
    else:
        out = schedule.forward(x, keep=False)
    return collectives.broadcast(out, ax, ax.n - 1)
