"""Data, tensor and fully sharded parallelism (port of
``focused_attention_vit_tpu/parallel/sharding.py``).

JAX annotates shardings and lets GSPMD insert the collectives. PyTorch has
no partitioner, so the port builds the layout that JAX's rules imply, by
hand, one process per device over a ``(data, model)`` mesh
(:func:`~.mesh.make_mesh`):

* **TP (Megatron), over ``model``** (:func:`apply_tensor_parallel`): each
  rank keeps its slices of the weights as plain parameters. Attention is
  split per head: the fused qkv weight is viewed as ``[3, h, d, D]`` and
  sliced on ``h``, the output projection on its input columns, and the
  layer's ``num_heads`` becomes ``h/tp``. The MLP's ``fc1`` is sliced on
  its output columns (with its bias) and ``fc2`` on its input columns. An
  identity with an all-reduce backward runs before the column-parallel
  products (a forward pre-hook on the attention and the MLP), and an
  all-reduce with an identity backward after the row-parallel ones
  (:class:`RowParallelLinear`, whose full bias is added once after the
  sum). A layer whose heads (hidden width) ``tp`` does not divide stays
  replicated, as JAX's rules fall back. The shared ``latent_proj`` of the
  MHLA layer sees only the rank's heads, so its gradient is summed over the
  model group after the backward (:meth:`Layout.finish_grads`; GSPMD adds
  that sum in JAX). DTensor would not dispatch into the ctypes kernels, and
  a column split of the fused qkv ``Linear`` would cut its ``3`` axis, not
  its heads.
* **DP, over ``data``**: ``DistributedDataParallel`` on the data group.
* **FSDP, over ``data``** (``fsdp=True``): ``fully_shard`` (FSDP2) on each
  block and on the root, over the ``data`` sub-mesh, in place of DDP. It
  shards dimension 0 of every (tensor-parallel) parameter in
  ``torch.chunk`` pieces; JAX picks the largest free dimension that the
  data size divides.

Every rank reads the same global batch (the same prefetcher, the same
seed) and runs its ``data`` rows (:func:`data_rows`); the augmentation is
drawn for the global batch and sliced, so a data-parallel step equals the
single process. Dropout folds the data rank into its key; under TP the
values every rank of a model group holds (the residual stream, the MLP's
output, the embeddings) draw from one shared stream, and the rank's heads
and MLP columns from its own (:func:`dropout_rng`).

A checkpoint holds the full, single-device state: :meth:`Layout.full_state`
gathers it (FSDP shards, then TP slices) on every rank for rank 0 to write,
and :meth:`Layout.load_full_state` cuts a full state back into this rank's
pieces, so a checkpoint restores across topologies.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from focused_attention_vit_tpu_torch.models.layers import (
    MLP,
    MultiHeadAttention,
    MultiHeadLatentAttention,
    SequentialMLP,
)

DATA, MODEL, SEQ, STAGE = "data", "model", "seq", "stage"

# A tensor-parallel slice: the full parameter is viewed as ``view`` and cut
# into ``tp`` pieces along ``view[dim]``, which is parameter dimension
# ``param_dim``.
Rule = Tuple[Tuple[int, ...], int, int]


def mesh_size(mesh, dim: str) -> int:
    """The size of ``dim`` (1 where the mesh has no such dimension)."""
    if dim not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(dim))


def loss_share(mesh) -> float:
    """The share of the loss a rank backpropagates: every rank of a
    ``seq`` and ``stage`` group computes the same loss, so each takes
    1/(sp·pp) of it and the parameters those ranks share sum their
    gradients (:meth:`Layout.finish_grads`); the sum is the gradient of one
    loss, as each collective's backward is its transpose."""
    if mesh is None:
        return 1.0
    return 1.0 / (mesh_size(mesh, SEQ) * mesh_size(mesh, STAGE))


def data_rows(batch: int, mesh) -> slice:
    """This rank's rows of a global batch of ``batch``: a contiguous
    ``batch / dp`` block, by its ``data`` coordinate."""
    dp = mesh_size(mesh, DATA)
    if batch % dp:
        raise ValueError(
            f"batch {batch} must be divisible by the data-parallel size {dp}")
    per = batch // dp
    r = mesh.get_local_rank(DATA)
    return slice(r * per, (r + 1) * per)


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The data ranks' row blocks of ``t`` joined in rank order: the global
    batch's rows."""
    parts = [torch.empty_like(t) for _ in range(mesh_size(mesh, DATA))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(DATA))
    return torch.cat(parts)


def sum_over_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the data group (a new tensor)."""
    t = t.clone()
    dist.all_reduce(t, group=mesh.get_group(DATA))
    return t


def dropout_rng(seed: int, device, mesh):
    """The :class:`~..models.layers.DropoutRNG` of one rank's forward:
    ``seed`` with the data rank folded in (``seed`` itself at data size 1,
    so that one data rank draws the single process's masks), then the
    ``seq`` and the ``stage`` rank where those sizes are above 1 (each
    sequence rank drops its own rows; the pipeline folds in its tick and
    stage besides, :mod:`.pipeline`), and at model
    size > 1 with ``local`` streams seeded by the model rank, which the
    tensor-parallel layers draw their heads' and MLP columns' dropout from
    (each global head then has its own masks and band seeds), while the
    replicated values draw from the shared streams, equal across the model
    group."""
    from focused_attention_vit_tpu_torch.models.layers import DropoutRNG
    from focused_attention_vit_tpu_torch.train.steps import fold_in

    for dim in (DATA, SEQ, STAGE):
        if mesh is not None and mesh_size(mesh, dim) > 1:
            seed = fold_in(seed, mesh.get_local_rank(dim))
    local = None
    if mesh is not None and mesh_size(mesh, MODEL) > 1:
        local = DropoutRNG(fold_in(seed, 1 + mesh.get_local_rank(MODEL)),
                           device)
    return DropoutRNG(seed, device, local=local)


# --- tensor parallelism ------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward, gradient summed over the model group: in front of
    the column-parallel products."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward, identity backward: after the
    row-parallel products."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _copy_input_to_model(group, module, args):
    return (_CopyToModel.apply(args[0], group),) + tuple(args[1:])


class RowParallelLinear(nn.Linear):
    """An ``nn.Linear`` that holds this rank's slice of the input columns:
    the partial product is summed over the model group, then the full bias
    is added once. Parameter names stay ``weight`` and ``bias``."""

    def __init__(self, in_features: int, out_features: int, group):
        super().__init__(in_features, out_features, device="meta")
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _ReduceFromModel.apply(F.linear(x, self.weight), self.group)
        return y + self.bias.to(y.dtype)


def _attention_rules(mod: nn.Module) -> Dict[str, Rule]:
    qkv_w, qkv_b, proj = (
        ("qkv.weight", "qkv.bias", "proj") if hasattr(mod, "qkv")
        else ("in_proj_weight", "in_proj_bias", "out_proj"))
    three_hd, d = mod.get_parameter(qkv_w).shape
    h = mod.num_heads
    hd = three_hd // (3 * h)
    out = mod.get_submodule(proj).out_features
    return {
        qkv_w: ((3, h, hd, d), 1, 0),
        qkv_b: ((3, h, hd), 1, 0),
        f"{proj}.weight": ((out, h, hd), 1, 1),
    }


def _mlp_rules(mod: nn.Module) -> Dict[str, Rule]:
    fc1, fc2 = ("fc1", "fc2") if isinstance(mod, MLP) else ("0", "3")
    hidden, d = getattr(mod, fc1).weight.shape
    return {
        f"{fc1}.weight": ((hidden, d), 0, 0),
        f"{fc1}.bias": ((hidden,), 0, 0),
        f"{fc2}.weight": ((d, hidden), 1, 1),
    }


def _tp_modules(model: nn.Module, tp: int):
    """``(name, module, rules, column, row)`` of each layer that ``tp``
    slices (attention whose heads ``tp`` divides, MLPs whose hidden width
    it divides), with the names of its column-parallel and row-parallel
    submodules (None where the product is a raw parameter)."""
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, (MultiHeadAttention, MultiHeadLatentAttention)):
            if mod.num_heads % tp == 0:
                fused = hasattr(mod, "qkv")
                out.append((name, mod, _attention_rules(mod),
                            "qkv" if fused else None,
                            "proj" if fused else "out_proj"))
        elif isinstance(mod, (MLP, SequentialMLP)):
            col, row = ("fc1", "fc2") if isinstance(mod, MLP) else ("0", "3")
            if mod.get_submodule(col).out_features % tp == 0:
                out.append((name, mod, _mlp_rules(mod), col, row))
    return out


def _local_shape(shape, rule: Rule, tp: int):
    shape = list(shape)
    shape[rule[2]] //= tp
    return shape


def tp_slice(full: torch.Tensor, rule: Rule, rank: int, tp: int
             ) -> torch.Tensor:
    """Model rank ``rank``'s piece of a full parameter (a copy)."""
    view, dim, _ = rule
    return full.reshape(view).chunk(tp, dim)[rank].reshape(
        _local_shape(full.shape, rule, tp)).contiguous()


def tp_join(pieces: List[torch.Tensor], rule: Rule, full_shape
            ) -> torch.Tensor:
    """The full parameter from the model ranks' pieces, in rank order."""
    view, dim, _ = rule
    local_view = list(view)
    local_view[dim] //= len(pieces)
    return torch.cat([p.reshape(local_view) for p in pieces],
                     dim).reshape(full_shape)


def _set_param(root: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, attr = name.rpartition(".")
    mod = root.get_submodule(owner) if owner else root
    grad = getattr(mod, attr).requires_grad
    setattr(mod, attr, nn.Parameter(value, requires_grad=grad))


def apply_tensor_parallel(model: nn.Module, mesh
                          ) -> Dict[str, Tuple[Rule, Tuple[int, ...]]]:
    """Slice ``model``'s attention and MLPs in place over the mesh's
    ``model`` dimension (the module docstring says how); returns the rule
    and the full shape of each sliced parameter, by ``named_parameters()``
    name. At model size 1 the layers keep every head but still run
    through the model group's collectives."""
    tp = mesh_size(mesh, MODEL)
    rank = mesh.get_local_rank(MODEL)
    group = mesh.get_group(MODEL)
    sliced: Dict[str, Tuple[Rule, Tuple[int, ...]]] = {}
    for name, mod, rules, col, row in _tp_modules(model, tp):
        prefix = f"{name}." if name else ""
        for pname, rule in rules.items():
            full = mod.get_parameter(pname)
            sliced[prefix + pname] = (rule, tuple(full.shape))
            with torch.no_grad():
                _set_param(mod, pname, tp_slice(full.detach(), rule, rank, tp))
        old = mod.get_submodule(row)
        new = RowParallelLinear(old.weight.shape[1], old.out_features, group)
        new.weight, new.bias = old.weight, old.bias
        setattr(mod, row, new)
        if col is not None:
            mod.get_submodule(col).out_features //= tp
        if isinstance(mod, (MultiHeadAttention, MultiHeadLatentAttention)):
            mod.num_heads //= tp
        mod.tp_local = True
        mod.register_forward_pre_hook(
            functools.partial(_copy_input_to_model, group))
    return sliced


def _model_summed(model: nn.Module) -> List[str]:
    """Names of the replicated parameters fed by head-local values (the
    MHLA layer's shared ``latent_proj``): their gradient is partial."""
    return [f"{name}.latent_proj.{p}"
            for name, mod in model.named_modules()
            if isinstance(mod, MultiHeadLatentAttention) and mod.tp_local
            for p in ("weight", "bias")]


# --- the layout of a sharded model -------------------------------------------


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


@dataclass
class Layout:
    """How a model is spread over ``mesh``: the tensor-parallel slices
    (``sliced``: name -> (rule, full shape)), FSDP2 over ``data`` (else its
    gradients are replicated there: by DDP on a ``(data, model)`` mesh, by
    :meth:`finish_grads` once the mesh has ``seq`` or ``stage``), the
    blocks each pipeline stage holds (``stage_of``: block parameter name ->
    stage; empty without ``stage``), the bare module (``module``) whose
    parameter names are the single process's, its parameters as sharded
    (``params``, by name: the objects the optimizer holds; FSDP2 swaps
    unsharded ones into the module while they are in use), and the full
    model's parameter names in order (``full_names``)."""

    mesh: Any
    module: nn.Module
    fsdp: bool
    sliced: Dict[str, Tuple[Rule, Tuple[int, ...]]] = field(
        default_factory=dict)
    summed: List[str] = field(default_factory=list)
    params: Dict[str, nn.Parameter] = field(default_factory=dict)
    stage_of: Dict[str, int] = field(default_factory=dict)
    full_names: List[str] = field(default_factory=list)

    @property
    def dp(self) -> int:
        return mesh_size(self.mesh, DATA)

    @property
    def tp(self) -> int:
        return mesh_size(self.mesh, MODEL)

    @property
    def sp(self) -> int:
        return mesh_size(self.mesh, SEQ)

    @property
    def pp(self) -> int:
        return mesh_size(self.mesh, STAGE)

    @property
    def manual_data_sync(self) -> bool:
        """Whether :meth:`finish_grads` averages over ``data`` (DDP does it
        on a ``(data, model)`` mesh, FSDP2 under ``fsdp``)."""
        return not self.fsdp and any(
            d in self.mesh.mesh_dim_names for d in (SEQ, STAGE))

    def finish_grads(self) -> None:
        """After the backward, before the update: sum the partial gradients
        of :func:`_model_summed`'s parameters over the model group; average
        every gradient over ``data`` where no wrapper did
        (:attr:`manual_data_sync`); sum every gradient over ``seq`` and
        those of the parameters every stage holds over ``stage`` (each rank
        took its :func:`loss_share` of the loss)."""
        group = self.mesh.get_group(MODEL)
        for name in self.summed:
            g = self.params[name].grad
            if g is not None:
                dist.all_reduce(_local(g), group=group)
        dims = [(DATA, self.manual_data_sync and self.dp > 1),
                (SEQ, SEQ in self.mesh.mesh_dim_names),
                (STAGE, STAGE in self.mesh.mesh_dim_names)]
        for dim, on in dims:
            if not on:
                continue
            group = self.mesh.get_group(dim)
            for name, p in self.params.items():
                if not p.requires_grad or (dim == STAGE
                                           and name in self.stage_of):
                    continue
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                g = _local(p.grad)
                dist.all_reduce(g, group=group)
                if dim == DATA:
                    g.div_(self.dp)

    def grad_norm_sq(self, params) -> torch.Tensor:
        """The squared global norm of the gradients of ``params`` (this
        rank's pieces): each piece's sum of squares divided by the number
        of ranks that hold the same values, summed over every rank."""
        names = {id(p): n for n, p in self.params.items()}
        total = None
        for p in params:
            if p.grad is None:
                continue
            name = names.get(id(p))
            copies = (1 if self.fsdp else self.dp) * self.sp
            if name not in self.sliced:
                copies *= self.tp
            if name not in self.stage_of:
                copies *= self.pp
            s = _local(p.grad).float().pow(2).sum() / copies
            total = s if total is None else total + s
        if total is None:
            total = torch.zeros((), device=self.device)
        dist.all_reduce(total)
        return total

    @property
    def device(self) -> torch.device:
        return _local(next(iter(self.params.values()))).device

    # The full, single-device state ------------------------------------------

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        if name in self.sliced:
            rule, shape = self.sliced[name]
            pieces = [torch.empty_like(t) for _ in range(self.tp)]
            dist.all_gather(pieces, t.contiguous(),
                            group=self.mesh.get_group(MODEL))
            t = tp_join(pieces, rule, shape)
        return t.detach()

    def _piece(self, name: str, full: torch.Tensor, like: torch.Tensor
               ) -> torch.Tensor:
        """This rank's piece of ``full`` in ``like``'s layout (a DTensor
        shard under FSDP)."""
        if name in self.sliced:
            full = tp_slice(full, self.sliced[name][0],
                            self.mesh.get_local_rank(MODEL), self.tp)
        if hasattr(like, "to_local"):
            from torch.distributed.tensor import DTensor

            # FSDP2's torch.chunk pieces: a rank past the last chunk (a
            # dimension 0 shorter than the data size) holds an empty one.
            chunks = full.chunk(self.dp, 0)
            r = self.mesh.get_local_rank(DATA)
            piece = chunks[r] if r < len(chunks) else full[:0]
            piece = piece.to(like.to_local().device, like.dtype).contiguous()
            return DTensor.from_local(piece, like.device_mesh, like.placements,
                                      run_check=False, shape=like.shape,
                                      stride=like.stride())
        return full.to(like.device, like.dtype)

    def _opt_names(self, tx) -> Tuple[List[str], List[str]]:
        """The parameter names in the order of this rank's optimizer and in
        that of the single process's (the index a checkpoint's AdamW state
        is keyed by): labels in ``group_lrs`` order, names in model
        order."""
        ids = {id(p): n for n, p in self.params.items()}
        local = [ids[id(p)] for g in tx.adamw.param_groups
                 for p in g["params"]]
        names = self.full_names or list(self.params)
        single = [n for label in tx.spec.group_lrs for n in names
                  if tx.spec.label_fn(n) == label]
        return local, single

    def full_state(self, state) -> Dict[str, Any]:
        """The state tree of a single-device checkpoint (model state dict,
        AdamW state by the single process's parameter index, update count,
        step), gathered on every rank (a collective: every rank calls it);
        under pipeline parallelism each stage's blocks are broadcast over
        ``stage``."""
        model = {n: self._full(n, p) for n, p in self.params.items()}
        model.update((n, b.detach()) for n, b in self.module.named_buffers())
        opt = state.tx.adamw.state_dict()
        local, single = self._opt_names(state.tx)
        index = {n: i for i, n in enumerate(single)}
        full_opt = {}
        for i, name in enumerate(local):
            entry = opt["state"].get(i)
            if entry is None:
                continue
            full_opt[index[name]] = {
                k: (self._full(name, v)
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in entry.items()}
        groups = opt["param_groups"]
        if self.stage_of:
            model, full_opt = self._gather_stages(model, full_opt, single)
            groups = self._single_groups(state.tx, groups, single)
        return {"model": model,
                "optimizer": {"state": dict(sorted(full_opt.items())),
                              "param_groups": groups},
                "count": int(state.tx.count), "step": int(state.step)}

    def _gather_stages(self, model, opt, single):
        """Every stage's blocks (full tensors) and their AdamW state on
        every rank: each stage broadcasts over the ``stage`` group what it
        holds, after a gather of the shapes."""
        from focused_attention_vit_tpu_torch.parallel.collectives import Axis

        ax = Axis.of(self.mesh, STAGE)

        def spec(v):
            if torch.is_tensor(v) and v.dim() > 0:
                return ("tensor", tuple(v.shape), v.dtype)
            return ("value", v.cpu() if torch.is_tensor(v) else v)

        mine = {"model": {n: spec(t) for n, t in model.items()
                          if n in self.stage_of},
                "opt": {i: {k: spec(v) for k, v in e.items()}
                        for i, e in opt.items() if single[i] in self.stage_of}}
        metas = [None] * ax.n
        dist.all_gather_object(metas, mine, group=ax.group)

        def bcast(src, own, shape, dtype):
            t = (own.contiguous() if src == ax.index
                 else torch.empty(shape, dtype=dtype, device=self.device))
            dist.broadcast(t, ax.ranks[src], group=ax.group)
            return t

        for src, meta in enumerate(metas):
            for n, (_, shape, dtype) in meta["model"].items():
                model[n] = bcast(src, model.get(n), shape, dtype)
            for i, entry in meta["opt"].items():
                own = opt.get(i, {})
                opt[i] = {k: (bcast(src, own.get(k), sp[1], sp[2])
                              if sp[0] == "tensor" else sp[1])
                          for k, sp in entry.items()}
        return model, opt

    def _single_groups(self, tx, groups, single):
        """The single process's AdamW param groups: one for each label
        with parameters, holding their single-process indices."""
        from focused_attention_vit_tpu_torch.train.state import _lr_at

        by_label = {g["label"]: g for g in groups}
        out, start = [], 0
        for label in tx.spec.group_lrs:
            n = sum(1 for name in single if tx.spec.label_fn(name) == label)
            if not n:
                continue
            g = dict(by_label.get(label) or dict(
                groups[0], label=label,
                lr=_lr_at(tx.spec.group_lrs[label], tx.count)))
            g["params"] = list(range(start, start + n))
            out.append(g)
            start += n
        return out

    def load_full_state(self, state, tree: Dict[str, Any]) -> None:
        """Cut a full state tree (:meth:`full_state`'s, or a single
        process's checkpoint) into this rank's pieces, in place (a stage
        takes its own blocks)."""
        names = {id(p): n for n, p in self.params.items()}
        with torch.no_grad():
            for n, p in self.params.items():
                _local(p).copy_(_local(self._piece(n, tree["model"][n], p)))
            for n, b in self.module.named_buffers():
                b.copy_(tree["model"][n])
        params = [p for g in state.tx.adamw.param_groups for p in g["params"]]
        local, single = self._opt_names(state.tx)
        index = {n: i for i, n in enumerate(single)}
        opt = tree["optimizer"]
        saved = {int(i): e for i, e in opt["state"].items()}
        entries = {}
        for i, name in enumerate(local):
            entry = saved.get(index[name])
            if entry is None:
                continue
            p = params[i]
            entries[i] = {
                k: (self._piece(names[id(p)], v, p).to(v.dtype)
                    if torch.is_tensor(v) and v.dim() > 0 else v)
                for k, v in entry.items()}
        groups = opt["param_groups"]
        if self.stage_of:
            by_label = {g["label"]: g for g in groups}
            groups, start = [], 0
            for g in state.tx.adamw.param_groups:
                n = len(g["params"])
                groups.append(dict(by_label[g["label"]],
                                   params=list(range(start, start + n))))
                start += n
        state.tx.adamw.load_state_dict({"state": entries,
                                        "param_groups": groups})
        state.tx.count = tree["count"]
        state.step = tree["step"]

    def agree(self, flag: bool) -> bool:
        """True on every rank when it is True on any (a preemption poll all
        ranks act on together)."""
        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


def shard_params(model: nn.Module, mesh, *, fsdp: bool = False,
                 ddp: Optional[bool] = None,
                 tensor_parallel: Optional[bool] = None) -> nn.Module:
    """Spread ``model`` (on its device) over ``mesh`` and return the module
    to call: under pipeline parallelism (the model's ``pp``, set by
    ``enable_pipeline_parallel``) the blocks of other stages are dropped
    (:func:`~.pipeline.hold_stage_blocks`); then tensor parallelism
    (``tensor_parallel``; default: when the mesh's ``model`` size is above
    1), then FSDP2 on each held block and the root (``fsdp``), else DDP over
    the data group (``ddp``; default: when the data size is above 1 and the
    mesh has neither ``seq`` nor ``stage``, whose gradient sums
    :meth:`Layout.finish_grads` makes). The :class:`Layout` is the returned
    module's ``favit_layout``."""
    full_names = [n for n, _ in model.named_parameters()]
    stage_of = {}
    if getattr(model, "pp", None) is not None:
        from focused_attention_vit_tpu_torch.parallel import pipeline

        stage_of = pipeline.stage_sharding_rules(model, model.pp)
        pipeline.hold_stage_blocks(model, model.pp)
    if tensor_parallel is None:
        tensor_parallel = mesh_size(mesh, MODEL) > 1
    sliced = apply_tensor_parallel(model, mesh) if tensor_parallel else {}
    layout = Layout(mesh, model, fsdp=fsdp, sliced=sliced,
                    summed=_model_summed(model), stage_of=stage_of,
                    full_names=full_names)
    wrapped = model
    data_mesh = mesh[DATA]
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        from focused_attention_vit_tpu_torch.parallel.pipeline import (
            RemoteBlock,
        )

        for blocks in (m for n, m in model.named_children()
                       if isinstance(m, nn.ModuleList)):
            for block in blocks:
                if not isinstance(block, RemoteBlock):
                    fully_shard(block, mesh=data_mesh)
        fully_shard(model, mesh=data_mesh)
    layout.params = dict(model.named_parameters())
    if ddp is None:
        ddp = mesh_size(mesh, DATA) > 1 and not layout.manual_data_sync
    if not fsdp and ddp:
        from torch.nn.parallel import DistributedDataParallel

        dev = layout.device
        wrapped = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=mesh.get_group(DATA))
    wrapped.favit_layout = layout
    return wrapped


def _placements(params, model_dims: Dict[str, int], fsdp: bool
                ) -> Dict[str, Tuple]:
    """Per parameter, per dimension: ``None`` (replicated), ``"model"``
    (its ``model_dims`` dimension), ``"data"`` (FSDP's shard of dimension
    0) or ``("model", "data")``."""
    out = {}
    for name, p in params:
        spec = [None] * p.dim()
        if name in model_dims:
            spec[model_dims[name]] = MODEL
        if fsdp and p.dim():
            spec[0] = DATA if spec[0] is None else (spec[0], DATA)
        out[name] = tuple(spec)
    return out


def param_sharding_rules(model: nn.Module, mesh, *, fsdp: bool = False
                         ) -> Dict[str, Tuple]:
    """The placement of each parameter of the plain ``model`` (by
    ``named_parameters()`` name) that :func:`shard_params` gives it: per
    dimension ``None`` (replicated), ``"model"`` (sliced over the model
    group), ``"data"`` (FSDP's shard) or ``("model", "data")``. The qkv
    weight's ``"model"`` dimension is cut per head in each of q, k and v."""
    tp = mesh_size(mesh, MODEL)
    dims = {}
    for name, _, rules, _, _ in (_tp_modules(model, tp) if tp > 1 else []):
        prefix = f"{name}." if name else ""
        dims.update((prefix + p, rule[2]) for p, rule in rules.items())
    return _placements(model.named_parameters(), dims,
                       fsdp and mesh_size(mesh, DATA) > 1)


def shard_state(state, mesh, *, fsdp: bool = False,
                ddp: Optional[bool] = None,
                tensor_parallel: Optional[bool] = None):
    """A :class:`~..train.state.TrainState` whose model is
    :func:`shard_params`'s and whose optimizer is the same spec bound to
    the sharded parameters (so shard before the first update; restore a
    checkpoint after, through the layout)."""
    from focused_attention_vit_tpu_torch.train.state import TrainState

    if state.tx.count:
        raise ValueError("shard_state takes a state before its first update")
    wrapped = shard_params(state.model, mesh, fsdp=fsdp, ddp=ddp,
                           tensor_parallel=tensor_parallel)
    layout = wrapped.favit_layout
    tx = state.tx.spec.bind(layout.module)
    tx.grad_norm_sq = layout.grad_norm_sq
    return TrainState(model=wrapped, tx=tx, step=state.step, layout=layout)


def state_shardings(state, mesh=None, *, fsdp: bool = False
                    ) -> Dict[str, Tuple]:
    """The placements of a sharded state's parameters (AdamW's moments
    mirror them), as :func:`param_sharding_rules` gives them; the state's
    layout says what ``mesh`` and ``fsdp`` say in JAX."""
    layout = state.layout
    return _placements(layout.params.items(),
                       {n: r[0][2] for n, r in layout.sliced.items()},
                       layout.fsdp and layout.dp > 1)


def make_sharded_train_step(model, tx, mesh, img_size: int, *,
                            augment: bool = True,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> Callable:
    """``train_step(params, opt_state, images_u8, labels, key) -> (params,
    opt_state, {"loss": loss})``, JAX's signature: ``params`` is the
    module :func:`shard_params` returned (PyTorch keeps the parameters in
    it), ``opt_state`` the optimizer bound to its parameters
    (``tx.bind(params.favit_layout.module)``); ``model`` and ``tx`` name
    what they were made from. ``images_u8`` and ``labels`` are the global
    batch; ``loss`` is its mean cross-entropy, the same on every rank."""
    from focused_attention_vit_tpu_torch.train.state import TrainState
    from focused_attention_vit_tpu_torch.train.steps import make_train_step

    step = make_train_step(img_size, augment=augment,
                           compute_dtype=compute_dtype, mesh=mesh)

    def train_step(params, opt_state, images_u8, labels, key: int):
        state = TrainState(params, opt_state,
                           layout=getattr(params, "favit_layout", None))
        _, m = step(state, images_u8, labels, key)
        return params, opt_state, {"loss": m["loss_sum"] / m["count"]}

    return train_step
