"""Train state and optimizer factories (port of
``focused_attention_vit_tpu/train/state.py``).

The JAX package builds optax transformations: ``optax.adamw``, optionally
chained after ``clip_by_global_norm``, and per-group AdamW through
``optax.multi_transform`` with frozen parameters zeroed. An optax
transformation is not bound to parameters; a torch optimizer is. So the
factories here return an :class:`OptimizerSpec`, the recipe, and
:func:`create_train_state` binds it to a model's parameters as an
:class:`Optimizer` around ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay: optax's defaults and update rule), or, for a bf16
first moment (``mu_dtype``), around :class:`MuDtypeAdamW`, which follows
optax's ``scale_by_adam(mu_dtype=...)`` step by step.

Two parts are written here rather than taken from torch, because torch's
differ from optax's:
- global-norm clipping scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon (``clip_grad_norm_`` adds 1e-6 to
  the norm and always rescales below 1);
- learning-rate schedules evaluate optax's formulas at the update count
  before the update, as ``optax.scale_by_schedule`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

# A float base LR or a schedule (update count -> lr).
LRLike = Union[float, Callable[[int], float]]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule(init, end, steps)``."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (
        1.0 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float
            ) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(init, decay_steps, alpha)``."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)
    return schedule


def _join(first: Callable[[int], float], second: Callable[[int], float],
          boundary: int) -> Callable[[int], float]:
    """``optax.join_schedules([first, second], [boundary])``."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_lr_schedule(
    base_lr: float,
    kind: str = "constant",
    total_steps: int = 0,
    warmup_steps: int = 0,
) -> LRLike:
    """Learning-rate schedule factory: ``constant`` with no warmup returns
    the bare float; ``constant`` with warmup ramps linearly from 0 first;
    ``cosine`` is optax's ``warmup_cosine_decay_schedule`` from 0 to
    ``base_lr`` and down to 0 at ``total_steps``."""
    if kind not in ("constant", "cosine"):
        raise ValueError(f"unknown lr schedule '{kind}'")
    warmup_steps = int(warmup_steps)
    if kind == "constant":
        if warmup_steps <= 0:
            return base_lr
        return _join(_linear(0.0, base_lr, warmup_steps),
                     lambda count: base_lr, warmup_steps)
    if total_steps <= warmup_steps:
        raise ValueError(
            f"cosine schedule needs total_steps ({total_steps}) > "
            f"warmup_steps ({warmup_steps})"
        )
    return _join(_linear(0.0, base_lr, warmup_steps),
                 _cosine(base_lr, total_steps - warmup_steps, 0.0),
                 warmup_steps)


def _lr_at(lr: LRLike, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def _check_clip(grad_clip_norm: Optional[float]) -> Optional[float]:
    if grad_clip_norm is not None and grad_clip_norm <= 0:
        raise ValueError(
            f"grad_clip_norm must be > 0 (got {grad_clip_norm}); omit the "
            "flag to disable clipping"
        )
    return grad_clip_norm


def _check_mu_dtype(mu_dtype) -> Optional[torch.dtype]:
    """None (the first moment in the parameters' dtype, as optax's default
    and ``torch.optim.AdamW``) or ``torch.bfloat16``; float32 is None, and
    the names ``"float32"`` and ``"bfloat16"`` stand for the dtypes."""
    if isinstance(mu_dtype, str):
        mu_dtype = {"float32": torch.float32,
                    "bfloat16": torch.bfloat16}.get(mu_dtype, mu_dtype)
    if mu_dtype in (None, torch.float32):
        return None
    if mu_dtype == torch.bfloat16:
        return mu_dtype
    raise ValueError(f"mu_dtype must be None, torch.float32 or "
                     f"torch.bfloat16, got {mu_dtype!r}")


class MuDtypeAdamW(torch.optim.Optimizer):
    """AdamW with its first moment stored in ``mu_dtype`` (bf16), by
    optax's ``adamw(mu_dtype=...)`` (optax 0.2.6: ``scale_by_adam``, then
    ``add_decayed_weights``, then the learning rate), for f32 parameters:

    - ``mu = (1 - b1) g + b1 * mu`` with ``b1 * mu`` taken in the stored
      dtype, as JAX promotes it: b1 rounded to bf16 (0.8984375 for 0.9),
      the product rounded to bf16, the sum in f32;
    - ``nu = (1 - b2) g^2 + b2 nu`` in f32, stored f32;
    - the update ``mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps)`` from
      that f32 mu; then mu is stored cast to ``mu_dtype``;
    - decoupled weight decay ``+ wd * p``, times ``-lr``, added to p.

    The state per parameter is ``exp_avg`` (``mu_dtype``), ``exp_avg_sq``
    (f32) and ``step``, under ``torch.optim.AdamW``'s names, so a
    checkpoint holds it as it holds AdamW's; :meth:`load_state_dict` keeps
    ``exp_avg`` in ``mu_dtype`` (torch's loader would cast it to the
    parameter's dtype)."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p,
                                                        dtype=torch.float32)
            states = [self.state[p] for p in params]
            steps = [st["step"] for st in states]
            torch._foreach_add_(steps, 1.0)
            grads = [p.grad.float() for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            # b1 * mu in the stored dtype: b1 rounded to it, the product
            # rounded to it (an f32 product, then the cast).
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(mus, b1_mu))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            # One update count per group (every parameter steps together).
            t = torch.tensor(float(steps[0]), dtype=torch.float32)
            bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
            update = torch._foreach_div(mu, bc1)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, torch._foreach_mul(params, wd))
            torch._foreach_mul_(update, -lr)
            torch._foreach_add_(params, update)
            torch._foreach_copy_(mus, mu)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)


def _local(t: torch.Tensor) -> torch.Tensor:
    """An FSDP2 shard's local tensor; any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def clip_by_global_norm_(grads, max_norm: float,
                         norm_sq: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    norm is at least ``max_norm`` (``optax.clip_by_global_norm``: no
    epsilon, no change below the bound). ``norm_sq``, the squared norm,
    replaces the sum over ``grads`` (a sharded model's, summed over its
    ranks). Returns the norm, on the device: nothing here waits for the
    card."""
    grads = list(grads)
    if norm_sq is None:
        norm_sq = sum(g.float().pow(2).sum() for g in grads)
    norm = torch.sqrt(norm_sq)
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype)
                            * max_norm))
    return norm


@dataclass(frozen=True)
class OptimizerSpec:
    """AdamW over parameter groups, not yet bound to a model.

    ``label_fn`` maps a parameter's ``named_parameters()`` name (e.g.
    ``"blocks.3.attn.latent_proj.weight"``; JAX's label_fn sees the Flax
    path) to a group label; ``group_lrs`` gives each trained label its
    learning rate (float or schedule). Parameters whose label has no
    learning rate are frozen: no update, no weight decay, and no part in
    the clipping norm."""

    group_lrs: Mapping[str, LRLike]
    label_fn: Callable[[str], str] = field(default=lambda name: "all")
    weight_decay: float = 0.05
    grad_clip_norm: Optional[float] = None
    mu_dtype: Optional[torch.dtype] = None  # bf16: MuDtypeAdamW

    def bind(self, model: nn.Module) -> "Optimizer":
        return Optimizer(self, model)


class Optimizer:
    """An :class:`OptimizerSpec` bound to a model: ``step()`` clips the
    trained parameters' gradients, sets each group's learning rate for the
    current update count and runs ``torch.optim.AdamW``, or
    :class:`MuDtypeAdamW` under a bf16 ``mu_dtype`` (the attribute is
    ``adamw`` either way)."""

    def __init__(self, spec: OptimizerSpec, model: nn.Module):
        self.spec = spec
        self.count = 0
        groups: Dict[str, list] = {label: [] for label in spec.group_lrs}
        for name, p in model.named_parameters():
            label = spec.label_fn(name)
            if label in groups:
                groups[label].append(p)
        self.params = [p for ps in groups.values() for p in ps]
        # Under a mesh (parallel.shard_state): the squared global norm of
        # this rank's gradient pieces, for the clip.
        self.grad_norm_sq: Optional[Callable] = None
        param_groups = [{"params": ps, "label": label, "lr": 0.0}
                        for label, ps in groups.items() if ps]
        if spec.mu_dtype is None:
            self.adamw = torch.optim.AdamW(
                param_groups, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=spec.weight_decay)
        else:
            self.adamw = MuDtypeAdamW(
                param_groups, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=spec.weight_decay, mu_dtype=spec.mu_dtype)

    def step(self) -> None:
        if self.spec.grad_clip_norm is not None:
            norm_sq = (None if self.grad_norm_sq is None
                       else self.grad_norm_sq(self.params))
            clip_by_global_norm_(
                (_local(p.grad) for p in self.params if p.grad is not None),
                self.spec.grad_clip_norm, norm_sq)
        for group in self.adamw.param_groups:
            group["lr"] = _lr_at(self.spec.group_lrs[group["label"]],
                                 self.count)
        self.adamw.step()
        self.count += 1


def make_adamw(
    learning_rate: LRLike,
    weight_decay: float = 0.05,
    grad_clip_norm: Optional[float] = None,
    mu_dtype=None,
) -> OptimizerSpec:
    """AdamW over every parameter, E1's optimizer (reference protocol:
    experiments/traditional.py:152-157), optionally after global-norm
    clipping; the pretrained experiments E3 and E5 take
    :func:`make_grouped_optimizer`. ``mu_dtype=torch.bfloat16`` keeps the
    first moment in bf16 (:class:`MuDtypeAdamW`, optax's rule)."""
    return OptimizerSpec({"all": learning_rate}, weight_decay=weight_decay,
                         grad_clip_norm=_check_clip(grad_clip_norm),
                         mu_dtype=_check_mu_dtype(mu_dtype))


def make_grouped_optimizer(
    label_fn: Callable[[str], str],
    group_lrs: Dict[str, LRLike],
    weight_decay: float = 0.05,
    frozen_label: str = "frozen",
    grad_clip_norm: Optional[float] = None,
    mu_dtype=None,
) -> OptimizerSpec:
    """Per-group AdamW, as JAX's ``optax.multi_transform``: labels without
    a learning rate, and ``frozen_label``, are frozen. The clip runs after
    the frozen parameters are zeroed, so its norm spans only the trained
    groups. Unlike JAX it takes no params tree: labels are read when the
    spec is bound to a model. ``mu_dtype`` applies to every group, as in
    JAX."""
    lrs = {k: v for k, v in group_lrs.items() if k != frozen_label}
    return OptimizerSpec(lrs, label_fn, weight_decay,
                         _check_clip(grad_clip_norm),
                         _check_mu_dtype(mu_dtype))


@dataclass
class TrainState:
    """The model (its parameters), the bound optimizer and the step; under
    a device mesh, ``layout`` (:class:`~..parallel.sharding.Layout`) says
    how the model is spread, and ``model`` is the module to call (a DDP
    wrapper, or the model itself)."""

    model: nn.Module
    tx: Optimizer
    step: int = 0
    layout: Any = None


def create_train_state(model: nn.Module, tx: OptimizerSpec,
                       device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (in place) and bind ``tx`` to its
    parameters. Training runs on the card unless the caller asks for
    ``device="cpu"``; without CUDA the default raises, it does not fall
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "create_train_state: CUDA is not available; pass device=\"cpu\" "
            "to train on the CPU"
        )
    model.to(device)
    return TrainState(model=model, tx=tx.bind(model))
