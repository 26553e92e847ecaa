"""Train state and optimizer factories (port of
``focused_attention_vit_tpu/train/state.py``).

The JAX package builds optax transformations: ``optax.adamw``, optionally
chained after ``clip_by_global_norm``, and per-group AdamW through
``optax.multi_transform`` with frozen parameters zeroed. An optax
transformation is not bound to parameters; a torch optimizer is. So the
factories here return an :class:`OptimizerSpec`, the recipe, and
:func:`create_train_state` binds it to a model's parameters as an
:class:`Optimizer` around ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay: optax's defaults and update rule).

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
from typing import Callable, Dict, Mapping, Optional, Union

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


def _check_mu_dtype(mu_dtype) -> None:
    if mu_dtype is not None:
        raise NotImplementedError(
            f"mu_dtype={mu_dtype!r}: torch.optim.AdamW keeps its first "
            "moment in the parameter dtype; a bf16 first moment is not "
            "ported yet"
        )


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    norm is at least ``max_norm`` (``optax.clip_by_global_norm``: no
    epsilon, no change below the bound). Returns the norm, on the device:
    nothing here waits for the card."""
    grads = list(grads)
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
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

    def bind(self, model: nn.Module) -> "Optimizer":
        return Optimizer(self, model)


class Optimizer:
    """An :class:`OptimizerSpec` bound to a model: ``step()`` clips the
    trained parameters' gradients, sets each group's learning rate for the
    current update count and runs ``torch.optim.AdamW``."""

    def __init__(self, spec: OptimizerSpec, model: nn.Module):
        self.spec = spec
        self.count = 0
        groups: Dict[str, list] = {label: [] for label in spec.group_lrs}
        for name, p in model.named_parameters():
            label = spec.label_fn(name)
            if label in groups:
                groups[label].append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "label": label, "lr": 0.0}
             for label, ps in groups.items() if ps],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=spec.weight_decay,
        )

    def step(self) -> None:
        if self.spec.grad_clip_norm is not None:
            clip_by_global_norm_(
                (p.grad for p in self.params if p.grad is not None),
                self.spec.grad_clip_norm,
            )
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
    :func:`make_grouped_optimizer`. ``mu_dtype`` other than None raises: a
    bf16 first moment needs an AdamW of the port's own (ROADMAP)."""
    _check_mu_dtype(mu_dtype)
    return OptimizerSpec({"all": learning_rate}, weight_decay=weight_decay,
                         grad_clip_norm=_check_clip(grad_clip_norm))


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
    spec is bound to a model."""
    _check_mu_dtype(mu_dtype)
    lrs = {k: v for k, v in group_lrs.items() if k != frozen_label}
    return OptimizerSpec(lrs, label_fn, weight_decay,
                         _check_clip(grad_clip_norm))


@dataclass
class TrainState:
    """The model (its parameters), the bound optimizer and the step."""

    model: nn.Module
    tx: Optimizer
    step: int = 0


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
