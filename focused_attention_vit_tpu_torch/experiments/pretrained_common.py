"""Shared machinery of the pretrained fine-tune experiments (port of
``focused_attention_vit_tpu/experiments/pretrained_common.py``):

  checkpoint (``data/pretrained.py``) -> variant surgery
  (``convert/checkpoints.py``) -> shape-checked merge into the freshly
  initialised model's state dict.

The merge copies every checkpoint tensor whose key and shape match the
model's and keeps the random init otherwise (logged), over state-dict keys
where JAX walks the param tree; the two count the same tensors, since every
Flax leaf of these models is one torch parameter. Learning-rate groups and
freezing go through :func:`~..train.make_grouped_optimizer`; a frozen
parameter also gets ``requires_grad_(False)``, so that autograd computes
no gradient for it (XLA drops the gradients that ``optax.set_to_zero``
discards).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch

from focused_attention_vit_tpu_torch.data.pretrained import (
    load_pretrained_vit_params,
)
from focused_attention_vit_tpu_torch.train import make_grouped_optimizer

logger = logging.getLogger(__name__)


def merge_matching(model_state: Mapping[str, torch.Tensor],
                   ckpt_state: Mapping[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Copy checkpoint tensors into ``model_state`` where key and shape
    match, cast to the model tensor's dtype and device. A checkpoint key
    absent from the model is ignored; a model key absent from the
    checkpoint keeps its init and counts as neither copied nor skipped.
    Returns (merged, n_copied, n_skipped)."""
    merged, copied, skipped = {}, 0, 0
    for key, init in model_state.items():
        ck = ckpt_state.get(key)
        if ck is None:
            merged[key] = init
        elif tuple(ck.shape) == tuple(init.shape):
            merged[key] = ck.to(dtype=init.dtype, device=init.device)
            copied += 1
        else:
            logger.info(
                "pretrained merge: shape mismatch at %s (ckpt %s vs model "
                "%s) — keeping random init", key, tuple(ck.shape),
                tuple(init.shape))
            merged[key] = init
            skipped += 1
    return merged, copied, skipped


@dataclass
class PretrainedMixin:
    """Extra config fields shared by the pretrained experiments
    (reference constructor kwargs, e.g.
    experiments/mhla_pretrained.py:33-68)."""

    pretrained_model_variant: str = "vit_b_16"
    pretrained_source: str = "torchvision"
    pretrained_cache_dir: str = "./pretrained_weights"
    # bool: freeze the whole pretrained body; list[str]: freeze parameters
    # whose name contains any listed substring (reference semantics:
    # utils/data_utils.py:529-539).
    freeze_layers: Any = False
    head_learning_rate: float = 1e-3
    strict_pretrained: bool = False

    def _is_frozen_path(self, path: str, body_frozen_default: bool) -> bool:
        if isinstance(self.freeze_layers, (list, tuple)):
            return any(name in path for name in self.freeze_layers)
        return bool(self.freeze_layers) and body_frozen_default

    # Subclasses set this to transform a plain-ViT state dict into the
    # variant's keys (identity for traditional_pretrained).
    def surgery(self, vit_state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return vit_state

    # ---- ExperimentBase hooks -------------------------------------------
    def build_params(self, model: torch.nn.Module) -> None:
        ckpt, _cfg = load_pretrained_vit_params(
            variant=self.pretrained_model_variant,
            source=self.pretrained_source,
            cache_dir=self.pretrained_cache_dir,
            num_classes=self.num_classes,
            strict=self.strict_pretrained,
        )
        self.pretrained_loaded = ckpt is not None
        self.merge_counts = {"copied": 0, "skipped": 0}
        if ckpt is not None:
            merged, copied, skipped = merge_matching(
                model.state_dict(), self.surgery(ckpt))
            model.load_state_dict(merged, strict=True)
            self.merge_counts = {"copied": copied, "skipped": skipped}
            logger.info(
                "pretrained merge: %d tensors copied, %d kept at random "
                "init", copied, skipped)
        for name, p in model.named_parameters():
            p.requires_grad_(self.label_fn(name) != "frozen")
        self._record_param_counts(model)

    def _record_param_counts(self, model: torch.nn.Module) -> None:
        total = trainable = 0
        for name, p in model.named_parameters():
            total += p.numel()
            if self.label_fn(name) != "frozen":
                trainable += p.numel()
        self.param_counts = {
            "total_params": total,
            "trainable_params": trainable,
            "frozen_params": total - trainable,
        }
        print(
            f"Model setup complete. Total parameters: {total:,}, "
            f"Trainable: {trainable:,}"
        )

    # ---- optimizer groups ------------------------------------------------
    def label_fn(self, path: str) -> str:
        """Default two-group policy (traditional_pretrained, reference:
        experiments/traditional_pretrained.py:196-209): head at
        head_learning_rate, body at learning_rate; with freeze_layers=True
        the body is frozen; with a list, matching parameter names are
        frozen. ``path`` is a ``named_parameters()`` name."""
        if path.startswith("head"):
            return "head"
        return "frozen" if self._is_frozen_path(path, True) else "body"

    def group_lrs(self) -> Dict[str, float]:
        return {"body": self.learning_rate, "head": self.head_learning_rate}

    def build_optimizer(self):
        # Each group's base LR rides the same schedule shape (lr_for is
        # identity under the reference's constant-LR protocol).
        group_lrs = {k: self.lr_for(v) for k, v in self.group_lrs().items()}
        return make_grouped_optimizer(
            self.label_fn,
            group_lrs,
            weight_decay=self.weight_decay,
            grad_clip_norm=self.grad_clip_norm,
            mu_dtype=self._mu_dtype(),
        )
