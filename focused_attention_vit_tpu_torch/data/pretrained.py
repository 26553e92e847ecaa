"""Pretrained ViT checkpoints: the cache reader, and the seeded fixture that
stands in for the real weights (port of
``focused_attention_vit_tpu/data/pretrained.py`` and of the draws of
``tools/make_pretrained_fixture.py``).

:func:`load_pretrained_vit_params` looks under ``cache_dir``, in JAX's
order, for

* ``<variant>_flax.msgpack`` (``<variant>_hf_flax.msgpack`` with
  ``source="huggingface"``), a converted Flax ViT param tree that the JAX
  loader writes, read by the port's own msgpack reader
  (:mod:`~..convert.flax_msgpack`) and mapped by
  :func:`~..convert.from_jax.flax_vit_to_state_dict`;
* ``<variant>_weights.pth``, a torchvision ``vit_b_16``-layout state dict
  (the reference's own cache file name), read with ``weights_only=True``,
  fp16 upcast to f32, and mapped to the port's
  :class:`~..models.VisionTransformer` keys by
  :func:`~..convert.checkpoints.torchvision_vit_to_state_dict`;
* with ``source="huggingface"``, a local ``transformers`` snapshot
  (``local_files_only=True``; a miss of the snapshot is a miss), mapped by
  :func:`~..convert.checkpoints.hf_vit_to_state_dict`.

It keeps JAX's rules: the head is dropped when its class count differs from
``num_classes``, and a miss raises under ``strict``, else warns loudly and
returns ``None`` (the caller keeps its random init).

Deviations from the JAX loader:

* The port writes no ``<variant>_flax.msgpack`` cache of the converted
  weights (it has a msgpack reader and no writer): reading the ``.pth``
  and mapping it is all the work.
* There is no live download (JAX tries ``torchvision`` with network
  access; the card's machine has neither).

The fixture: ``python -m focused_attention_vit_tpu_torch.data.pretrained
[out_dir] [--variant vit_b_16]`` writes ``<out_dir>/<variant>_weights.pth``
(default ``pretrained_weights/``) with :func:`make_fixture_state_dict`: the
same numpy draws, keys and fp16 dtype as the JAX package's tool (seed 2026),
made with torch alone.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from focused_attention_vit_tpu_torch.convert.checkpoints import (
    hf_vit_to_state_dict,
    torchvision_vit_to_state_dict,
)
from focused_attention_vit_tpu_torch.convert.flax_msgpack import read_msgpack
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_to_state_dict,
)

logger = logging.getLogger(__name__)

# torchvision variant table mirrored from the reference
# (utils/data_utils.py:275-281).
TORCHVISION_VARIANTS = {
    "vit_b_16": dict(patch_size=16, embed_dim=768, depth=12, num_heads=12),
    "vit_b_32": dict(patch_size=32, embed_dim=768, depth=12, num_heads=12),
    "vit_l_16": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16),
    "vit_l_32": dict(patch_size=32, embed_dim=1024, depth=24, num_heads=16),
    "vit_h_14": dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16),
}

FIXTURE_SEED = 2026
FIXTURE_IMG = 224
FIXTURE_CLASSES = 1000  # an ImageNet head, as a real checkpoint has


def variant_config(variant: str) -> Dict[str, int]:
    if variant not in TORCHVISION_VARIANTS:
        raise ValueError(
            f"Unknown pretrained variant {variant!r}; known: "
            f"{sorted(TORCHVISION_VARIANTS)}"
        )
    return dict(TORCHVISION_VARIANTS[variant], img_size=224)


def _load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return obj


def _apply_head_rule(state: Dict[str, torch.Tensor],
                     num_classes: Optional[int]) -> Dict[str, torch.Tensor]:
    """Drop the classifier head when its class count mismatches
    ``num_classes``: the reference's strip-head-keys behaviour
    (utils/data_utils.py:408-426). The caller random-inits the new head."""
    if (num_classes is not None and "head.weight" in state
            and state["head.weight"].shape[0] != num_classes):
        state = {k: v for k, v in state.items()
                 if k not in ("head.weight", "head.bias")}
    return state


def _hf_snapshot(variant: str):
    """A local HuggingFace ``ViTModel`` snapshot's state dict, or None when
    there is none (or no ``transformers``): only that is a miss."""
    hf_name = {
        "vit_b_16": "google/vit-base-patch16-224-in21k",
        "vit_l_16": "google/vit-large-patch16-224-in21k",
    }.get(variant, variant)
    try:
        from transformers import ViTModel

        model = ViTModel.from_pretrained(hf_name, local_files_only=True)
    except Exception as e:  # no snapshot: a miss; mapping errors propagate
        logger.info("No local HF snapshot (%s)", e)
        return None
    logger.info("Loaded local HF snapshot %s", hf_name)
    return model.state_dict()


def load_pretrained_vit_params(
    variant: str = "vit_b_16",
    source: str = "torchvision",
    cache_dir: str = "./pretrained_weights",
    num_classes: Optional[int] = None,
    strict: bool = False,
) -> Tuple[Optional[Dict[str, torch.Tensor]], Dict[str, int]]:
    """Return (f32 state dict of :class:`~..models.VisionTransformer` keys,
    or None; the variant's config). ``None`` means no checkpoint was found
    and ``strict`` was False: the caller keeps its random init (a warning
    has been logged)."""
    cfg = variant_config(variant)
    os.makedirs(cache_dir, exist_ok=True)
    hf = source == "huggingface"
    msgpack = os.path.join(
        cache_dir, f"{variant}_hf_flax.msgpack" if hf
        else f"{variant}_flax.msgpack")

    if os.path.exists(msgpack):  # first, as in JAX
        state = flax_vit_to_state_dict(read_msgpack(msgpack))
        logger.info("Loaded converted msgpack cache %s", msgpack)
        return _apply_head_rule(state, num_classes), cfg
    pth = os.path.join(cache_dir, f"{variant}_weights.pth")
    if not hf and os.path.exists(pth):
        logger.info("Loaded cached torch checkpoint %s", pth)
        state = torchvision_vit_to_state_dict(
            _load_torch_state_dict(pth), depth=cfg["depth"])
        return _apply_head_rule(state, num_classes), cfg
    if hf:
        sd = _hf_snapshot(variant)
        if sd is not None:
            state = hf_vit_to_state_dict(sd, depth=cfg["depth"])
            return _apply_head_rule(state, num_classes), cfg
    msg = (f"Pretrained weights for {variant!r} unavailable (no cache under "
           f"{cache_dir}, no download in the port)")
    if strict:
        raise FileNotFoundError(msg)
    logger.warning("%s — falling back to RANDOM INITIALIZATION.", msg)
    return None, cfg


def make_fixture_state_dict(variant: str = "vit_b_16"
                            ) -> Dict[str, torch.Tensor]:
    """A torchvision-layout state dict of ``variant`` in fp16 with init-
    scaled values: N(0, 0.02) for the patch projection, the class token and
    the positions, Xavier-normal linears, unit LayerNorms and zero biases,
    drawn from ``np.random.default_rng(2026)`` in the JAX tool's order."""
    cfg = TORCHVISION_VARIANTS[variant]
    d, depth, p = cfg["embed_dim"], cfg["depth"], cfg["patch_size"]
    n_tokens = (FIXTURE_IMG // p) ** 2 + 1
    rng = np.random.default_rng(FIXTURE_SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.float16)

    def normal(*shape, std=0.02):
        return t(rng.normal(0.0, std, size=shape).astype(np.float32))

    def linear(out_f, in_f):
        return normal(out_f, in_f, std=(2.0 / (in_f + out_f)) ** 0.5)

    def ones(n):
        return t(np.ones(n, np.float32))

    def zeros(n):
        return t(np.zeros(n, np.float32))

    sd = {
        "conv_proj.weight": normal(d, 3, p, p),
        "conv_proj.bias": zeros(d),
        "class_token": normal(1, 1, d),
        "encoder.pos_embedding": normal(1, n_tokens, d),
        "encoder.ln.weight": ones(d),
        "encoder.ln.bias": zeros(d),
        "heads.head.weight": linear(FIXTURE_CLASSES, d),
        "heads.head.bias": zeros(FIXTURE_CLASSES),
    }
    for i in range(depth):
        pre = f"encoder.layers.encoder_layer_{i}"
        sd[f"{pre}.ln_1.weight"] = ones(d)
        sd[f"{pre}.ln_1.bias"] = zeros(d)
        sd[f"{pre}.self_attention.in_proj_weight"] = linear(3 * d, d)
        sd[f"{pre}.self_attention.in_proj_bias"] = zeros(3 * d)
        sd[f"{pre}.self_attention.out_proj.weight"] = linear(d, d)
        sd[f"{pre}.self_attention.out_proj.bias"] = zeros(d)
        sd[f"{pre}.ln_2.weight"] = ones(d)
        sd[f"{pre}.ln_2.bias"] = zeros(d)
        sd[f"{pre}.mlp.linear_1.weight"] = linear(4 * d, d)
        sd[f"{pre}.mlp.linear_1.bias"] = zeros(4 * d)
        sd[f"{pre}.mlp.linear_2.weight"] = linear(d, 4 * d)
        sd[f"{pre}.mlp.linear_2.bias"] = zeros(d)
    return sd


def write_fixture(out_dir: str = "pretrained_weights",
                  variant: str = "vit_b_16") -> str:
    """Write ``<out_dir>/<variant>_weights.pth``; returns its path."""
    t0 = time.perf_counter()
    sd = make_fixture_state_dict(variant)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{variant}_weights.pth")
    torch.save(sd, out)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {out}: {len(sd)} tensors, {n / 1e6:.1f}M params, "
          f"{os.path.getsize(out) / 1e6:.0f} MB (fp16, seed {FIXTURE_SEED}) "
          f"in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m focused_attention_vit_tpu_torch.data.pretrained",
        description="Write the seeded stand-in for a torchvision ViT "
                    "checkpoint into the pretrained cache.")
    ap.add_argument("out_dir", nargs="?", default="pretrained_weights")
    ap.add_argument("--variant", default="vit_b_16",
                    choices=sorted(TORCHVISION_VARIANTS))
    args = ap.parse_args(argv)
    write_fixture(args.out_dir, args.variant)


if __name__ == "__main__":
    main()
