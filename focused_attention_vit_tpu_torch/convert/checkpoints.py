"""Checkpoint maps on torch state dicts (port of
``focused_attention_vit_tpu/convert/torch_to_jax.py`` :279-476, whose maps
end in Flax param trees).

Each map takes a torch state dict and gives the port's keys:

* :func:`torchvision_vit_to_state_dict`: a torchvision ``vit_b_16``-family
  checkpoint to :class:`~..models.VisionTransformer`'s keys;
* :func:`hf_vit_to_state_dict`: a HuggingFace ``ViTModel`` checkpoint, its
  separate q, k and v concatenated into the fused ``[q | k | v]`` rows;
* :func:`vit_state_to_mhla`: the E5 surgery, a ViT state dict to
  :class:`~..models.VisionTransformerMHLA`'s (``use_mhla=True``) keys, with
  an identity ``latent_proj`` in every block so that the MHLA model starts
  as a windowed copy of the pretrained attention;
* :func:`vit_state_to_sppp`: the E4 surgery (and E6's first step), a ViT
  state dict without its learned ``pos_embed``, for the SPPP models.

Every tensor comes out f32 (fp16 and f64 are upcast, as JAX's ``_np``
does). The conv patch projection ``[D, C, p, p]`` becomes the Linear
``[D, p*p*C]`` over patches flattened in (p1, p2, c) order (JAX's
``_conv_patch_to_linear``, transposed). The head is kept only when its class
count equals ``num_classes`` (or ``num_classes`` is None).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Mapping

import torch

logger = logging.getLogger(__name__)

State = Dict[str, torch.Tensor]


def _f32(t) -> torch.Tensor:
    t = torch.as_tensor(t).detach().cpu()
    return t.float() if t.is_floating_point() else t


def conv_patch_to_linear(weight) -> torch.Tensor:
    """Conv2d patch embedding ``[D, C, p, p]`` -> Linear weight
    ``[D, p*p*C]`` in (p1, p2, c) order (``ops/patch_embed.py``)."""
    w = _f32(weight)
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()


def _copy(out: State, dst: str, sd: Mapping, src: str) -> None:
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def _keep_head(out: State, sd: Mapping, src: str, num_classes) -> None:
    w = f"{src}.weight"
    if w in sd and (num_classes is None or sd[w].shape[0] == num_classes):
        _copy(out, "head", sd, src)


def torchvision_vit_to_state_dict(sd: Mapping, depth: int = 12,
                                  num_classes: int | None = None) -> State:
    """torchvision ``VisionTransformer`` state dict -> the port's
    :class:`~..models.VisionTransformer` state dict. ``in_proj_weight`` is
    already the fused ``[3D, D]`` in ``[q | k | v]`` order."""
    out: State = {
        "patch_embed.projection.1.weight": conv_patch_to_linear(
            sd["conv_proj.weight"]),
        "patch_embed.projection.1.bias": _f32(sd["conv_proj.bias"]),
        "cls_token": _f32(sd["class_token"]),
        "pos_embed": _f32(sd["encoder.pos_embedding"]),
    }
    for i in range(depth):
        p, b = f"encoder.layers.encoder_layer_{i}", f"blocks.{i}"
        _copy(out, f"{b}.norm1", sd, f"{p}.ln_1")
        out[f"{b}.attn.qkv.weight"] = _f32(
            sd[f"{p}.self_attention.in_proj_weight"])
        out[f"{b}.attn.qkv.bias"] = _f32(
            sd[f"{p}.self_attention.in_proj_bias"])
        _copy(out, f"{b}.attn.proj", sd, f"{p}.self_attention.out_proj")
        _copy(out, f"{b}.norm2", sd, f"{p}.ln_2")
        _copy(out, f"{b}.mlp.fc1", sd, f"{p}.mlp.linear_1")
        _copy(out, f"{b}.mlp.fc2", sd, f"{p}.mlp.linear_2")
    _copy(out, "norm", sd, "encoder.ln")
    _keep_head(out, sd, "heads.head", num_classes)
    return out


def hf_vit_to_state_dict(sd: Mapping, depth: int = 12,
                         num_classes: int | None = None) -> State:
    """HuggingFace ``ViTModel`` state dict -> the port's
    :class:`~..models.VisionTransformer` state dict (the reference's
    mapping, utils/data_utils.py:461-519)."""
    out: State = {
        "patch_embed.projection.1.weight": conv_patch_to_linear(
            sd["embeddings.patch_embeddings.projection.weight"]),
        "patch_embed.projection.1.bias": _f32(
            sd["embeddings.patch_embeddings.projection.bias"]),
        "cls_token": _f32(sd["embeddings.cls_token"]),
        "pos_embed": _f32(sd["embeddings.position_embeddings"]),
    }
    for i in range(depth):
        p, b = f"encoder.layer.{i}", f"blocks.{i}"
        a = f"{p}.attention.attention"
        _copy(out, f"{b}.norm1", sd, f"{p}.layernorm_before")
        for kind in ("weight", "bias"):
            out[f"{b}.attn.qkv.{kind}"] = torch.cat(
                [_f32(sd[f"{a}.{t}.{kind}"])
                 for t in ("query", "key", "value")])
        _copy(out, f"{b}.attn.proj", sd, f"{p}.attention.output.dense")
        _copy(out, f"{b}.norm2", sd, f"{p}.layernorm_after")
        _copy(out, f"{b}.mlp.fc1", sd, f"{p}.intermediate.dense")
        _copy(out, f"{b}.mlp.fc2", sd, f"{p}.output.dense")
    _copy(out, "norm", sd, "layernorm")
    _keep_head(out, sd, "classifier", num_classes)
    return out


def _block_indices(state: Mapping) -> list:
    return sorted({int(m.group(1)) for k in state
                   if (m := re.match(r"blocks\.(\d+)\.", k))})


def reference_vit_to_state_dict(sd: Mapping, depth: int = 12) -> State:
    """The reference repo's ``VisionTransformer`` state dict, whose keys are
    already the port's: f32, blocks from ``depth`` on left out (JAX's
    ``reference_vit_to_flax`` reads blocks 0 .. depth-1)."""
    return {k: _f32(v) for k, v in sd.items()
            if not ((m := re.match(r"blocks\.(\d+)\.", k))
                    and int(m.group(1)) >= depth)}


def _check_depth(state: Mapping, depth: int) -> None:
    """JAX's ``_check_depth``: a checkpoint deeper than the model is merged
    by its prefix and a shallower one leaves the tail at random init (both
    logged); a block stack with holes is corruption and raises."""
    have = _block_indices(state)
    if have != list(range(len(have))):
        raise ValueError(f"checkpoint block stack has holes: {have}")
    if have and len(have) != depth:
        logger.info(
            "surgery: checkpoint has %d blocks, target model depth %d — "
            "the merge copies the matching prefix", len(have), depth)


def vit_state_to_mhla(state: Mapping, depth: int, head_dim: int,
                      keep_pos_embed: bool = True) -> State:
    """ViT state dict -> MHLA state dict: every block of the checkpoint
    gains ``attn.latent_proj`` = identity ``[d, d]`` and zero bias (JAX's
    ``vit_params_to_mhla``; reference experiments/mhla_pretrained.py:
    224-225)."""
    _check_depth(state, depth)
    out: State = {k: v for k, v in state.items()
                  if keep_pos_embed or k != "pos_embed"}
    for i in _block_indices(state):
        out[f"blocks.{i}.attn.latent_proj.weight"] = torch.eye(head_dim)
        out[f"blocks.{i}.attn.latent_proj.bias"] = torch.zeros(head_dim)
    return out


def vit_state_to_sppp(state: Mapping) -> State:
    """ViT state dict -> SPPP state dict: everything but the learned
    ``pos_embed``, which the SPPP models replace by the centroid encoding
    (JAX's ``vit_params_to_sppp``; reference experiments/sppp_pretrained.py:
    177-232)."""
    return {k: v for k, v in state.items() if k != "pos_embed"}
