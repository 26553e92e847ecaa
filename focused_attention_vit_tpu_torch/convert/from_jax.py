"""JAX (Flax) ViT params -> the port's state dicts: the reverse of
``focused_attention_vit_tpu/convert/torch_to_jax``'s
``reference_vit_to_flax`` (dense :class:`~..models.VisionTransformer`),
``reference_vit_mhla_to_flax`` (:class:`~..models.VisionTransformerMHLA`,
MHLA or dense blocks) and ``reference_mhla_vit_to_flax``
(:class:`~..models.PretrainedViTWithMHLA`, whose MLP is ``mlp.0`` and
``mlp.3``). The same three maps take the SPPP models' params, which have
no ``pos_embed``: :class:`~..models.SPPPViT`'s (the dense ViT's blocks),
:class:`~..models.SPPPViTMHLA`'s (the MHLA ViT's switchable blocks) and
:class:`~..models.PretrainedSPPPViTWithMHLA`'s (``PretrainedViTWithMHLA``'s
blocks). :func:`flax_cross_to_state_dict` is the reverse of
``reference_cross_vit_to_flax`` (:class:`~..models.CrossAttentionViT` and
:class:`~..models.CrossAttentionSPPPViT`).

Flax kernels are ``[in, out]`` and torch Linear weights ``[out, in]``; the
head-shaped attention kernels flatten back into the reference's fused
layouts: qkv ``[D, 3, h, d]`` -> ``[3D, D]`` (row ``t*D + head*d + i``) and
the output projection ``[h, d, D]`` -> ``[D, D]``. A dense block of the
MHLA model keeps them as ``attn.in_proj_weight``, ``attn.in_proj_bias``
and ``attn.out_proj``; every other block as ``attn.qkv`` and ``attn.proj``.

Params travel as ``.npz`` files whose keys are the Flax paths joined by
``/`` (``blocks_0/attn/qkv/kernel``); :func:`flatten_params` writes that form
from a nested dict of arrays. The block stack is read in the loop form
(``blocks_{i}``) or in the scan form of ``--scan_layers`` and ``--pp`` runs
(``blocks/block`` with a leading depth axis), which
:func:`unstack_block_params` turns into the loop form first.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested params -> ``{"a/b/c": array}``."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(flatten_params(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


def unflatten_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": array}`` -> nested params."""
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(val)
    return tree


def unstack_block_params(params: Mapping[str, Any], depth: int | None = None,
                         prefix: str = "blocks_",
                         scan_name: str = "blocks") -> Dict[str, Any]:
    """Scan-form params (``{scan_name}/block``, every leaf with a leading
    depth axis) -> the loop form (``{prefix}0 .. {prefix}{depth-1}``), as
    JAX's ``unstack_block_params``; ``depth`` defaults to the leading axis.
    Other entries pass through."""
    out = {k: v for k, v in params.items() if k != scan_name}
    stacked = params[scan_name]["block"]

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, Mapping) else (v,)

    if depth is None:
        depth = int(next(iter(leaves(stacked))).shape[0])

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, Mapping) else v[i]
                for k, v in tree.items()}

    for i in range(depth):
        out[f"{prefix}{i}"] = take(stacked, i)
    return out


def _loop_form(params: Mapping[str, Any]) -> Mapping[str, Any]:
    """``params`` with a scan-form block stack unstacked; a tree with both
    forms is refused."""
    if "blocks" not in params:
        return params
    if any(re.fullmatch(r"blocks_\d+", k) for k in params):
        raise ValueError(
            "params hold both a scan-form stack (blocks/block) and loop-form "
            "blocks_{i}")
    return unstack_block_params(params)


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a bf16 leaf of the msgpack reader
        return x.detach().float().clone()
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


def _linear(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    kernel = np.asarray(p["kernel"])
    sd[f"{prefix}.weight"] = _t(kernel.T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd: Dict[str, torch.Tensor], prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _blocks_to_state_dict(params: Mapping[str, Any], in_proj_names: bool,
                          mlp_names=("fc1", "fc2")
                          ) -> Dict[str, torch.Tensor]:
    """The model's state dict; a block without ``latent_proj`` is a dense
    block, saved under the ``in_proj``/``out_proj`` names if
    ``in_proj_names``. The MLP's two Linears are saved as ``mlp.<name>``
    for the two ``mlp_names``."""
    params = _loop_form(params)
    sd = _stem(params)
    for i in range(_depth(params)):
        blk = params[f"blocks_{i}"]
        pre = f"blocks.{i}"
        attn = blk["attn"]
        qkv_k = np.asarray(attn["qkv"]["kernel"])  # [D, 3, h, d]
        qkv_w = _t(qkv_k.reshape(qkv_k.shape[0], -1).T)
        qkv_b = _t(np.asarray(attn["qkv"]["bias"]).reshape(-1))
        proj_k = np.asarray(attn["proj"]["kernel"])  # [h, d, D]
        proj_w = _t(proj_k.reshape(-1, proj_k.shape[-1]).T)
        if in_proj_names and "latent_proj" not in attn:
            sd[f"{pre}.attn.in_proj_weight"] = qkv_w
            sd[f"{pre}.attn.in_proj_bias"] = qkv_b
            sd[f"{pre}.attn.out_proj.weight"] = proj_w
            sd[f"{pre}.attn.out_proj.bias"] = _t(attn["proj"]["bias"])
        else:
            sd[f"{pre}.attn.qkv.weight"] = qkv_w
            sd[f"{pre}.attn.qkv.bias"] = qkv_b
            if "latent_proj" in attn:
                _linear(sd, f"{pre}.attn.latent_proj", attn["latent_proj"])
            sd[f"{pre}.attn.proj.weight"] = proj_w
            sd[f"{pre}.attn.proj.bias"] = _t(attn["proj"]["bias"])
        _layernorm(sd, f"{pre}.norm1", blk["norm1"])
        _layernorm(sd, f"{pre}.norm2", blk["norm2"])
        for name, flax_name in zip(mlp_names, ("fc1", "fc2")):
            _linear(sd, f"{pre}.mlp.{name}", blk["mlp"][flax_name])
    return _tail(sd, params)


def _depth(params: Mapping[str, Any]) -> int:
    depth = sum(1 for k in params if re.fullmatch(r"blocks_\d+", k))
    if sorted(k for k in params if k.startswith("blocks_")) != sorted(
        f"blocks_{i}" for i in range(depth)
    ):
        raise ValueError("block stack must be blocks_0 .. blocks_{depth-1}")
    return depth


def _stem(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "patch_embed.projection.1", params["patch_embed"]["projection"])
    sd["cls_token"] = _t(params["cls_token"])
    if "pos_embed" in params:  # the SPPP models have none
        sd["pos_embed"] = _t(params["pos_embed"])
    return sd


def _tail(sd: Dict[str, torch.Tensor], params: Mapping[str, Any]
          ) -> Dict[str, torch.Tensor]:
    """The final LayerNorm and the head (absent from a pretrained cache
    whose head was dropped)."""
    _layernorm(sd, "norm", params["norm"])
    if "head" in params:
        _linear(sd, "head", params["head"])
    return sd


def flax_vit_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` (or ``SPPPViT``) params (loop form) -> f32
    state dict of :class:`~..models.VisionTransformer` (or
    :class:`~..models.SPPPViT`)."""
    params = _loop_form(params)
    for k, blk in params.items():
        if k.startswith("blocks_") and "latent_proj" in blk["attn"]:
            raise ValueError(
                f"{k} has a latent_proj: these are VisionTransformerMHLA "
                f"params, convert them with flax_vit_mhla_to_state_dict"
            )
    return _blocks_to_state_dict(params, in_proj_names=False)


def flax_vit_mhla_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``VisionTransformerMHLA`` (or ``SPPPViTMHLA``) params (loop
    form), ``use_mhla`` True or False -> f32 state dict of
    :class:`~..models.VisionTransformerMHLA` (or
    :class:`~..models.SPPPViTMHLA`) built with the same ``use_mhla``."""
    return _blocks_to_state_dict(params, in_proj_names=True)


def flax_pretrained_mhla_to_state_dict(params: Mapping[str, Any]
                                       ) -> Dict[str, torch.Tensor]:
    """Flax ``PretrainedViTWithMHLA`` (or ``PretrainedSPPPViTWithMHLA``)
    params -> f32 state dict of :class:`~..models.PretrainedViTWithMHLA`
    (or :class:`~..models.PretrainedSPPPViTWithMHLA`): the reverse of
    ``reference_mhla_vit_to_flax``, the MLP under the reference MHLA
    block's ``mlp.0``/``mlp.3``."""
    return _blocks_to_state_dict(params, in_proj_names=False,
                                 mlp_names=("0", "3"))


def flax_cross_to_state_dict(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Flax ``CrossAttentionViT`` (or ``CrossAttentionSPPPViT``) params ->
    f32 state dict of :class:`~..models.CrossAttentionViT` (or
    :class:`~..models.CrossAttentionSPPPViT`): the reverse of
    ``reference_cross_vit_to_flax`` with ``conv_patch=False``. The
    attention's four projections are plain ``[D, D]`` kernels, and the MLP
    goes under the reference block's ``mlp.0``/``mlp.3``."""
    params = _loop_form(params)
    sd = _stem(params)
    for i in range(_depth(params)):
        blk, pre = params[f"blocks_{i}"], f"blocks.{i}"
        for name in ("norm1_query", "norm1_kv", "norm2"):
            _layernorm(sd, f"{pre}.{name}", blk[name])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{pre}.attn.{name}", blk["attn"][name])
        _linear(sd, f"{pre}.mlp.0", blk["mlp"]["fc1"])
        _linear(sd, f"{pre}.mlp.3", blk["mlp"]["fc2"])
    return _tail(sd, params)


def npz_to_state_dict(path, in_proj_names: bool | None = None
                      ) -> Dict[str, torch.Tensor]:
    """Read a ``.npz`` of ``/``-joined Flax param paths and convert it.
    ``in_proj_names`` says how dense blocks are named: True as in
    :class:`~..models.VisionTransformerMHLA`, False as in
    :class:`~..models.VisionTransformer`. None picks by the keys present:
    params with a ``latent_proj`` are the MHLA model's, params without one
    the dense ViT's (the two models' dense params have the same tree)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    if in_proj_names is None:
        in_proj_names = any("/latent_proj/" in k for k in flat)
    return _blocks_to_state_dict(unflatten_params(flat), in_proj_names)


def flax_to_state_dict_for(model: torch.nn.Module,
                           params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The map that ``model``'s class takes: JAX params of the model of
    the same name -> an f32 state dict for ``model``."""
    from focused_attention_vit_tpu_torch import models

    maps = {
        models.VisionTransformer: flax_vit_to_state_dict,
        models.SPPPViT: flax_vit_to_state_dict,
        models.VisionTransformerMHLA: flax_vit_mhla_to_state_dict,
        models.SPPPViTMHLA: flax_vit_mhla_to_state_dict,
        models.PretrainedViTWithMHLA: flax_pretrained_mhla_to_state_dict,
        models.PretrainedSPPPViTWithMHLA: flax_pretrained_mhla_to_state_dict,
        models.CrossAttentionViT: flax_cross_to_state_dict,
        models.CrossAttentionSPPPViT: flax_cross_to_state_dict,
    }
    return maps[type(model)](params)


def load_flax_params_into_experiment(experiment, params: Mapping[str, Any]
                                     ) -> None:
    """Load a JAX experiment's param tree (nested numpy arrays, loop form:
    E1, E2, E4, E6 and the others the port runs) into the model of the port
    experiment of the same name after its ``setup()``, in place and on the
    model's device, so that both sides evaluate the same weights."""
    model = experiment.model
    device = next(model.parameters()).device
    state = {k: v.to(device)
             for k, v in flax_to_state_dict_for(model, params).items()}
    model.load_state_dict(state, strict=True)
