"""Weights between the JAX package and the PyTorch port: ``from_jax`` one way,
the JAX package's own ``reference_vit_mhla_to_flax`` the other, and the
``.npz`` / ``.pt`` loaders of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu.convert.torch_to_jax import (
    reference_vit_mhla_to_flax,
)
from focused_attention_vit_tpu.models import (
    VisionTransformerMHLA as JaxVisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flatten_params,
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
    unflatten_params,
)
from focused_attention_vit_tpu_torch.infer import Predictor, load_state_dict
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA

torch.set_num_threads(2)

GEOM = dict(img_size=16, patch_size=4, num_classes=10, embed_dim=32,
            depth=2, num_heads=2, window_size=7)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxVisionTransformerMHLA(use_mhla=True, **GEOM)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return jax.tree.map(np.asarray, params["params"])


def _assert_trees_equal(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_from_jax_fills_the_port_state_dict(jax_params):
    sd = flax_vit_mhla_to_state_dict(jax_params)
    model = VisionTransformerMHLA(**GEOM)
    own = model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        assert v.shape == own[k].shape and v.dtype == torch.float32, k
    model.load_state_dict(sd)


def test_round_trip_through_the_reference_converter(jax_params):
    """JAX -> port state dict -> the JAX package's converter -> the same JAX
    params, bit for bit."""
    sd = flax_vit_mhla_to_state_dict(jax_params)
    back = reference_vit_mhla_to_flax(sd, depth=2, use_mhla=True,
                                      num_heads=2)
    _assert_trees_equal(back, jax_params)


def test_port_state_dict_through_reference_converter_and_back():
    model = VisionTransformerMHLA(**GEOM,
                                  generator=torch.Generator().manual_seed(5))
    sd = model.state_dict()
    flax = reference_vit_mhla_to_flax(sd, depth=2, use_mhla=True, num_heads=2)
    again = flax_vit_mhla_to_state_dict(flax)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k


def test_flatten_unflatten(jax_params):
    flat = flatten_params(jax_params)
    assert "blocks_1/attn/qkv/kernel" in flat
    _assert_trees_equal(unflatten_params(flat), jax_params)


@pytest.mark.parametrize("suffix", [".npz", ".pt", ".pth"])
def test_weight_files_load_into_a_predictor(jax_params, tmp_path, suffix):
    sd = flax_vit_mhla_to_state_dict(jax_params)
    path = tmp_path / f"w{suffix}"
    if suffix == ".npz":
        np.savez(path, **flatten_params(jax_params))
    else:
        torch.save(sd, path)
    loaded = load_state_dict(path)
    assert sorted(loaded) == sorted(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    pred = Predictor.from_weights(
        VisionTransformerMHLA(**GEOM), path, img_size=16, device="cpu",
        batch_size=4, compute_dtype=torch.float32)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3),
                                             dtype=np.uint8)
    ref = VisionTransformerMHLA(**GEOM)
    ref.load_state_dict(sd)
    from focused_attention_vit_tpu_torch.data.pipeline import (
        prepare_eval_batch,
    )

    with torch.inference_mode():
        want = torch.softmax(
            ref(prepare_eval_batch(torch.from_numpy(imgs), 16)), -1).numpy()
    np.testing.assert_allclose(pred.predict_proba(imgs), want, atol=1e-6)


@pytest.mark.parametrize("case", ["scan_form", "dense_blocks", "holes",
                                  "suffix"])
def test_rejects(jax_params, tmp_path, case):
    params = dict(jax_params)
    if case == "scan_form":
        params["blocks"] = {"block": {}}
    elif case == "dense_blocks":
        # Dense blocks convert now; what is rejected is MHLA params handed
        # to the dense ViT's converter.
        with pytest.raises(ValueError, match="latent_proj"):
            flax_vit_to_state_dict(params)
        return
    elif case == "holes":
        del params["blocks_0"]
    if case == "suffix":
        with pytest.raises(ValueError, match="weights must be"):
            load_state_dict(tmp_path / "w.msgpack")
        return
    with pytest.raises(ValueError):
        flax_vit_mhla_to_state_dict(params)
