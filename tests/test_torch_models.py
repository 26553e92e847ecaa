"""The PyTorch port's MHLA ViT against the JAX package's, on the CPU, in f32,
with the JAX weights carried across by ``convert/from_jax.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu.models import (
    VisionTransformerMHLA as JaxVisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
)
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band

torch.set_num_threads(2)

# f32 on both sides over 2 blocks; the sums run in different orders.
LOGIT_TOL = 1e-4
GEOM = dict(patch_size=4, num_classes=10, embed_dim=32, depth=2,
            num_heads=2, window_size=7)


def _pair(img_size, seed=0):
    jmodel = JaxVisionTransformerMHLA(img_size=img_size, use_mhla=True,
                                      **GEOM)
    x = np.random.default_rng(seed).normal(
        size=(2, img_size, img_size, 3)).astype(np.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    tmodel = VisionTransformerMHLA(img_size=img_size, **GEOM).eval()
    tmodel.load_state_dict(flax_vit_mhla_to_state_dict(params))
    return jmodel, params, tmodel, x


@pytest.mark.parametrize("img_size,impl", [
    (12, "auto"),   # S = 10 <= 2W: gather form
    (32, "auto"),   # S = 65: dense band
    (96, "auto"),   # S = 577: long-S branch (JAX: the shift band on CPU)
    (96, "roll"),   # S = 577: JAX's lane-roll kernel in interpret mode
])
def test_vit_mhla_logits_match_jax(img_size, impl, monkeypatch):
    monkeypatch.setenv("FAVIT_MHLA_IMPL", impl)
    jmodel, params, tmodel, x = _pair(img_size)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    before = band.launch_count()
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert band.launch_count() == before  # CPU tensors launch no kernel
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("img_size", [32, 96])
def test_mhla_layer_matches_jax(img_size):
    """One MHLA sublayer on its own, both sequence-length branches."""
    from focused_attention_vit_tpu.models.layers import (
        MultiHeadLatentAttention as JaxMHLA,
    )

    s = (img_size // 4) ** 2 + 1
    x = np.random.default_rng(s).normal(size=(2, s, 32)).astype(np.float32)
    jlayer = JaxMHLA(embed_dim=32, num_heads=2, window_size=5)
    params = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x)))

    from focused_attention_vit_tpu_torch.models.layers import (
        MultiHeadLatentAttention,
    )

    tlayer = MultiHeadLatentAttention(32, 2, window_size=5)
    sd = flax_vit_mhla_to_state_dict({
        "patch_embed": {"projection": {"kernel": np.zeros((3, 32)),
                                       "bias": np.zeros(32)}},
        "cls_token": np.zeros((1, 1, 32)), "pos_embed": np.zeros((1, 1, 32)),
        "blocks_0": {"attn": params,
                     "norm1": {"scale": np.ones(32), "bias": np.zeros(32)},
                     "norm2": {"scale": np.ones(32), "bias": np.zeros(32)},
                     "mlp": {"fc1": {"kernel": np.zeros((32, 4)),
                                     "bias": np.zeros(4)},
                             "fc2": {"kernel": np.zeros((4, 32)),
                                     "bias": np.zeros(32)}}},
        "norm": {"scale": np.ones(32), "bias": np.zeros(32)},
        "head": {"kernel": np.zeros((32, 1)), "bias": np.zeros(1)},
    })
    tlayer.load_state_dict({k[len("blocks.0.attn."):]: v for k, v in sd.items()
                            if k.startswith("blocks.0.attn.")})
    with torch.inference_mode():
        got = tlayer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_init_is_seeded_and_follows_the_reference_rule():
    a = VisionTransformerMHLA(img_size=32, **GEOM,
                              generator=torch.Generator().manual_seed(3))
    b = VisionTransformerMHLA(img_size=32, **GEOM,
                              generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    sd = a.state_dict()
    assert torch.all(sd["blocks.0.attn.qkv.bias"] == 0)
    assert torch.all(sd["norm.weight"] == 1) and torch.all(sd["norm.bias"] == 0)
    w = sd["blocks.0.mlp.fc1.weight"]
    assert abs(float(w.std()) - 0.02) < 0.002
    assert abs(float(sd["pos_embed"].std()) - 0.02) < 0.004


def test_dense_blocks_are_not_ported():
    """The name is from when they were not: ``use_mhla=False`` now builds
    dense blocks under the reference's in_proj/out_proj names and runs
    (held against JAX in test_torch_vit.py)."""
    model = VisionTransformerMHLA(img_size=32, use_mhla=False, **GEOM).eval()
    keys = set(model.state_dict())
    assert {"blocks.0.attn.in_proj_weight", "blocks.0.attn.in_proj_bias",
            "blocks.0.attn.out_proj.weight"} <= keys
    assert not any("latent_proj" in k or ".qkv." in k for k in keys)
    with torch.inference_mode():
        out = model(torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 10) and torch.isfinite(out).all()
