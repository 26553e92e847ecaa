"""The opt-in kernels' plain versions at the shapes the JAX package takes: the
fused short-S attention (K3/K4, ``FAVIT_FUSED_MHA=1``) at head dims that are
multiples of 8 but not powers of two, and the tile band (K6/K7/K8,
``FAVIT_MHLA_IMPL=shiftband FAVIT_USE_PALLAS_MHLA=1``) at windows past 33
(JAX's halo of 32 and 64 rows) and at padded head dims, against the JAX
package on the CPU in f32, and a 2-block model through each switch. The JAX
kernels run in interpret mode, as the JAX package's own tests run them;
inputs and weights come from a numpy or JAX seed and go through both
packages, and every JAX reference runs once, in a module fixture."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from focused_attention_vit_tpu import models as jmodels
from focused_attention_vit_tpu.ops import mha_kernel as jmha
from focused_attention_vit_tpu.ops import mhla_kernel_v4 as jv4
from focused_attention_vit_tpu.ops import window as jwin
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
)
from focused_attention_vit_tpu_torch.models import (
    VisionTransformer,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.ops import mha_kernel as fused
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tv4
from focused_attention_vit_tpu_torch.ops import window as twin

torch.set_num_threads(2)

# f32 on both sides; sums in other orders (ROADMAP's parity rule).
OUT_TOL = 1e-4
GRAD_TOL = 1e-5
# (d, S): the fused op's padded tile widths (8 and 24 run at 16 and 32 on
# the card) and ViT-H/14's 80, at a length the whole-row kernel takes and
# at ViT-H/14's 224^2 length, which takes the tiled kernels.
FUSED_CASES = [(d, s) for d in (8, 24, 80) for s in (65, 257)]
# (W, d, S): JAX's halo 32 (W = 35, 65), 64 (W = 129) and 16 (W = 17) at
# padded and odd-sized head dims, and an even W (64) whose interior keeps
# W + 1 keys; S > 2W, where the layer takes the tile band.
TILE_CASES = [(17, 24, 40), (35, 16, 80), (65, 80, 140), (129, 24, 300),
              (64, 16, 140)]
TILE_ENV = {"FAVIT_MHLA_IMPL": "shiftband", "FAVIT_USE_PALLAS_MHLA": "1"}
# (W, d, S) of the composite (the tile band with the exact edge rows): an
# even W, whose interior keeps W + 1 keys, and W = 129, whose edge slab is
# 2W + 2 = 260 keys.
COMPOSITE_CASES = [(64, 16, 140), (129, 24, 300)]
# The 2-block models: a dense ViT at d = 80 through the fused op (S = 65)
# and an MHLA model at (W, d) = (65, 80) through the tile band (S = 145).
HEADS, DEPTH, PATCH = 2, 2, 4
DENSE_IMG, MHLA_IMG, MHLA_W, MODEL_D = 32, 48, 65, 80
Y = np.array([3, 7])


def _arrays(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _jax_vjp(fn, arrays):
    """``fn(q, k, v)`` and its VJP on the cotangent ``arrays[3]``, jitted,
    in interpret mode."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        out, grads = run(*map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _jax_model(jmodel, x):
    """Parameters, logits, the CE loss over ``Y`` and its gradients from
    one jitted pass in interpret mode. The parameters do not depend on the
    switches: they are initialised with both off, on XLA's paths."""
    with mock.patch.dict(os.environ, {"FAVIT_FUSED_MHA": "0",
                                      "FAVIT_USE_PALLAS_MHLA": "0"}):
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(x))["params"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), Y]), logits

    with pltpu.force_tpu_interpret_mode():
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return params, np.asarray(logits), float(loss), grads


@pytest.fixture(scope="module")
def refs():
    out = {}
    for d, s in FUSED_CASES:
        arrays = _arrays(s + d, (1, 2, s, d))
        out[("fused", d, s)] = (arrays, *_jax_vjp(
            jmha.fused_multi_head_attention, arrays))
    for w, d, s in TILE_CASES:
        arrays = _arrays(w + d + s, (1, 2, s, d))
        out[("v4", w, d, s)] = (arrays, *_jax_vjp(
            lambda q, k, v, w=w: jv4.banded_attention_v4(q, k, v, w), arrays))
        with pltpu.force_tpu_interpret_mode():
            out[("v4b", w, d, s)] = np.asarray(jax.jit(
                jv4.banded_attention_v4b, static_argnums=3)(
                    *map(jnp.asarray, arrays[:3]), w))
    # The composite and the models on the switches' branches: JAX told it
    # runs on a TPU.
    rng = np.random.default_rng(MODEL_D)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"), \
            mock.patch.dict(os.environ, TILE_ENV):
        for w, d, s in COMPOSITE_CASES:
            arrays = _arrays(w * s + d, (1, 2, s, d))
            out[("composite", w)] = (arrays, *_jax_vjp(
                lambda q, k, v, w=w: jwin.windowed_latent_attention(
                    q, k, v, w), arrays))
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        geom = dict(patch_size=PATCH, num_classes=10,
                    embed_dim=HEADS * MODEL_D, depth=DEPTH, num_heads=HEADS)
        x = rng.normal(size=(2, DENSE_IMG, DENSE_IMG, 3)).astype(np.float32)
        with mock.patch.dict(os.environ, {"FAVIT_FUSED_MHA": "1"}):
            jdense = jmodels.VisionTransformer(img_size=DENSE_IMG, **geom)
            out["vit"] = (x, *_jax_model(jdense, x))
        x = rng.normal(size=(2, MHLA_IMG, MHLA_IMG, 3)).astype(np.float32)
        mhla = dict(img_size=MHLA_IMG, use_mhla=True, **geom)
        with mock.patch.dict(os.environ, TILE_ENV):
            jmhla = jmodels.VisionTransformerMHLA(window_size=MHLA_W, **mhla)
            out["mhla"] = (x, *_jax_model(jmhla, x))
    return out


def _close(got, want, tol, what=""):
    """Within ``tol`` absolute and relative, tests/test_torch_tile_band.py's
    rule: a gradient entry of 4 sums 129 terms in another order."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("d,s", FUSED_CASES)
def test_plain_fused_matches_jax_at_padded_head_dims(refs, d, s):
    """The fused op on CPU tensors (the plain K3 and K4) against JAX's fused
    kernels at rate 0: the output within 1e-4 and dq, dk, dv within 1e-5,
    through the autograd Function; no kernel launched."""
    arrays, want, want_grads = refs[("fused", d, s)]
    fused.reset_launch_count()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    out = fused.fused_multi_head_attention(q, k, v)
    out.backward(torch.from_numpy(arrays[3]))
    _close(out.detach(), want, OUT_TOL, "out")
    for name, t, ref in zip("qkv", (q, k, v), want_grads):
        _close(t.grad, ref, GRAD_TOL, f"d{name}")
    assert [fused.launch_count(k_) for k_ in fused.LAUNCH_KINDS] == [0, 0, 0]


def _rows(x):
    b, h, s, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(x)).reshape(b * h, s, d)


@pytest.mark.parametrize("w,d,s", TILE_CASES)
def test_plain_tile_band_matches_jax_v4_past_halo_16(refs, w, d, s):
    """K6's plain version against JAX's ``banded_attention_v4``, K7's
    (``tile_band_backward`` on CPU tensors: the in-range positions, then
    ``_edge_fold``) against its VJP, and K8's (``banded_attention_v4b``)
    against JAX's, at halos of 16, 32 and 64 rows: outputs within 1e-4,
    gradients within 1e-5."""
    arrays, want, want_grads = refs[("v4", w, d, s)]
    rows = [_rows(a) for a in arrays]
    tv4.reset_launch_count()
    got = tv4.tile_band_forward(*rows[:3], w)
    _close(got.reshape(want.shape), want, OUT_TOL, "K6")
    for name, got_g, ref in zip("qkv", tv4.tile_band_backward(*rows, w),
                                want_grads):
        _close(got_g.reshape(ref.shape), ref, GRAD_TOL, f"K7 d{name}")
    got_b = tv4.banded_attention_v4b(*map(torch.from_numpy, arrays[:3]), w)
    _close(got_b, refs[("v4b", w, d, s)], OUT_TOL, "K8")
    assert [tv4.launch_count(k_) for k_ in tv4.LAUNCH_KINDS] == [0, 0, 0]


def test_plain_window_tiles_take_jax_halo(refs):
    """``banded_attention_v4b`` builds its window tiles with JAX's halo: 32
    rows at W = 65 and 64 at W = 129, each tile ``t + 2 halo`` rows with
    ``t >= 2 halo``; the plain K8 on them is K6's band."""
    for w, halo in ((65, 32), (129, 64)):
        assert tv4._halo(tv4.DEFAULT_BLOCK, w // 2) == halo
        assert jv4._halo(jv4.DEFAULT_BLOCK, w // 2) == halo
    w, d, s = 129, 24, 300
    arrays = refs[("v4", w, d, s)][0]
    got = tv4.banded_attention_v4b(*map(torch.from_numpy, arrays[:3]), w)
    k6 = tv4.plain_tile_band_forward(*map(_rows, arrays[:3]), w)
    _close(got, k6.reshape(got.shape), OUT_TOL)


@pytest.mark.parametrize("w,d,s", COMPOSITE_CASES)
def test_composite_edge_rows_match_jax_at_even_and_wide_windows(refs,
                                                                 monkeypatch,
                                                                 w, d, s):
    """``windowed_latent_attention`` through the tile band (JAX's halo 64)
    with the exact edge rows from ``_edge_slab_index`` against JAX's
    composite: output within 1e-4, gradients within 1e-5. At W = 129 (odd)
    it is the gather oracle, edge rows included; at W = 64 (even) the
    interior rows keep W + 1 keys in both packages and differ from the
    oracle's W-key windows, while the edge rows equal it."""
    for key, val in TILE_ENV.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)
    arrays, want, want_grads = refs[("composite", w)]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    out = twin.windowed_latent_attention(q, k, v, w)
    out.backward(torch.from_numpy(arrays[3]))
    _close(out.detach(), want, OUT_TOL, "out")
    for name, t, ref in zip("qkv", (q, k, v), want_grads):
        _close(t.grad, ref, GRAD_TOL, f"d{name}")
    hw = w // 2
    with torch.no_grad():
        oracle = twin._gather_windowed_attention(q, k, v, w)
    diff = (out.detach() - oracle).abs()
    _close(diff[:, :, :hw], 0.0, OUT_TOL, "left edge rows")
    _close(diff[:, :, s - hw:], 0.0, OUT_TOL, "right edge rows")
    if w % 2:
        _close(diff, 0.0, OUT_TOL, "interior")
    else:
        assert float(diff[:, :, hw:s - hw].max()) > 1e-3


def _check_model(tmodel, to_sd, ref):
    x, params, want_logits, want_loss, want_grads = ref
    tmodel.load_state_dict(to_sd(params))
    tmodel.eval()
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    _close(got, want_logits, OUT_TOL, "logits")
    tmodel.zero_grad(set_to_none=True)
    loss = torch.nn.functional.cross_entropy(tmodel(torch.from_numpy(x)),
                                             torch.from_numpy(Y))
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-5
    want = to_sd(want_grads)
    for name, p in tmodel.named_parameters():
        _close(p.grad, want[name], GRAD_TOL, name)


def test_dense_vit_through_the_fused_switch_at_head_dim_80(refs,
                                                           monkeypatch):
    """A 2-block dense ViT at d = 80 (S = 65) with ``FAVIT_FUSED_MHA=1`` on
    both sides (JAX on its fused kernel, interpret mode; the port on the
    fused op's plain versions): logits within 1e-4, every gradient within
    1e-5."""
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    tmodel = VisionTransformer(
        img_size=DENSE_IMG, patch_size=PATCH, num_classes=10,
        embed_dim=HEADS * MODEL_D, depth=DEPTH, num_heads=HEADS)
    calls = []
    real = fused.fused_multi_head_attention
    monkeypatch.setattr(
        "focused_attention_vit_tpu_torch.models.layers."
        "fused_multi_head_attention",
        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _check_model(tmodel, flax_vit_to_state_dict, refs["vit"])
    assert calls, "the layer did not take the fused op"


def test_mhla_model_through_the_tile_band_at_w65_d80(refs, monkeypatch):
    """A 2-block MHLA model at (W, d) = (65, 80), S = 145, through the tile
    band on both sides (the two variables set, JAX told it runs on a TPU,
    the port's device predicate told it runs on the card): logits within
    1e-4, every gradient within 1e-5; on CPU tensors no kernel runs."""
    for key, val in TILE_ENV.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)
    calls = []
    real = tv4.banded_attention_v4
    monkeypatch.setattr(tv4, "banded_attention_v4",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tv4.reset_launch_count()
    tmodel = VisionTransformerMHLA(
        img_size=MHLA_IMG, patch_size=PATCH, num_classes=10,
        embed_dim=HEADS * MODEL_D, depth=DEPTH, num_heads=HEADS,
        window_size=MHLA_W)
    _check_model(tmodel, flax_vit_mhla_to_state_dict, refs["mhla"])
    assert calls, "the layer did not take the tile band"
    assert [tv4.launch_count(k_) for k_ in tv4.LAUNCH_KINDS] == [0, 0, 0]
