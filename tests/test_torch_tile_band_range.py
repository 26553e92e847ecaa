"""The tile band (K6/K7/K8, ``FAVIT_MHLA_IMPL=shiftband
FAVIT_USE_PALLAS_MHLA=1``) past the range of the card's staged kernels, where
its sources stream the band: windows past 129 (JAX's halo of 80 and 128 rows
at W = 131 and 257) and head dims past 256 (264, and 384: 2 heads at
D = 768). The plain versions (what the port runs on CPU tensors) against
JAX's ``mhla_kernel_v4`` in f32, and a 2-block MHLA model at D = 768 with 2
heads and W = 131 through the layer's tile branch. The JAX kernels run in
interpret mode, as the JAX package's own tests run them; inputs and weights
come from numpy or JAX seeds and go through both packages, and every JAX
reference runs once, in a module fixture."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from focused_attention_vit_tpu import models as jmodels
from focused_attention_vit_tpu.ops import mhla_kernel_v4 as jv4
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
)
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tv4
from focused_attention_vit_tpu_torch.ops import window as twin

torch.set_num_threads(2)

# f32 on both sides; sums in other orders (ROADMAP's parity rule).
OUT_TOL = 1e-4
GRAD_TOL = 1e-5
# (W, d, S): JAX's halo 80 (W = 131) and 128 (W = 257) at S just past 2W,
# and the head dims 264 and 384 (past 256) at a short and a wide window;
# B*h = 2.
TILE_CASES = [(131, 16, 265), (257, 24, 520), (7, 264, 20), (17, 384, 40),
              (131, 384, 270)]
TILE_ENV = {"FAVIT_MHLA_IMPL": "shiftband", "FAVIT_USE_PALLAS_MHLA": "1"}
# The 2-block model: ViT-B's width with 2 heads (d = 384), W = 131 on
# 68^2 images in 4x4 patches (S = 290 > 2W, the tile branch's condition).
HEADS, DEPTH, PATCH, DIM = 2, 2, 4, 768
MODEL_IMG, MODEL_W = 68, 131
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
    one jitted pass in interpret mode; the parameters initialised with the
    Pallas switch off, on XLA's path."""
    with mock.patch.dict(os.environ, {"FAVIT_USE_PALLAS_MHLA": "0"}):
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
    for w, d, s in TILE_CASES:
        arrays = _arrays(w + d + s, (1, 2, s, d))
        out[("v4", w, d)] = (arrays, *_jax_vjp(
            lambda q, k, v, w=w: jv4.banded_attention_v4(q, k, v, w), arrays))
        with pltpu.force_tpu_interpret_mode():
            out[("v4b", w, d)] = np.asarray(jax.jit(
                jv4.banded_attention_v4b, static_argnums=3)(
                    *map(jnp.asarray, arrays[:3]), w))
    # The model on the tile branch: JAX told it runs on a TPU.
    x = np.random.default_rng(DIM).normal(
        size=(2, MODEL_IMG, MODEL_IMG, 3)).astype(np.float32)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"), \
            mock.patch.dict(os.environ, TILE_ENV):
        jmhla = jmodels.VisionTransformerMHLA(
            img_size=MODEL_IMG, patch_size=PATCH, num_classes=10,
            embed_dim=DIM, depth=DEPTH, num_heads=HEADS, use_mhla=True,
            window_size=MODEL_W)
        out["mhla"] = (x, *_jax_model(jmhla, x))
    return out


def _close(got, want, tol, what=""):
    """Within ``tol`` absolute and relative, tests/test_torch_tile_band.py's
    rule: a gradient entry sums up to 2W terms in another order."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _rows(x):
    b, h, s, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(x)).reshape(b * h, s, d)


@pytest.mark.parametrize("w,d,s", TILE_CASES)
def test_plain_tile_band_matches_jax_v4_past_the_staged_range(refs, w, d, s):
    """K6's plain version against JAX's ``banded_attention_v4``, K7's
    (``tile_band_backward`` on CPU tensors: the in-range positions, then
    ``_edge_fold``) against its VJP, and K8's (``banded_attention_v4b``)
    against JAX's, at halos of 80 and 128 rows and head dims 264 and 384:
    outputs within 1e-4, gradients within 1e-5; no kernel launched."""
    arrays, want, want_grads = refs[("v4", w, d)]
    rows = [_rows(a) for a in arrays]
    tv4.reset_launch_count()
    got = tv4.tile_band_forward(*rows[:3], w)
    _close(got.reshape(want.shape), want, OUT_TOL, "K6")
    for name, got_g, ref in zip("qkv", tv4.tile_band_backward(*rows, w),
                                want_grads):
        _close(got_g.reshape(ref.shape), ref, GRAD_TOL, f"K7 d{name}")
    got_b = tv4.banded_attention_v4b(*map(torch.from_numpy, arrays[:3]), w)
    _close(got_b, refs[("v4b", w, d)], OUT_TOL, "K8")
    assert [tv4.launch_count(k_) for k_ in tv4.LAUNCH_KINDS] == [0, 0, 0]


@pytest.mark.parametrize("w,halo", [(131, 80), (257, 128), (683, 352)])
def test_window_tiles_take_jax_halo_past_129(w, halo):
    """Both packages' ``_halo`` past W = 129: W // 2 rounded up to a
    multiple of 16; ``banded_attention_v4b``'s tiles are ``t + 2 halo``
    rows with ``t >= 2 halo``, and on them the plain K8 is K6's band."""
    assert tv4._halo(tv4.DEFAULT_BLOCK, w // 2) == halo
    assert jv4._halo(jv4.DEFAULT_BLOCK, w // 2) == halo
    s = 2 * w + 3
    q, k, v = (torch.from_numpy(a) for a in _arrays(w, (1, 1, s, 8), 3))
    got = tv4.banded_attention_v4b(q, k, v, w)
    want = tv4.plain_tile_band_forward(*(x.reshape(1, s, 8) for x in
                                         (q, k, v)), w)
    _close(got, want.reshape(got.shape), OUT_TOL)


def test_mhla_model_through_the_tile_band_at_two_heads(refs, monkeypatch):
    """A 2-block MHLA model at D = 768 with 2 heads (d = 384) and W = 131,
    S = 290, through the tile band on both sides (the two variables set,
    JAX told it runs on a TPU, the port's device predicate told it runs on
    the card): logits within 1e-4, every gradient within 1e-5; on CPU
    tensors no kernel runs."""
    for key, val in TILE_ENV.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)
    calls = []
    real = tv4.banded_attention_v4
    monkeypatch.setattr(tv4, "banded_attention_v4",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tv4.reset_launch_count()
    tmodel = VisionTransformerMHLA(
        img_size=MODEL_IMG, patch_size=PATCH, num_classes=10, embed_dim=DIM,
        depth=DEPTH, num_heads=HEADS, window_size=MODEL_W)
    x, params, want_logits, want_loss, want_grads = refs["mhla"]
    tmodel.load_state_dict(flax_vit_mhla_to_state_dict(params))
    tmodel.eval()
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    _close(got, want_logits, OUT_TOL, "logits")
    loss = torch.nn.functional.cross_entropy(tmodel(torch.from_numpy(x)),
                                             torch.from_numpy(Y))
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-5
    want = flax_vit_mhla_to_state_dict(want_grads)
    for name, p in tmodel.named_parameters():
        _close(p.grad, want[name], GRAD_TOL, name)
    assert calls, "the layer did not take the tile band"
    assert [tv4.launch_count(k_) for k_ in tv4.LAUNCH_KINDS] == [0, 0, 0]
