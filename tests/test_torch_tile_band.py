"""The port's MHLA tile band against the JAX package's, on the CPU, in f32:
the plain versions of K6, K7 (with the edge fold) and K8 against JAX's
Pallas kernels run in interpret mode, the composite of
``windowed_latent_attention`` (the tile band plus the exact edge rows), the
MHLA layer's dispatch on ``FAVIT_MHLA_IMPL``, and a 2-block
``VisionTransformerMHLA`` through the tile-band path. Inputs come from a
numpy seed. JAX results are computed once per case and shared."""

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from focused_attention_vit_tpu.models import (
    VisionTransformerMHLA as JaxVisionTransformerMHLA,
)
from focused_attention_vit_tpu.models.layers import (
    MultiHeadLatentAttention as JaxMHLA,
)
from focused_attention_vit_tpu.ops import mhla_kernel_v4 as jv4
from focused_attention_vit_tpu.ops import window as jwin
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
)
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
from focused_attention_vit_tpu_torch.models import layers as tlayers
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tv4
from focused_attention_vit_tpu_torch.ops import window as twin

torch.set_num_threads(2)

# f32 on both sides; sums in other orders (ROADMAP's parity rule).
TOL = 1e-5
LOGIT_TOL = 1e-4
TILE_ENV = {"FAVIT_MHLA_IMPL": "shiftband", "FAVIT_USE_PALLAS_MHLA": "1"}


def _arrays(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _rows(x):
    b, h, s, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(x)).reshape(b * h, s, d)


@functools.lru_cache(maxsize=None)
def _jax_v4(case):
    """JAX's v4 output and its VJP on the case's cotangent, interpret
    mode."""
    (b, h, s, d, w) = case
    q, k, v, g = _arrays(sum(case), (b, h, s, d))
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: jv4.banded_attention_v4(q, k, v, w),
                           q, k, v)
        return out, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        out, grads = run(*map(jnp.asarray, (q, k, v, g)))
    return (q, k, v, g), np.asarray(out), [np.asarray(x) for x in grads]


# (B, h, S, d, W): S = 40 and 197 take JAX's block rule (one tile of
# ceil(S/8)*8 rows), S = 300 two tiles of 256; W even and odd; S = 20 at
# W = 33 is shorter than a band (2 * 16 + 1 keys), where a query near one
# edge also reads clamped positions past the other.
V4_CASES = [(1, 2, 40, 16, 3), (1, 2, 197, 64, 7), (2, 1, 300, 16, 4),
            (1, 1, 197, 16, 4), (1, 2, 20, 16, 33)]


@pytest.mark.parametrize("case", V4_CASES)
def test_plain_k6_matches_jax_v4(case):
    (q, k, v, _), want, _ = _jax_v4(case)
    got = tv4.plain_tile_band_forward(_rows(q), _rows(k), _rows(v), case[4])
    _close(got.reshape(want.shape), want)


@pytest.mark.parametrize("case", V4_CASES)
def test_plain_k7_with_edge_fold_matches_jax_grad(case):
    """K7's plain version and the edge fold give JAX's ``_bwd_rule``
    gradients, and so does ``tile_band_backward`` on CPU tensors, which
    returns them folded."""
    (q, k, v, g), _, want = _jax_v4(case)
    w = case[4]
    rows = [_rows(x) for x in (q, k, v, g)]
    dq, dk, dv = tv4.plain_tile_band_backward(*rows, w)
    dk, dv = tv4._edge_fold(*rows, dk, dv, w)
    for grads in ((dq, dk, dv), tv4.tile_band_backward(*rows, w)):
        for got, ref in zip(grads, want):
            _close(got.reshape(ref.shape), ref)


@pytest.mark.parametrize("case", V4_CASES[:2])
def test_edge_fold_carries_the_clamped_mass(case):
    """Without the fold, rows 0 and S-1 of dk and dv miss the clamped
    positions' mass; every other row already agrees."""
    (q, k, v, g), _, want = _jax_v4(case)
    rows = [_rows(x) for x in (q, k, v, g)]
    _, dk, _ = tv4.plain_tile_band_backward(*rows, case[4])
    ref = want[1].reshape(dk.shape)
    _close(dk[:, 1:-1], ref[:, 1:-1])
    assert np.abs(dk[:, 0].numpy() - ref[:, 0]).max() > 1e-3


@pytest.mark.parametrize("case", V4_CASES)
def test_autograd_function_matches_jax_vjp(case):
    """``banded_attention_v4`` on [B, h, S, d] through the autograd Function
    (the plain versions on CPU tensors), forward and q, k, v gradients."""
    (q, k, v, g), want, want_grads = _jax_v4(case)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tv4.banded_attention_v4(qt, kt, vt, case[4])
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), want)
    for t, ref in zip((qt, kt, vt), want_grads):
        _close(t.grad, ref)


@functools.lru_cache(maxsize=None)
def _jax_v4b(case):
    (b, h, s, d, w) = case
    q, k, v = _arrays(sum(case) + 1, (b, h, s, d), 3)
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(jv4.banded_attention_v4b, static_argnums=3)(
            *map(jnp.asarray, (q, k, v)), w)
    return (q, k, v), np.asarray(out)


# B*h = 8 takes JAX's grouped grid (GROUP pairs a step), 3 and 2 the
# ungrouped one; S = 40 gives the tile t = 2*halo = 32, S = 197 one ragged
# tile of 200, S = 300 two of 256.
@pytest.mark.parametrize("case", [(2, 4, 197, 16, 7), (1, 3, 40, 16, 3),
                                  (1, 2, 300, 16, 4)])
def test_plain_k8_matches_jax_v4b(case):
    (q, k, v), want = _jax_v4b(case)
    assert (case[0] * case[1] % tv4.GROUP == 0) == (case[0] * case[1] == 8)
    got = tv4.banded_attention_v4b(*map(torch.from_numpy, (q, k, v)),
                                   case[4])
    _close(got, want)
    # K8 computes K6's band: the two plain versions agree.
    k6 = tv4.plain_tile_band_forward(*map(_rows, (q, k, v)), case[4])
    _close(got, k6.reshape(got.shape))


@pytest.mark.parametrize("s,t,halo", [(197, 200, 16), (300, 256, 16),
                                      (40, 32, 16), (70, 64, 32)])
def test_window_tiles_and_band_mask_match_jax(s, t, halo):
    x = _arrays(s, (3, s, 16), 1)[0]
    sp = -(-s // t) * t
    np.testing.assert_array_equal(
        tv4._window_tiles(torch.from_numpy(x), t, halo, sp).numpy(),
        np.asarray(jv4._window_tiles(jnp.asarray(x), t, halo, sp)))
    np.testing.assert_array_equal(
        tv4._band_mask(t, t + 2 * halo, halo, 5).numpy(),
        np.asarray(jv4._band_mask(t, t + 2 * halo, halo, 5)))
    for hw in (0, 3, 16, 17):
        assert tv4._halo(256, hw) == jv4._halo(256, hw)


# --- the composite: the tile band with the exact edge rows -----------------


@pytest.fixture
def tile_path(monkeypatch):
    """The tile-band branch on both sides: the two variables set, JAX told
    it runs on a TPU, the port's device predicate told it runs on the
    card."""
    for key, val in TILE_ENV.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)


@functools.lru_cache(maxsize=None)
def _jax_composite(s, w):
    """JAX's windowed_latent_attention through v4 (interpret mode) and its
    gradient, with the environment the tile_path fixture sets."""
    q, k, v, g = _arrays(s * w, (1, 2, s, 16))

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(
            lambda q, k, v: jwin.windowed_latent_attention(q, k, v, w),
            q, k, v)
        return out, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        out, grads = run(*map(jnp.asarray, (q, k, v, g)))
    return (q, k, v, g), np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("s,w", [(100, 4), (197, 7), (64, 3)])
def test_composite_matches_jax(tile_path, s, w):
    (q, k, v, g), want, want_grads = _jax_composite(s, w)
    tv4.reset_launch_count()
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = twin.windowed_latent_attention(qt, kt, vt, w)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach(), want)
    for t, ref in zip((qt, kt, vt), want_grads):
        _close(t.grad, ref)
    # CPU tensors ran the plain versions: no launch.
    assert [tv4.launch_count(kind) for kind in tv4.LAUNCH_KINDS] == [0, 0, 0]


def test_composite_edge_rows_equal_the_reference_windows(tile_path):
    """At odd W the composite is the gather oracle everywhere, edge rows
    included; the tile band alone differs there (clamped edges)."""
    (q, k, v, _), _, _ = _jax_composite(197, 7)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    oracle = twin._gather_windowed_attention(qt, kt, vt, 7)
    _close(twin.windowed_latent_attention(qt, kt, vt, 7), oracle)
    clamped = tv4.banded_attention_v4(qt, kt, vt, 7)
    assert (clamped - oracle)[:, :, :3].abs().max() > 1e-3


def test_even_window_interior_is_w_plus_one_keys_on_both_sides(tile_path):
    """A finding in the reference, reproduced: at even W the clamped band
    reads W + 1 keys, so the composite's interior rows are not the gather
    oracle's W-key windows, in JAX as in the port (W = 4, S = 100: they
    differ by about 1.5). At odd W they agree."""
    s, w = 100, 4
    (q, k, v, _), want, _ = _jax_composite(s, w)
    j_oracle = np.asarray(jwin._gather_windowed_attention(
        *map(jnp.asarray, (q, k, v)), w))
    t_oracle = twin._gather_windowed_attention(*map(torch.from_numpy,
                                                    (q, k, v)), w).numpy()
    t_comp = twin.windowed_latent_attention(*map(torch.from_numpy, (q, k, v)),
                                            w).numpy()
    inner = slice(w // 2, s - w // 2)
    assert np.abs(want - j_oracle)[:, :, inner].max() > 0.5
    assert np.abs(t_comp - t_oracle)[:, :, inner].max() > 0.5
    _close(t_comp, want)
    _close(t_oracle, j_oracle)


def test_tile_band_needs_the_opt_in_and_the_card(monkeypatch):
    """Without ``FAVIT_USE_PALLAS_MHLA=1``, or on a CPU tensor, a value
    other than auto/roll/densefull runs the plain shift band."""
    calls = []
    monkeypatch.setattr(tv4, "banded_attention_v4",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setenv("FAVIT_MHLA_IMPL", "shiftband")
    q, k, v = (torch.from_numpy(x) for x in _arrays(5, (1, 2, 64, 16), 3))
    shift = twin._shift_banded_attention(q, k, v, 7)
    monkeypatch.setenv("FAVIT_USE_PALLAS_MHLA", "1")
    assert torch.equal(twin.windowed_latent_attention(q, k, v, 7), shift)
    monkeypatch.setenv("FAVIT_USE_PALLAS_MHLA", "0")
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)
    assert torch.equal(twin.windowed_latent_attention(q, k, v, 7), shift)
    assert not calls
    monkeypatch.setenv("FAVIT_USE_PALLAS_MHLA", "1")
    twin.windowed_latent_attention(q, k, v, 7)
    assert len(calls) == 1


def test_composite_trains_after_an_inference_pass(tile_path):
    """The composite's cached edge indices, first made under
    ``inference_mode``, serve a later pass under autograd."""
    q, k, v = (torch.from_numpy(x) for x in _arrays(6, (1, 2, 75, 16), 3))
    with torch.inference_mode():
        want = twin.windowed_latent_attention(q, k, v, 5)
    q.requires_grad_()
    out = twin.windowed_latent_attention(q, k, v, 5)
    out.sum().backward()
    assert torch.equal(out.detach(), want) and q.grad is not None


def test_shift_band_matches_jax():
    q, k, v = _arrays(8, (2, 2, 65, 16), 3)
    for w in (4, 7):
        _close(twin._shift_banded_attention(*map(torch.from_numpy, (q, k, v)),
                                            w),
               jwin._shift_banded_attention(*map(jnp.asarray, (q, k, v)), w))


# --- the model through the tile band ----------------------------------------

GEOM = dict(patch_size=4, num_classes=10, embed_dim=32, depth=2, num_heads=2,
            window_size=7)


def _init_off_the_tile_band(module, x, seed):
    """Flax params of ``module``, initialised with the opt-in off (the
    params do not depend on the branch; the init's forward is then the
    quick shift band, not the kernel in interpret mode)."""
    with mock.patch.dict(os.environ, {"FAVIT_USE_PALLAS_MHLA": "0"}):
        return jax.jit(module.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(x))["params"]


@functools.lru_cache(maxsize=None)
def _jax_model(img_size):
    jmodel = JaxVisionTransformerMHLA(img_size=img_size, use_mhla=True, **GEOM)
    x = _arrays(img_size, (2, img_size, img_size, 3), 1)[0]
    return jmodel, _init_off_the_tile_band(jmodel, x, img_size), x


def _port_model(img_size, params):
    sd = flax_vit_mhla_to_state_dict(params)
    tmodel = VisionTransformerMHLA(img_size=img_size, **GEOM)
    # The tile-band path keeps the parameter names: the converter's keys
    # are the model's, and a strict load takes them.
    assert set(sd) == set(tmodel.state_dict())
    tmodel.load_state_dict(sd)
    return tmodel


Y = np.array([3, 7])


@functools.lru_cache(maxsize=None)
def _jax_logits_and_grads(img_size, grads=True):
    """Logits and, at ``grads``, the gradients of the CE mean over labels
    ``Y``, from one JAX pass through the tile band (interpret mode)."""
    jmodel, params, x = _jax_model(img_size)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), Y]), logits

    with pltpu.force_tpu_interpret_mode():
        if not grads:
            return np.asarray(jax.jit(loss_fn)(params)[1]), None, None
        (loss, logits), g = jax.jit(jax.value_and_grad(loss_fn,
                                                       has_aux=True))(params)
    return np.asarray(logits), float(loss), g


@pytest.mark.parametrize("img_size", [32, 96])  # S = 65 and S = 577
def test_model_logits_through_the_tile_band_match_jax(tile_path, img_size):
    want = _jax_logits_and_grads(img_size, grads=img_size == 32)[0]
    _, params, x = _jax_model(img_size)
    tmodel = _port_model(img_size, params).eval()
    tv4.reset_launch_count()
    band.reset_launch_count()
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    assert tv4.launch_count() == 0 and band.launch_count() == 0


def test_model_gradients_through_the_tile_band_match_jax(tile_path):
    """One f32 train step's gradients at S = 65 (the CE mean on shared
    weights), leaf by leaf in the port's layout."""
    _, params, x = _jax_model(32)
    _, loss_j, grads_j = _jax_logits_and_grads(32)
    want = flax_vit_mhla_to_state_dict(grads_j)
    tmodel = _port_model(32, params)
    loss_t = torch.nn.functional.cross_entropy(
        tmodel(torch.from_numpy(x)), torch.from_numpy(Y))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=TOL, err_msg=name)
    assert np.abs(tmodel.blocks[0].attn.latent_proj.weight.grad.numpy()
                  ).max() > 0


# --- the layer's dispatch on FAVIT_MHLA_IMPL ---------------------------------


JAX_LAYER = JaxMHLA(embed_dim=32, num_heads=2, window_size=5)


@functools.lru_cache(maxsize=None)
def _jax_layer_params(s):
    x = _arrays(s, (2, s, 32), 1)[0]
    return x, _init_off_the_tile_band(JAX_LAYER, x, 2)


def _jax_layer(s):
    """JAX's layer output under the FAVIT_MHLA_IMPL that the caller set."""
    x, params = _jax_layer_params(s)
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(JAX_LAYER.apply)({"params": params}, jnp.asarray(x))
    return x, params, np.asarray(out)


def _port_layer(params):
    layer = tlayers.MultiHeadLatentAttention(32, 2, window_size=5)
    with torch.no_grad():
        kernel = np.asarray(params["qkv"]["kernel"])  # [D, 3, h, d]
        layer.qkv.weight.copy_(torch.from_numpy(
            kernel.reshape(32, -1).T.copy()))
        layer.qkv.bias.copy_(torch.from_numpy(
            np.asarray(params["qkv"]["bias"]).reshape(-1).copy()))
        for name in ("latent_proj", "proj"):
            kernel = np.asarray(params[name]["kernel"])
            layer.get_submodule(name).weight.copy_(torch.from_numpy(
                kernel.reshape(-1, kernel.shape[-1]).T.copy()))
            layer.get_submodule(name).bias.copy_(torch.from_numpy(
                np.asarray(params[name]["bias"]).copy()))
    return layer.eval()


@pytest.mark.parametrize("s", [65, 577])
@pytest.mark.parametrize("impl", ["auto", "roll", "densefull", "shiftband"])
def test_layer_dispatch_matches_jax_on_the_cpu(monkeypatch, impl, s):
    """Each value of FAVIT_MHLA_IMPL on the CPU, against JAX's layer under
    the same value (no TPU, so no tile band on either side)."""
    monkeypatch.setenv("FAVIT_MHLA_IMPL", impl)
    monkeypatch.delenv("FAVIT_USE_PALLAS_MHLA", raising=False)
    x, params, want = _jax_layer(s)
    with torch.inference_mode():
        got = _port_layer(params)(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_long_s_attention_dropout_takes_the_shift_band(monkeypatch):
    """Training with attn_dropout > 0 at S > 512 off the S-minor branch:
    the token-major shift band with one Bernoulli per window slot on its
    [B, h, W, S] weights, and no kernel."""
    for key, val in TILE_ENV.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)
    shapes = []
    real = tlayers.inverted_dropout

    def spy(x, rate, rng):
        shapes.append(tuple(x.shape))
        return real(x, rate, rng)

    monkeypatch.setattr(tlayers, "inverted_dropout", spy)
    layer = tlayers.MultiHeadLatentAttention(32, 2, window_size=5,
                                             dropout=0.1).train()
    tv4.reset_launch_count()
    band.reset_launch_count()
    x = torch.from_numpy(_arrays(1, (2, 577, 32), 1)[0]).requires_grad_()
    out = layer(x, tlayers.DropoutRNG(0, "cpu"))
    out.sum().backward()
    assert shapes == [(2, 2, 5, 577), (2, 577, 32)]
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert [tv4.launch_count(k) for k in tv4.LAUNCH_KINDS] == [0, 0, 0]
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [0, 0, 0]


def test_auto_and_roll_keep_the_sminor_branch(monkeypatch):
    """With auto (the default) or roll the long-S layer keeps the S-minor
    band op, with the opt-in set or not."""
    monkeypatch.setenv("FAVIT_USE_PALLAS_MHLA", "1")
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)
    calls = []
    monkeypatch.setattr(tlayers.MultiHeadLatentAttention, "_forward_sminor",
                        lambda self, x, rate, rng: calls.append(1) or x)
    layer = tlayers.MultiHeadLatentAttention(32, 2, window_size=5).eval()
    x = torch.zeros(1, 577, 32)
    for impl in ("auto", "roll", "shiftband", "densefull"):
        monkeypatch.setenv("FAVIT_MHLA_IMPL", impl)
        layer(x)
    assert len(calls) == 2


# --- launches and refusals --------------------------------------------------


def test_cpu_tensors_launch_no_kernel():
    tv4.reset_launch_count()
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _arrays(3, (1, 2, 50, 16), 3))
    tv4.banded_attention_v4(q, k, v, 5).sum().backward()
    with torch.no_grad():
        tv4.banded_attention_v4b(q, k, v, 5)
    assert q.grad is not None
    assert [tv4.launch_count(kind) for kind in tv4.LAUNCH_KINDS] == [0, 0, 0]


@pytest.mark.parametrize("case,err", [
    ("wide", ValueError),
    ("head_dim", ValueError),
    ("dtype", TypeError),
    ("strided", ValueError),
    ("shapes", ValueError),
    ("block", ValueError),
])
def test_tile_band_rejects(case, err):
    s, w, d = 40, 7, 16
    q, k, v = (torch.zeros(6, s, d) for _ in range(3))
    if case == "wide":
        w = tv4.MAX_WINDOW + 1
    elif case == "head_dim":
        q, k, v = (torch.zeros(6, s, 24) for _ in range(3))
    elif case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "strided":
        q = torch.zeros(6, d, s).transpose(1, 2)
    elif case == "shapes":
        v = torch.zeros(6, s + 1, d)
    with pytest.raises(err):
        if case == "block":
            tv4.banded_attention_v4(*(x.view(2, 3, s, d) for x in (q, k, v)),
                                    w, block=0)
        else:
            tv4.tile_band_forward(q, k, v, w)
