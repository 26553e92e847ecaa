"""Every head dim the JAX package takes, against the JAX package on the CPU
in f32: off the grid of 8 (d = 12: 64 heads at D = 768), at the tile
widths 192 and 256 (136, 192, 256: 4 and 3 heads at D = 768) and past 256
(264, 384: 2 heads at D = 768; 520 and 1032 at the wide blocks' slice
edges).
Dense attention (K5's plain versions) against JAX's ``flash_attention``
(its chunked path off the TPU), the fused op
(K3/K4's) against JAX's fused kernel in interpret mode, the band op (K1/K2's)
against JAX's roll kernel in interpret mode, the tile band (K6/K7's) against
JAX's v4 in interpret mode, and 2-block models at D = 24 and 768 with 2
heads, and a dense one at D = 768 with 3, weights carried across by
``convert/from_jax.py``. Also the kernels' pad of the head dim on its own
(:func:`..ops.flash_attention.pad_head_dim`).
Inputs come from numpy seeds and go through both packages; every JAX
reference runs once, in a module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from focused_attention_vit_tpu import models as jmodels
from focused_attention_vit_tpu.ops import flash_attention as jflash
from focused_attention_vit_tpu.ops import mha_kernel as jmha
from focused_attention_vit_tpu.ops import mhla_kernel_v4 as jv4
from focused_attention_vit_tpu.ops.mhla_band_roll import (
    roll_banded_attention as jax_roll_banded_attention,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
)
from focused_attention_vit_tpu_torch.models import (
    VisionTransformer,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.ops import flash_attention as flash
from focused_attention_vit_tpu_torch.ops import mha_kernel as fused
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tv4

torch.set_num_threads(2)

# f32 on both sides; the sums run in different orders (ROADMAP's parity
# rule): outputs and logits within 1e-4, gradients within 1e-5, absolute and
# relative (tests/test_torch_tile_band.py's rule: a gradient entry sums
# hundreds of terms).
OUT_TOL = 1e-4
GRAD_TOL = 1e-5
PAD_TOL = 1e-6  # one function, padded or not: f32 sums in other blockings
# Past 256 also the wide blocks' slice plan's edges, a column past a slice
# of 512 and of 1024 (ops/flash_attention.wide_plan).
DENSE_DIMS = (12, 136, 192, 256, 264, 384, 520, 1032)
DENSE_S = 577
FUSED_DIMS = (264, 384, 520, 1032)
# The tile widths of csrc/flash_block256.cuh, past their whole-row kernel's
# 64 keys.
FUSED_BLOCK256_DIMS = (192, 256)
FUSED_S = 65
BAND_CASES = [(d, w) for d in (12, 384) for w in (7, 17)]
BAND_S = 100
V4_CASE = (12, 7, 80)  # d, W, S
# 2-block models at S = 24^2 + 1 = 577 (the long-S paths): 2 heads of 12
# and 2 heads of 384 (D = 768).
MODEL_DIMS = (24, 768)
HEADS, DEPTH, IMG, PATCH = 2, 2, 96, 4
HEADS_256 = 3  # D = 768 in 3 heads: d = 256, the widest tile
MODEL_W = 7
Y = np.array([3, 7])


def _arrays(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _jax_vjp(fn, arrays, interpret=False):
    """``fn(q, k, v)`` and its VJP on the cotangent ``arrays[3]``, jitted;
    Pallas kernels in interpret mode."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    args = map(jnp.asarray, arrays)
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            out, grads = run(*args)
    else:
        out, grads = run(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _jax_model(jmodel, x):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), Y]), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return params, np.asarray(logits), float(loss), grads


@pytest.fixture(scope="module")
def refs():
    out = {}
    for d in DENSE_DIMS:
        arrays = _arrays(d, (1, 2, DENSE_S, d))
        out[("dense", d)] = (arrays, *_jax_vjp(jflash.flash_attention,
                                               arrays))
    for d in FUSED_DIMS + FUSED_BLOCK256_DIMS:
        arrays = _arrays(d + FUSED_S, (1, 2, FUSED_S, d))
        out[("fused", d)] = (arrays, *_jax_vjp(
            jmha.fused_multi_head_attention, arrays, interpret=True))
    for d, w in BAND_CASES:
        arrays = _arrays(d * w, (1, 2, d, BAND_S))
        out[("band", d, w)] = (arrays, *_jax_vjp(
            lambda q, k, v, w=w: jax_roll_banded_attention(q, k, v, w),
            arrays, interpret=True))
    d, w, s = V4_CASE
    arrays = _arrays(d + w + s, (1, 2, s, d))
    out["v4"] = (arrays, *_jax_vjp(
        lambda q, k, v: jv4.banded_attention_v4(q, k, v, w), arrays,
        interpret=True))
    for dim in MODEL_DIMS:
        geom = dict(img_size=IMG, patch_size=PATCH, num_classes=10,
                    embed_dim=dim, depth=DEPTH, num_heads=HEADS)
        x = np.random.default_rng(dim).normal(
            size=(2, IMG, IMG, 3)).astype(np.float32)
        out[("mhla", dim)] = (x, *_jax_model(jmodels.VisionTransformerMHLA(
            window_size=MODEL_W, use_mhla=True, **geom), x))
        out[("vit", dim)] = (x, *_jax_model(jmodels.VisionTransformer(**geom),
                                            x))
    geom = dict(img_size=IMG, patch_size=PATCH, num_classes=10,
                embed_dim=MODEL_DIMS[1], depth=DEPTH, num_heads=HEADS_256)
    x = np.random.default_rng(HEADS_256).normal(
        size=(2, IMG, IMG, 3)).astype(np.float32)
    out["vit256"] = (x, *_jax_model(jmodels.VisionTransformer(**geom), x))
    return out


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _through_autograd(op, arrays):
    """``op(q, k, v)`` on CPU tensors and its gradients for the cotangent
    ``arrays[3]``."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    out = op(q, k, v)
    out.backward(torch.from_numpy(arrays[3]))
    return out.detach(), [t.grad for t in (q, k, v)]


@pytest.mark.parametrize("d", DENSE_DIMS)
def test_dense_attention_matches_jax_flash(refs, d):
    """The flash op on CPU tensors (K5's plain forward and backward) against
    JAX's ``flash_attention`` at S = 577 and d = 12, 136 to 256 (the tile
    widths 192 and 256), 264 to 1032 (the wide blocks): the output within
    1e-4, dq, dk, dv within 1e-5; no kernel launched."""
    arrays, want, want_grads = refs[("dense", d)]
    flash.reset_launch_count()
    out, grads = _through_autograd(flash.flash_attention, arrays)
    _close(out, want, OUT_TOL, "out")
    for name, got, ref in zip("qkv", grads, want_grads):
        _close(got, ref, GRAD_TOL, f"d{name}")
    assert [flash.launch_count(k) for k in flash.LAUNCH_KINDS] == [0, 0, 0]


@pytest.mark.parametrize("d", FUSED_DIMS)
def test_fused_op_matches_jax_past_256(refs, d):
    """The fused op on CPU tensors (K3/K4's plain versions) against JAX's
    fused kernel (interpret mode) at S = 65 and d = 264, 384, which JAX
    takes (d % 8 == 0): the output within 1e-4, gradients within 1e-5."""
    arrays, want, want_grads = refs[("fused", d)]
    assert fused.fused_mha_supported(FUSED_S, d)
    out, grads = _through_autograd(fused.fused_multi_head_attention, arrays)
    _close(out, want, OUT_TOL, "out")
    for name, got, ref in zip("qkv", grads, want_grads):
        _close(got, ref, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("d", FUSED_BLOCK256_DIMS)
def test_fused_op_matches_jax_at_tile_widths_192_and_256(refs, d):
    """The fused op on CPU tensors (K3/K4's plain versions) against JAX's
    fused kernel (interpret mode) at S = 65, one key past the whole-row
    kernel at d = 192 and 256: the output within 1e-4, gradients within
    1e-5; no kernel launched."""
    arrays, want, want_grads = refs[("fused", d)]
    assert fused.fused_mha_supported(FUSED_S, d)
    fused.reset_launch_count()
    out, grads = _through_autograd(fused.fused_multi_head_attention, arrays)
    _close(out, want, OUT_TOL, "out")
    for name, got, ref in zip("qkv", grads, want_grads):
        _close(got, ref, GRAD_TOL, f"d{name}")
    assert [fused.launch_count(k) for k in fused.LAUNCH_KINDS] == [0, 0, 0]


@pytest.mark.parametrize("d,w", BAND_CASES)
def test_band_op_matches_jax_roll_kernel(refs, d, w):
    """The band op on S-minor CPU tensors (K1/K2's plain versions) against
    JAX's roll kernel (interpret mode) at d = 12, 384 and W = 7, 17: the
    output within 1e-4, gradients within 1e-5."""
    arrays, want, want_grads = refs[("band", d, w)]
    band.reset_launch_count()
    out, grads = _through_autograd(
        lambda q, k, v: band.roll_banded_attention(q, k, v, w), arrays)
    _close(out, want, OUT_TOL, "out")
    for name, got, ref in zip("qkv", grads, want_grads):
        _close(got, ref, GRAD_TOL, f"d{name}")
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [0, 0, 0]


def test_tile_band_matches_jax_v4_off_the_grid(refs):
    """The tile band on CPU tensors (K6/K7's plain versions) against JAX's
    v4 (interpret mode) at d = 12: output within 1e-4, gradients within
    1e-5."""
    arrays, want, want_grads = refs["v4"]
    out, grads = _through_autograd(
        lambda q, k, v: tv4.banded_attention_v4(q, k, v, V4_CASE[1]), arrays)
    _close(out, want, OUT_TOL, "out")
    for name, got, ref in zip("qkv", grads, want_grads):
        _close(got, ref, GRAD_TOL, f"d{name}")


def test_window_tile_band_checks_rank_first():
    """A query tile of the wrong rank raises the function's own message,
    not Python's unpacking error."""
    x = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match=r"q tiles \[BH, n_t, t, d\]"):
        tv4.window_tile_band(x, x, x, 3)


@pytest.mark.parametrize("d", (4, 12, 36))
def test_pad_head_dim_keeps_the_function(d):
    """The kernels' pad on its own: the plain flash forward and backward on
    inputs padded with zero columns to a multiple of 8, at the true head
    dim's scale, sliced back, equal the unpadded call (a zero column adds
    exact zeros to every sum; a product over the padded width may block its
    sums otherwise, so within 1e-6), and the padded columns of the output
    and of each gradient are zeros."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(d, (2, 3, 70, d)))
    want_out, want_lse = flash.plain_flash_forward(q, k, v)
    want_grads = flash.plain_flash_backward(q, k, v, want_out, want_lse, g)
    qp, kp, vp, gp = (flash.pad_head_dim(x) for x in (q, k, v, g))
    assert qp.shape[-1] == -(-d // 8) * 8 and qp.is_contiguous()
    scale = d ** -0.5
    out, lse = flash.plain_flash_forward(qp, kp, vp, scale=scale)
    grads = flash.plain_flash_backward(qp, kp, vp, out, lse, gp,
                                       scale=scale)
    _close(flash.unpad_head_dim(out, d), want_out, PAD_TOL, "out")
    _close(lse, want_lse, PAD_TOL, "lse")
    for name, got, want in zip("qkv", grads, want_grads):
        _close(flash.unpad_head_dim(got, d), want, PAD_TOL, f"d{name}")
        assert not got[..., d:].any()
    assert not out[..., d:].any()
    # S-minor tensors pad their channel dim.
    x = torch.ones(1, 2, d, 5)
    xp = flash.pad_head_dim(x, 2)
    assert xp.shape == (1, 2, -(-d // 8) * 8, 5) and xp[:, :, d:].sum() == 0
    assert flash.unpad_head_dim(xp, d, 2).equal(x)
    assert flash.pad_head_dim(qp) is qp


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


@pytest.mark.parametrize("dim", MODEL_DIMS)
def test_mhla_model_matches_jax_at_two_heads(refs, dim):
    """A 2-block MHLA model with 2 heads (d = 12, 384) at S = 577, which
    takes the S-minor band: logits within 1e-4, every gradient within
    1e-5."""
    geom = dict(img_size=IMG, patch_size=PATCH, num_classes=10,
                embed_dim=dim, depth=DEPTH, num_heads=HEADS)
    _check_model(VisionTransformerMHLA(window_size=MODEL_W, **geom),
                 flax_vit_mhla_to_state_dict, refs[("mhla", dim)])


@pytest.mark.parametrize("dim", MODEL_DIMS)
def test_dense_vit_matches_jax_at_two_heads(refs, dim):
    """A 2-block dense ViT with 2 heads (d = 12, 384) at S = 577, which
    takes the flash op: logits within 1e-4, every gradient within 1e-5."""
    geom = dict(img_size=IMG, patch_size=PATCH, num_classes=10,
                embed_dim=dim, depth=DEPTH, num_heads=HEADS)
    _check_model(VisionTransformer(**geom), flax_vit_to_state_dict,
                 refs[("vit", dim)])


def test_dense_vit_matches_jax_at_three_heads(refs):
    """A 2-block dense ViT at D = 768 with 3 heads (d = 256, the widest
    tile of csrc/flash_block256.cuh) at S = 577, through the flash op:
    logits within 1e-4, every gradient within 1e-5."""
    geom = dict(img_size=IMG, patch_size=PATCH, num_classes=10,
                embed_dim=MODEL_DIMS[1], depth=DEPTH, num_heads=HEADS_256)
    flash.reset_launch_count()
    _check_model(VisionTransformer(**geom), flax_vit_to_state_dict,
                 refs["vit256"])
    assert [flash.launch_count(k) for k in flash.LAUNCH_KINDS] == [0, 0, 0]
