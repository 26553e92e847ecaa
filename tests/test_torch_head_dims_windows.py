"""The window band and the dense attention at the windows and head dims the
JAX package takes: the port against JAX on the CPU, in f32, at windows past
16 (up to the roll band's 129) and head dims that are not powers of two
(24, 80: ViT-H/14's). Inputs and weights come from a numpy or JAX seed and go
through both packages; every JAX reference runs once, in a module fixture."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu import models as jmodels
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
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band

torch.set_num_threads(2)

# f32 on both sides over 2 blocks; the sums run in different orders
# (ROADMAP's parity rule).
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-5
IMG, PATCH, DEPTH, HEADS = 96, 4, 2, 2  # S = 24^2 + 1 = 577: the long-S path
Y = np.array([3, 7])
# (W, d): past the old slot cap (17), an even window at a head dim that is
# not a power of two (64, 24), the roll band's widest window at ViT-H/14's
# head dim (129, 80), and the model's own window at that head dim (7, 80).
MHLA_CASES = [(17, 32), (64, 24), (129, 80), (7, 80)]
DENSE_HEAD_DIM = 80
BAND_CASE = (129, 24, 300)  # W, d, S


def _images(seed):
    return np.random.default_rng(seed).normal(
        size=(2, IMG, IMG, 3)).astype(np.float32)


def _jax_run(jmodel, x, init_model=None):
    """Parameters, logits, the CE loss over ``Y`` and its gradients from
    one jitted JAX pass. ``init_model`` (same parameters, cheaper to trace)
    initialises them."""
    params = jax.jit((init_model or jmodel).init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]

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
    for w, d in MHLA_CASES:
        geom = dict(img_size=IMG, patch_size=PATCH, num_classes=10,
                    embed_dim=HEADS * d, depth=DEPTH, num_heads=HEADS,
                    use_mhla=True)
        jmodel = jmodels.VisionTransformerMHLA(window_size=w, **geom)
        # The window sets no parameter: W = 1 initialises the same tree
        # without tracing a wide band twice.
        x = _images(w + d)
        out[("mhla", w, d)] = (x, *_jax_run(
            jmodel, x, jmodels.VisionTransformerMHLA(window_size=1, **geom)))
    jmodel = jmodels.VisionTransformer(
        img_size=IMG, patch_size=PATCH, num_classes=10,
        embed_dim=HEADS * DENSE_HEAD_DIM, depth=DEPTH, num_heads=HEADS)
    x = _images(DENSE_HEAD_DIM)
    out["vit"] = (x, *_jax_run(jmodel, x))
    w, d, s = BAND_CASE
    q, k, v, g = (np.random.default_rng(s + i).normal(
        size=(1, 2, d, s)).astype(np.float32) for i in range(4))
    # JAX's lane-roll kernel, in interpret mode off the TPU as its own tests
    # run it, and its custom-VJP backward.
    want, vjp = jax.vjp(
        lambda q_, k_, v_: jax_roll_banded_attention(q_, k_, v_, w),
        *map(jnp.asarray, (q, k, v)))
    out["band"] = ((q, k, v, g), np.asarray(want),
                   [np.asarray(x) for x in vjp(jnp.asarray(g))])
    return out


@functools.lru_cache(maxsize=None)
def _port_mhla(w, d):
    return VisionTransformerMHLA(
        img_size=IMG, patch_size=PATCH, num_classes=10, embed_dim=HEADS * d,
        depth=DEPTH, num_heads=HEADS, window_size=w)


def _check_model(tmodel, to_sd, ref):
    x, params, want_logits, want_loss, want_grads = ref
    tmodel.load_state_dict(to_sd(params))
    tmodel.eval()
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_logits, atol=LOGIT_TOL, rtol=0)
    tmodel.zero_grad(set_to_none=True)
    loss = torch.nn.functional.cross_entropy(tmodel(torch.from_numpy(x)),
                                             torch.from_numpy(Y))
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-5
    want = to_sd(want_grads)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=GRAD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("w,d", MHLA_CASES)
def test_mhla_model_matches_jax_at_wide_windows_and_head_dims(refs, w, d):
    """The MHLA model at S = 577 takes the band op (the S-minor path), which
    on the CPU runs its plain version at any W and d, as JAX's shift band
    does: logits within 1e-4 and every gradient within 1e-5. Before the
    repair the port raised ValueError here."""
    band.reset_launch_count()
    _check_model(_port_mhla(w, d), flax_vit_mhla_to_state_dict,
                 refs[("mhla", w, d)])
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [0, 0, 0]
    # The layer took the S-minor band: its training forward saved weights
    # of W slots (checked through the op on the model's own shape).
    q = torch.zeros(2, HEADS, d, 577)
    assert band.band_forward_train(q, q, q, w)[1].shape == (2 * HEADS, w, 577)


def test_dense_vit_matches_jax_at_head_dim_80(refs):
    """The dense ViT at d = 80 and S = 577 (the flash op's length) through
    the flash op's plain versions: logits within 1e-4, gradients within
    1e-5."""
    flash.reset_launch_count()
    tmodel = VisionTransformer(
        img_size=IMG, patch_size=PATCH, num_classes=10,
        embed_dim=HEADS * DENSE_HEAD_DIM, depth=DEPTH, num_heads=HEADS)
    _check_model(tmodel, flax_vit_to_state_dict, refs["vit"])
    assert [flash.launch_count(k) for k in flash.LAUNCH_KINDS] == [0, 0, 0]


def test_band_op_matches_jax_roll_kernel_at_w129_d24(refs):
    """The band op on CPU tensors at W = 129 (the roll band's limit) and
    d = 24 against JAX's lane-roll kernel in interpret mode: the output
    within 1e-5, and the training path's (dq, dk, dv) against the kernel's
    custom-VJP backward within 1e-5."""
    (q, k, v, g), want, want_grads = refs["band"]
    w = BAND_CASE[0]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = band.roll_banded_attention(tq, tk, tv, w)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    got.backward(torch.from_numpy(g))
    for t, ref in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("w,d,s", [(17, 24, 40), (129, 80, 300),
                                   (64, 8, 129), (130, 20, 261)])
def test_band_op_takes_any_window_and_head_dim_on_the_cpu(w, d, s):
    """On a CPU tensor the op and its training form take any W with
    S > 2W and any d, W = 130 and d = 20 included, equal to the plain
    version; the card's range is checked only for CUDA tensors."""
    rng = np.random.default_rng(w * d)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(1, 2, d, s)).astype(
        np.float32)) for _ in range(4))
    got = band.roll_banded_attention(q, k, v, w)
    torch.testing.assert_close(got, band.plain_banded_attention(q, k, v, w),
                               atol=0, rtol=0)
    out, wts = band.band_forward_train(q, k, v, w, 0.1, 5)
    ref_out, ref_wts = band.plain_band_forward_train(q, k, v, w, 0.1, 5)
    assert torch.equal(out, ref_out) and torch.equal(wts, ref_wts)
    grads = band.band_backward(q, k, v, g, wts, w, 0.1, 5)
    for got_g, want_g in zip(grads, band.plain_band_backward(
            q, k, v, g, wts, w, 0.1, 5)):
        assert torch.equal(got_g, want_g)


def test_band_dropout_words_past_16_slots():
    """The plain generator's words at W = 129: slot o is word o % 4 of the
    Philox draw at counter (i, o // 4, row): the same draws as W = 16's
    first 16 slots, so a wide window's mask extends a narrow one's."""
    wide = band.keep_bits(3, 129, 50, 2**40 + 9, "cpu")
    narrow = band.keep_bits(3, 16, 50, 2**40 + 9, "cpu")
    assert wide.shape == (3, 129, 50)
    assert torch.equal(wide[:, :16], narrow)
    assert len(torch.unique(wide)) > 0.99 * wide.numel()
