"""The port's fused short-S attention against the JAX package, on the CPU, in
f32: the plain versions (what a CPU tensor runs) against the JAX Pallas
kernels in TPU interpret mode at rate 0, forward and all three gradients;
the dropout semantics at rate > 0 (the TPU generator's stream exists only on
a TPU, so rate, independence, determinism and the gradient are checked on
the port's side); the support rule; and the opt-in switch of
``MultiHeadAttention``. Inputs come from a numpy seed and go to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from focused_attention_vit_tpu.ops import mha_kernel as jmha
from focused_attention_vit_tpu_torch.models.layers import (
    DropoutRNG,
    MultiHeadAttention,
    init_weights,
)
from focused_attention_vit_tpu_torch.ops import flash_attention as flash
from focused_attention_vit_tpu_torch.ops import mha_kernel as mha
from focused_attention_vit_tpu_torch.ops import philox

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


def _arrays(s, d, seed=0, n=4, bh=(2, 3)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(*bh, s, d)).astype(np.float32)
            for _ in range(n)]


def _t(arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad) for a in arrays]


# --- (a) against the JAX kernels in interpret mode, rate 0 -----------------


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("s", [5, 128, 197, 300])
def test_plain_versions_match_the_jax_kernels(s, d):
    arrays = _arrays(s, d, seed=s + d)
    q, k, v = _t(arrays[:3], requires_grad=True)
    g = torch.from_numpy(arrays[3])
    out = mha.fused_multi_head_attention(q, k, v)
    out.backward(g)

    jq, jk, jv, jg = map(jnp.asarray, arrays)
    with pltpu.force_tpu_interpret_mode():
        want = jmha.fused_multi_head_attention(jq, jk, jv)
        want_grads = jax.grad(
            lambda *a: (jmha.fused_multi_head_attention(*a) * jg).sum(),
            argnums=(0, 1, 2))(jq, jk, jv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    for name, t, w in zip("qkv", (q, k, v), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")


def test_eval_forward_outside_autograd_is_the_same_function():
    q, k, v = _t(_arrays(37, 16)[:3])
    with torch.no_grad():
        lean = mha.fused_multi_head_attention(q, k, v)
    out, lse = mha.fused_mha_forward_train(q, k, v)
    assert torch.equal(lean, out)
    logits = torch.matmul(q, k.transpose(-1, -2)) * 16 ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))


# --- (b) dropout on the plain version ------------------------------------------


def test_dropout_mask_rate_within_three_sigma():
    rate, n = 0.1, 6 * 197 * 197
    keep = philox.mha_keep_mask(6, 197, rate, seed=11)
    assert keep.shape == (6, 197, 197)
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float((~keep).float().mean()) - rate) < 3 * sigma


def test_dropout_words_follow_the_counter_definition():
    """Key j of query i takes word ``j % 2 + 2 * ((j % 16) // 8)`` of the
    Philox call with counter ``(i, 4 * (j // 16) + (j % 8) // 2, row, 0)``:
    nothing depends on how S is tiled."""
    seed = 2**40 + 5
    bits = philox.mha_keep_bits(3, 37, seed)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for row, i, j in ((0, 0, 0), (1, 5, 9), (2, 36, 36), (2, 20, 17),
                      (1, 3, 24), (0, 7, 15)):
        counter = tuple(torch.tensor([x]) for x in
                        (i, 4 * (j // 16) + (j % 8) // 2, row, 0))
        words = philox.philox4x32_10(counter, key)
        assert int(words[j % 2 + 2 * ((j % 16) // 8)]) == int(bits[row, i, j])
    # A longer sequence has the shorter one's words in its corner.
    assert torch.equal(philox.mha_keep_bits(3, 50, seed)[:, :37, :37], bits)


def test_dropout_is_deterministic_per_seed_and_differs_across_rows():
    q, k, v = _t(_arrays(40, 16)[:3])
    a = mha.plain_fused_mha_forward(q, k, v, 0.3, 7)[0]
    b = mha.plain_fused_mha_forward(q, k, v, 0.3, 7)[0]
    c = mha.plain_fused_mha_forward(q, k, v, 0.3, 8)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    keep = philox.mha_keep_mask(6, 40, 0.3, 7)
    for r in range(1, 6):  # every (b, h) row draws its own stream
        assert not torch.equal(keep[0], keep[r])


def test_dropout_preserves_the_mean():
    """With V = 1 each output entry is the sum of its dropped weights:
    ``kept / (1 - rate)`` on average 1."""
    q, k, _ = _t(_arrays(197, 16)[:3])
    out = mha.plain_fused_mha_forward(q, k, torch.ones_like(q), 0.1, 3)[0]
    assert abs(float(out.mean()) - 1.0) < 0.01


def test_dropout_normalises_by_the_unmasked_sum():
    """The mask applies to the normalised weights: a kept weight is
    ``softmax / (1 - rate)``, not a share of the kept weights' sum (which
    would make every row of weights sum to 1)."""
    rate, seed, s = 0.5, 21, 24
    q, k, _ = _t(_arrays(s, 8)[:3])
    v = torch.eye(s).expand(2, 3, s, s)[..., :8].contiguous()  # picks keys 0..7
    out = mha.plain_fused_mha_forward(q, k, v, rate, seed)[0]
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * 8 ** -0.5, -1)
    keep = philox.mha_keep_mask(6, s, rate, seed).view(2, 3, s, s)
    want = torch.where(keep, p / (1 - rate), 0.0)[..., :8]
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-5)
    row_sums = torch.where(keep, p / (1 - rate), 0.0).sum(-1)
    assert float((row_sums - 1).abs().max()) > 0.05


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("s,d", [(5, 8), (64, 16), (197, 64)])
def test_gradient_matches_autograd_of_the_materialised_form(s, d, rate):
    """The explicit backward (with the regenerated mask) against autograd
    through a materialised softmax with the same mask; and the row sum the
    CUDA backward takes, ``rowsum(g * out)``, is the same number."""
    seed = 5 if rate else None
    arrays = _arrays(s, d, seed=3)
    g = torch.from_numpy(arrays[3])
    q, k, v = _t(arrays[:3], requires_grad=True)
    out = mha.fused_multi_head_attention(q, k, v, dropout_rate=rate,
                                         dropout_seed=seed)
    out.backward(g)

    qa, ka, va = _t(arrays[:3], requires_grad=True)
    w = torch.softmax(torch.matmul(qa, ka.transpose(-1, -2)) * d ** -0.5, -1)
    if rate:
        keep = philox.mha_keep_mask(6, s, rate, seed).view(2, 3, s, s)
        w = torch.where(keep, w / (1 - rate), 0.0)
    ref = torch.matmul(w, va)
    ref.backward(g)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    with torch.no_grad():
        by_out = mha.plain_fused_mha_backward(q, k, v, g, rate, seed,
                                              out=out.detach())
    for name, got, alt, want in zip("qkv", (q, k, v), by_out, (qa, ka, va)):
        torch.testing.assert_close(got.grad, want.grad, atol=1e-5, rtol=0,
                                   msg=f"d{name}")
        torch.testing.assert_close(alt, want.grad, atol=1e-5, rtol=0,
                                   msg=f"d{name} by rowsum(g * out)")


def test_rate_needs_a_seed_and_a_valid_range():
    q, k, v = _t(_arrays(8, 8)[:3])
    with pytest.raises(ValueError, match="seed"):
        mha.fused_multi_head_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="rate"):
        mha.fused_multi_head_attention(q, k, v, dropout_rate=1.0,
                                       dropout_seed=1)


# --- (c) the support rule ------------------------------------------------------


@pytest.mark.parametrize("d", [4, 8, 12, 16, 60, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 128, 197, 896, 897, 1024, 1025, 3137])
def test_supported_matches_jax(s, d):
    assert mha.fused_mha_supported(s, d) == jmha.fused_mha_supported(s, d)
    assert mha.MAX_TILE_SEQ == jmha.MAX_TILE_SEQ


@pytest.mark.parametrize("shape,match", [
    ((2, 3, 1025, 8), "S <= 1024"),
    ((2, 3, 16, 12), "multiples of 8"),
])
def test_unsupported_shapes_raise(shape, match):
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        mha.fused_multi_head_attention(q, q, q)


def test_strided_inputs_raise():
    q = torch.zeros(2, 16, 3, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mha.fused_multi_head_attention(q, q, q)


# --- (d) the switch in MultiHeadAttention ------------------------------------


def _layer(dropout=0.0, use_flash=None):
    layer = MultiHeadAttention(32, 4, dropout=dropout, use_flash=use_flash)
    init_weights(layer, torch.Generator().manual_seed(0))
    return layer


class _Calls:
    """Counts calls of the fused op through the layer's module."""

    def __init__(self, monkeypatch):
        from focused_attention_vit_tpu_torch.models import layers

        self.n = 0
        real = layers.fused_multi_head_attention

        def counted(*args, **kw):
            self.n += 1
            return real(*args, **kw)

        monkeypatch.setattr(layers, "fused_multi_head_attention", counted)


def test_switch_on_and_off_give_the_same_eval_output(monkeypatch):
    calls = _Calls(monkeypatch)
    layer = _layer().eval()
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(2, 50, 32)).astype(np.float32))
    monkeypatch.delenv("FAVIT_FUSED_MHA", raising=False)
    with torch.no_grad():
        off = layer(x)
    assert calls.n == 0  # default: off
    monkeypatch.setenv("FAVIT_FUSED_MHA", "0")
    with torch.no_grad():
        layer(x)
    assert calls.n == 0
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")  # read at call time
    with torch.no_grad():
        on = layer(x)
    assert calls.n == 1
    torch.testing.assert_close(on, off, atol=1e-5, rtol=0)
    assert [mha.launch_count(kind) for kind in mha.LAUNCH_KINDS] == [0, 0, 0]


@pytest.mark.parametrize("use_flash", [True, False])
def test_use_flash_overrides_the_switch(monkeypatch, use_flash):
    calls = _Calls(monkeypatch)
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    layer = _layer(use_flash=use_flash).eval()
    with torch.no_grad():
        layer(torch.zeros(1, 20, 32))
    assert calls.n == 0
    layer.train()
    layer.dropout = 0.2
    layer(torch.zeros(1, 20, 32), DropoutRNG(0, "cpu"))
    assert calls.n == 0


def test_unsupported_shapes_take_the_other_paths(monkeypatch):
    calls = _Calls(monkeypatch)
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    layer = MultiHeadAttention(24, 2)  # head dim 12: not a multiple of 8
    init_weights(layer, torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.eval()(torch.zeros(1, 20, 24))
    assert calls.n == 0


def test_switch_on_trains_with_in_op_dropout(monkeypatch):
    """Training mode with attention dropout: the fused op draws its seed
    from ``rng.host``, so a seeded rng gives the same output and gradients,
    and the gradient reaches the qkv projection."""
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    calls = _Calls(monkeypatch)
    layer = _layer(dropout=0.3).train()
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(2, 40, 32)).astype(np.float32))
    outs, grads = [], []
    for seed in (4, 4, 5):
        layer.zero_grad()
        out = layer(x, DropoutRNG(seed, "cpu"))
        out.sum().backward()
        outs.append(out.detach())
        grads.append(layer.qkv.weight.grad.clone())
    assert calls.n == 3
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    assert not torch.equal(outs[0], outs[2])
    assert float(grads[0].abs().max()) > 0
    assert flash.launch_count("fwd_train") == 0


def test_switch_on_trains_under_cpu_bf16_autocast(monkeypatch):
    """A bf16 autocast train pass on the CPU with the switch on (E1/E3 with
    ``--device cpu --compute_dtype bfloat16``): the plain forward keeps its
    logits and lse in f32, so the backward takes them, and the output is
    the f32-logit function of the bf16 q, k and v."""
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    layer = _layer(dropout=0.1).train()
    x = torch.from_numpy(
        np.random.default_rng(2).normal(size=(2, 40, 32)).astype(np.float32))
    q, k, v = (torch.randn(2, 2, 40, 16).to(torch.bfloat16) for _ in range(3))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out, lse = mha.plain_fused_mha_forward(q, k, v)
        layer(x, DropoutRNG(0, "cpu")).float().sum().backward()
    assert lse.dtype == torch.float32
    want, want_lse = mha.plain_fused_mha_forward(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert float(layer.qkv.weight.grad.abs().max()) > 0
