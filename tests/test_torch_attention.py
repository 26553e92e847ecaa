"""The port's dense attention ops against the JAX package, on the CPU, in
f32: the flash op (its plain versions, which are what a CPU tensor runs)
against JAX's ``_chunked_attention`` and its ``jax.grad``, the explicit
backward against autograd of the materialised form, the dispatch by
sequence length, and attention-weight dropout in query chunks. Inputs come
from a numpy seed and go to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from focused_attention_vit_tpu.ops import attention as jattn
from focused_attention_vit_tpu.ops.flash_attention import (
    _chunked_attention as jax_chunked_attention,
)
from focused_attention_vit_tpu_torch.ops import attention as attn
from focused_attention_vit_tpu_torch.ops import flash_attention as flash

torch.set_num_threads(2)

# f32 on both sides; the online softmax and the materialised softmax sum in
# different orders.
TOL = 1e-5
# (S, key chunk): chunks that divide S, that leave a ragged last chunk, and
# that exceed S.
SHAPES = [(1, 512), (127, 127), (127, 50), (513, 512), (513, 171),
          (1025, 512), (1025, 205)]


def _qkv(s, seed=0, d=16, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 3, s, d)).astype(np.float32)
            for _ in range(n)]


def _t(arrays, requires_grad=False):
    return [torch.from_numpy(a).requires_grad_(requires_grad) for a in arrays]


@pytest.mark.parametrize("s,chunk", SHAPES)
def test_flash_forward_matches_jax(s, chunk):
    arrays = _qkv(s)
    q, k, v = _t(arrays)
    got = flash.flash_attention(q, k, v, chunk=chunk).numpy()
    jq, jk, jv = map(jnp.asarray, arrays)
    np.testing.assert_allclose(
        got, np.asarray(jax_chunked_attention(jq, jk, jv, chunk=chunk)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jattn.scaled_dot_product_attention(jq, jk, jv)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        got, attn.scaled_dot_product_attention(q, k, v).numpy(), atol=TOL,
        rtol=0)


@pytest.mark.parametrize("s,chunk", SHAPES)
def test_flash_gradients_match_jax_grad(s, chunk):
    """Gradients of ``sum(out**2)`` through the autograd Function (the
    explicit plain backward on the CPU) against ``jax.grad`` through JAX's
    scan."""
    arrays = _qkv(s, seed=1)
    q, k, v = _t(arrays, requires_grad=True)
    (flash.flash_attention(q, k, v, chunk=chunk) ** 2).sum().backward()
    want = jax.grad(
        lambda *a: (jax_chunked_attention(*a, chunk=chunk) ** 2).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for name, t, w in zip("qkv", (q, k, v), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("s,chunk", SHAPES)
def test_plain_backward_matches_autograd_of_materialised(s, chunk):
    arrays = _qkv(s, seed=2, n=4)
    q, k, v = _t(arrays[:3], requires_grad=True)
    g = torch.from_numpy(arrays[3])
    want = torch.autograd.grad(attn.scaled_dot_product_attention(q, k, v),
                               (q, k, v), g)
    with torch.no_grad():
        out, lse = flash.plain_flash_forward(q, k, v, chunk)
        got = flash.plain_flash_backward(q, k, v, out, lse, g, chunk)
    logits = torch.matmul(q, k.transpose(-1, -2)) * 16 ** -0.5
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(logits, -1).detach().numpy(), atol=TOL,
        rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0,
                                   err_msg=name)


def test_flash_takes_the_function_only_under_autograd():
    q, k, v = _t(_qkv(40))
    assert flash.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    assert flash.flash_attention(q, k, v).grad_fn is not None
    with torch.no_grad():
        assert flash.flash_attention(q, k, v).grad_fn is None
    # Keys and values alone carry gradients too.
    q2, k2, v2 = _t(_qkv(40))
    v2.requires_grad_(True)
    flash.flash_attention(q2, k2, v2).sum().backward()
    assert v2.grad is not None and q2.grad is None


def test_flash_bf16_rounds_once():
    """bf16 inputs: f32 inside, one rounding of the output, and gradients in
    the inputs' dtype."""
    arrays = _qkv(130, seed=3)
    q, k, v = (t.bfloat16() for t in _t(arrays))
    out = flash.flash_attention(q, k, v, chunk=64)
    ref = attn.scaled_dot_product_attention(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.bfloat16()) or float(
        (out.float() - ref).abs().max()) <= 2 ** -8 * float(ref.abs().max())
    q.requires_grad_(True)
    flash.flash_attention(q, k, v).float().sum().backward()
    assert q.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["rank", "shapes", "dtype", "mixed",
                                  "strided", "empty"])
def test_flash_rejects(case):
    q, k, v = _t(_qkv(8))
    with pytest.raises((ValueError, TypeError)):
        if case == "rank":
            flash.flash_attention(q[0], k[0], v[0])
        elif case == "shapes":
            flash.flash_attention(q, k[:, :, :4], v[:, :, :4])
        elif case == "dtype":
            flash.flash_attention(q.double(), k.double(), v.double())
        elif case == "mixed":
            flash.flash_attention(q, k.bfloat16(), v)
        elif case == "strided":
            flash.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
        else:
            flash.flash_attention(q[:, :, :0], k[:, :, :0], v[:, :, :0])


def test_cpu_tensors_launch_no_flash_kernel():
    flash.reset_launch_count()
    q, k, v = _t(_qkv(600), requires_grad=True)
    attn.multi_head_attention(q, k, v).sum().backward()
    with torch.no_grad():
        attn.multi_head_attention(q, k, v)
    assert [flash.launch_count(kind) for kind in flash.LAUNCH_KINDS] == [
        0, 0, 0]


@pytest.mark.parametrize("s,use_flash,expect_flash", [
    (511, None, False), (512, None, True), (600, False, False),
    (40, True, True),
])
def test_multi_head_attention_dispatch(monkeypatch, s, use_flash,
                                       expect_flash):
    """S >= FLASH_MIN_SEQ_LEN takes the flash op on any device; True and
    False force either path; both agree with JAX's materialised form."""
    calls = []
    real = flash.flash_attention
    monkeypatch.setattr(
        flash, "flash_attention",
        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    arrays = _qkv(s, seed=4)
    # Strided head views, as the model's qkv split hands them over.
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _t(arrays))
    got = attn.multi_head_attention(q, k, v, use_flash=use_flash).numpy()
    assert bool(calls) == expect_flash
    assert attn.FLASH_MIN_SEQ_LEN == jattn.FLASH_MIN_SEQ_LEN == 512
    want = jattn.scaled_dot_product_attention(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["bool", "zero_one", "scale"])
def test_scaled_dot_product_attention_mask_and_scale(kind):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(9, seed=5)
    k, v = k[:, :, :7], v[:, :, :7]
    mask = rng.integers(0, 2, size=(2, 1, 9, 7))
    mask[..., 0] = 1  # no fully masked row
    kw, jkw = {}, {}
    if kind == "bool":
        kw, jkw = ({"mask": torch.from_numpy(mask.astype(bool))},
                   {"mask": jnp.asarray(mask.astype(bool))})
    elif kind == "zero_one":
        kw, jkw = ({"mask": torch.from_numpy(mask.astype(np.float32))},
                   {"mask": jnp.asarray(mask.astype(np.float32))})
    else:
        kw = jkw = {"scale": 0.3}
    got = attn.scaled_dot_product_attention(*_t([q, k, v]), **kw).numpy()
    want = jattn.scaled_dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                              **jkw)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_head_layout_helpers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    qkv = rng.normal(size=(2, 5, 72)).astype(np.float32)
    np.testing.assert_array_equal(
        attn.split_heads(torch.from_numpy(x), 4).numpy(),
        np.asarray(jattn.split_heads(jnp.asarray(x), 4)))
    heads = attn.split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(attn.merge_heads(heads).numpy(), x)
    for got, want in zip(attn.qkv_split(torch.from_numpy(qkv), 4),
                         jattn.qkv_split(jnp.asarray(qkv), 4)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- attention-weight dropout in query chunks --------------------------------


@pytest.mark.parametrize("s,chunk", [(40, 16), (600, 256), (513, 513)])
def test_q_chunked_rate_zero_is_dense(s, chunk):
    arrays = _qkv(s, seed=7)
    q, k, v = _t(arrays, requires_grad=True)
    out = flash.dropout_attention_q_chunked(q, k, v, 0.0, chunk=chunk)
    ref = attn.scaled_dot_product_attention(q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-6, rtol=0)
    got = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    want = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


def test_q_chunked_keeps_half_and_is_deterministic():
    """With q = 0 the weights are uniform and with v = 1 a row's output is
    its kept count over S * keep: the kept share over B*h*S*S draws lies
    within 3 sigma of 0.5. One seed gives one mask, another seed another."""
    b, h, s, d = 2, 2, 300, 8
    q = torch.zeros(b, h, s, d)
    k = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(0))
    v = torch.ones(b, h, s, d)

    def run(seed):
        return flash.dropout_attention_q_chunked(
            q, k, v, 0.5, torch.Generator().manual_seed(seed), chunk=128)

    out = run(1)
    kept = float(out[..., 0].mean()) * 0.5
    sigma = (0.25 / (b * h * s * s)) ** 0.5
    assert abs(kept - 0.5) < 3 * sigma
    assert torch.equal(out, run(1))
    assert not torch.equal(out, run(2))


def test_q_chunked_mean_over_seeds_is_dense():
    arrays = _qkv(40, seed=8, d=8)
    q, k, v = _t(arrays)
    ref = attn.scaled_dot_product_attention(q, k, v)
    gen = torch.Generator().manual_seed(0)
    n = 200
    mean = sum(flash.dropout_attention_q_chunked(q, k, v, 0.5, gen, chunk=16)
               for _ in range(n)) / n
    # One draw has std sqrt(sum_j w_j^2 v_j^2) ~ 0.2 at rate 0.5; the mean
    # of 200 draws 0.015; 5 sigma.
    assert float((mean - ref).abs().max()) < 0.08


def test_q_chunked_backward_recomputes_the_same_mask():
    """Checkpointed chunks redraw their mask from the saved seed: the
    gradient equals that of the same computation without checkpointing."""
    arrays = _qkv(90, seed=9, d=8)
    q, k, v = _t(arrays, requires_grad=True)
    out = flash.dropout_attention_q_chunked(
        q, k, v, 0.3, torch.Generator().manual_seed(5), chunk=32)
    got = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    seeds = torch.randint(0, 2**62, (3,),
                          generator=torch.Generator().manual_seed(5)).tolist()
    ref = torch.cat([
        flash._dropout_chunk(q[:, :, i * 32:(i + 1) * 32], k, v, 0.3, seed)
        for i, seed in enumerate(seeds)], dim=2)
    assert torch.equal(out, ref)
    want = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


class _LargestTensor(TorchDispatchMode):
    """Records the largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor):
                self.numel = max(self.numel, x.numel())
        return out


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_q_chunked_never_holds_s_by_s(rate):
    b, h, s, d, chunk = 1, 2, 1025, 8, 256
    arrays = [a[:b, :h] for a in _qkv(s, seed=10, d=d)]
    q, k, v = _t(arrays, requires_grad=True)
    with _LargestTensor() as spy:
        out = flash.dropout_attention_q_chunked(
            q, k, v, rate, torch.Generator().manual_seed(0), chunk=chunk)
        out.sum().backward()
    assert spy.numel <= b * h * chunk * s < b * h * s * s
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_q_chunked_rejects_bad_rate():
    q, k, v = _t(_qkv(8))
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            flash.dropout_attention_q_chunked(q, k, v, rate)
