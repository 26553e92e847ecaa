"""The port's band op on its training path, on the CPU: the plain training
forward and backward against JAX's lane-roll kernel (interpret mode) and
its VJP, the autograd Function, the dropout generator and its semantics,
and the window ops' dropout hooks. Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu.ops import window as jwin
from focused_attention_vit_tpu.ops.mhla_band_roll import (
    roll_banded_attention as jax_roll_banded_attention,
)
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import philox
from focused_attention_vit_tpu_torch.ops import window as twin

torch.set_num_threads(2)

# The forward in f32 on both sides, sums in other orders (as the eval band's
# tests). The backward sums up to W^2 products per key and runs the softmax
# backward: 2e-4, the tolerance JAX's own roll-band VJP test allows
# (tests/test_ops.py:468-471).
FWD_TOL = 1e-5
BWD_TOL = 2e-4

# Philox4x32-10 known answers (Random123's kat_vectors): counter, key, out.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
# The band's first words: rows=2, W=5, S=3, seed (7 << 32) | 12345, flattened
# [row, slot, query]. tests/test_torch_gpu.py holds the CUDA kernels to the
# same words.
GOLDEN_SEED = (7 << 32) | 12345
GOLDEN_WORDS = [
    3086511039, 245901908, 3177187213, 2069350973, 3103532112, 151919624,
    1397954912, 2271584979, 2479453186, 1299647223, 2188948469, 937884490,
    930448833, 3107885048, 2841791171, 693844396, 170832709, 1430873668,
    4027066890, 3703900889, 714957423, 882152769, 100387362, 27010507,
    3695691793, 3297131847, 3954828362, 3001140159, 1456036163, 1764380807,
]


def _arrays(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _py_philox(counter, key):
    """Philox4x32-10 on Python ints: the specification the tensor version
    is held to."""
    m = 0xFFFFFFFF
    c, k = list(counter), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & m, p1 & m,
             ((p0 >> 32) ^ c[3] ^ k[1]) & m, p0 & m]
    return tuple(c)


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = philox.philox4x32_10(
        [torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(x) for x in got) == want
    assert _py_philox(counter, key) == want


def test_band_keep_bits_golden_vector():
    rows, w, s = 2, 5, 3
    got = philox.band_keep_bits(rows, w, s, GOLDEN_SEED)
    assert got.flatten().tolist() == GOLDEN_WORDS
    key = (GOLDEN_SEED & 0xFFFFFFFF, GOLDEN_SEED >> 32)
    for row in range(rows):
        for o in range(w):
            for i in range(s):
                word = _py_philox((i, o // 4, row, 0), key)[o % 4]
                assert int(got[row, o, i]) == word


def test_keep_mask_rate_independence_determinism():
    rows, w, s, rate = 6, 7, 1000, 0.3
    keep = philox.band_keep_mask(rows, w, s, rate, seed=11)
    n = keep.numel()
    p = 1.0 - rate
    share = keep.double().mean().item()
    # 5 binomial standard deviations.
    assert abs(share - p) < 5 * (p * (1 - p) / n) ** 0.5
    for o in range(w):  # every slot at the rate
        m = rows * s
        assert abs(keep[:, o].double().mean().item() - p) < 5 * (
            p * (1 - p) / m) ** 0.5
    # Neighbouring slots, queries and rows are independent: the joint keep
    # share is p^2 (5 sigma of a Bernoulli(p^2) mean).
    for a, b in [(keep[:, :-1], keep[:, 1:]), (keep[..., :-1], keep[..., 1:]),
                 (keep[:-1], keep[1:])]:
        joint = (a & b).double().mean().item()
        assert abs(joint - p * p) < 5 * (p * p * (1 - p * p) / a.numel()) ** 0.5
    assert torch.equal(keep, philox.band_keep_mask(rows, w, s, rate, seed=11))
    other = philox.band_keep_mask(rows, w, s, rate, seed=12)
    assert (keep != other).double().mean().item() > 0.3
    assert philox.keep_threshold(0.0) == 0
    assert not philox.band_keep_mask(1, 3, 5, 0.999999999999, 3).any()


@pytest.mark.parametrize("s", [65, 577, 900])
@pytest.mark.parametrize("w", [1, 3, 4, 5, 7])
def test_plain_training_path_matches_jax_vjp(s, w):
    """The plain training forward and backward against ``jax.vjp`` of the
    JAX op, whose forward and backward are the Pallas kernels in interpret
    mode (900 spans two of its 640-lane tiles)."""
    q, k, v, g = _arrays(10 * s + w, (1, 2, 16, s))
    out, vjp = jax.vjp(lambda q, k, v: jax_roll_banded_attention(q, k, v, w),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    got_out, wts = band.plain_band_forward_train(tq, tk, tv, w)
    assert wts.shape == (2, w, s) and wts.dtype == torch.float32
    torch.testing.assert_close(wts.sum(1), torch.ones(2, s))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out),
                               atol=FWD_TOL, rtol=FWD_TOL)
    got = band.plain_band_backward(tq, tk, tv, tg, wts, w)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_TOL,
                                   rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.3, 7), (0.1, 2**40)])
@pytest.mark.parametrize("s,w", [(65, 7), (300, 4)])
def test_function_matches_autograd_through_plain(rate, seed, s, w):
    q, k, v, g = map(torch.from_numpy, _arrays(s + w, (2, 2, 16, s)))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = band.roll_banded_attention(*xs, w, (rate, seed))
    assert out.grad_fn is not None
    (out * g).sum().backward()
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    ref, _ = band.plain_band_forward_train(*ys, w, rate, seed)
    (ref * g).sum().backward()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-5, rtol=1e-5)


def test_band_output_carries_gradients():
    """The band op stays in the autograd graph: its output has a grad_fn
    and q, k and v all receive gradients; outside autograd it runs the
    lean forward and records nothing."""
    q, k, v = (t.requires_grad_() for t in map(
        torch.from_numpy, _arrays(3, (1, 2, 16, 40), 3)))
    out = band.roll_banded_attention(q, k, v, 7)
    assert out.grad_fn is not None
    out.square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and t.grad.abs().sum() > 0
    with torch.no_grad():
        lean = band.roll_banded_attention(q, k, v, 7)
    assert lean.grad_fn is None
    torch.testing.assert_close(lean, out.detach(), atol=0, rtol=0)


def test_strided_bf16_cotangent_is_accepted():
    """The model hands the band a transposed cotangent; in bf16 the
    backward equals the f32 one on the widened inputs, rounded once."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _arrays(5, (1, 2, 16, 70)))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = band.roll_banded_attention(*xs, 5)
    assert out.dtype == torch.bfloat16
    out.backward(g.transpose(2, 3).contiguous().transpose(2, 3))
    _, wts = band.plain_band_forward_train(q, k, v, 5)
    want = band.plain_band_backward(q.float(), k.float(), v.float(),
                                    g.float(), wts, 5)
    for x, y in zip(xs, want):
        assert x.grad.dtype == torch.bfloat16
        assert torch.equal(x.grad, y.to(torch.bfloat16))


@pytest.mark.parametrize("s", [300, 900])
def test_band_dropout_semantics(s):
    """The port of tests/test_ops.py:510: deterministic given a seed,
    seed-dependent, different from no dropout, finite; and the backward's
    regenerated mask is the forward's: ``out`` is linear in V with the
    dropped weights as coefficients, so the gradient in V equals the
    difference quotient."""
    w, rate = 7, 0.3
    q, k, v = map(torch.from_numpy, _arrays(s, (1, 2, 16, s), 3))
    o1 = band.roll_banded_attention(q, k, v, w, (rate, 7))
    o2 = band.roll_banded_attention(q, k, v, w, (rate, 7))
    o3 = band.roll_banded_attention(q, k, v, w, (rate, 8))
    det = band.roll_banded_attention(q, k, v, w, (0.0, None))
    assert torch.equal(o1, o2)
    assert (o1 - o3).abs().max() > 1e-6
    assert (o1 - det).abs().max() > 1e-6
    assert torch.isfinite(o1).all()
    assert torch.equal(band.roll_banded_attention(q, k, v, w, (rate, None)),
                       det)

    vg = v.clone().requires_grad_()
    band.roll_banded_attention(q, k, vg, w, (rate, 7)).sum().backward()
    eps = 0.5
    for lane in (10, s - 250):
        probe = torch.zeros_like(v)
        probe[0, 0, 3, lane] = eps
        fd = (band.roll_banded_attention(q, k, v + probe, w, (rate, 7)).sum()
              - band.roll_banded_attention(q, k, v, w, (rate, 7)).sum()) / eps
        np.testing.assert_allclose(float(vg.grad[0, 0, 3, lane]), float(fd),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", ["wts_shape", "wts_dtype", "g_shape",
                                  "g_dtype", "rate", "seed"])
def test_training_path_rejects(case):
    q, k, v, g = (torch.zeros(1, 2, 16, 40) for _ in range(4))
    wts = torch.zeros(2, 7, 40)
    rate, seed = 0.1, 3
    if case == "wts_shape":
        wts = torch.zeros(2, 5, 40)
    elif case == "wts_dtype":
        wts = wts.double()
    elif case == "g_shape":
        g = torch.zeros(1, 2, 16, 41)
    elif case == "g_dtype":
        g = g.to(torch.bfloat16)
    elif case == "rate":
        rate = 1.0
    elif case == "seed":
        seed = -1
    with pytest.raises(ValueError):
        band.band_backward(q, k, v, g, wts, 7, rate, seed)


def _weights_mask(shape, seed):
    return (np.random.default_rng(seed).random(shape) > 0.25).astype(
        np.float32) / 0.75


@pytest.mark.parametrize("name,s,w,layout", [
    ("_gather_windowed_attention", 12, 7, "bhsd"),
    ("_dense_band_attention", 40, 5, "bhsd"),
    ("_shift_banded_attention_ds", 70, 7, "bhds"),
])
def test_weights_transform_hooks_match_jax(name, s, w, layout):
    """The dropout hook of each window formulation, fed one fixed mask on
    both sides."""
    shape = (2, 2, s, 16) if layout == "bhsd" else (2, 2, 16, s)
    q, k, v = _arrays(s, shape, 3)
    wshape = {"_gather_windowed_attention": (2, 2, s, w),
              "_dense_band_attention": (2, 2, s, s),
              "_shift_banded_attention_ds": (2, 2, w, s)}[name]
    mask = _weights_mask(wshape, s)
    tmask = torch.from_numpy(mask)
    got = getattr(twin, name)(*map(torch.from_numpy, (q, k, v)), w,
                              weights_transform=lambda x: x * tmask)
    want = getattr(jwin, name)(*map(jnp.asarray, (q, k, v)), w,
                               weights_transform=lambda x: x * mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)
