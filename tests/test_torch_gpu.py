"""The band, flash-attention, fused short-S attention and tile-band kernels
on an NVIDIA Hopper GPU against their plain versions.

Marked ``gpu``: these skip where there is no CUDA device. On a machine with
the card and without JAX, run them with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``
(``--noconftest`` because ``tests/conftest.py`` imports JAX).
"""

import pytest
import torch

from focused_attention_vit_tpu_torch.ops import flash_attention as flash
from focused_attention_vit_tpu_torch.ops import mha_kernel as fused
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile
from focused_attention_vit_tpu_torch.ops import window

pytestmark = pytest.mark.gpu

# The band generator's first words (rows=2, W=5, S=3, this seed), flattened
# [row, slot, query]; tests/test_torch_band_train.py pins the plain version
# to the same words.
GOLDEN_SEED = (7 << 32) | 12345
GOLDEN_WORDS = [
    3086511039, 245901908, 3177187213, 2069350973, 3103532112, 151919624,
    1397954912, 2271584979, 2479453186, 1299647223, 2188948469, 937884490,
    930448833, 3107885048, 2841791171, 693844396, 170832709, 1430873668,
    4027066890, 3703900889, 714957423, 882152769, 100387362, 27010507,
    3695691793, 3297131847, 3954828362, 3001140159, 1456036163, 1764380807,
]
SHAPES = [(16, 15, 7), (64, 1000, 7), (32, 577, 4), (128, 200, 16),
          (64, 3137, 1), (64, 3137, 7)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability 9.0 (Hopper)")
    return torch.device("cuda")


def _inputs(cuda, shape, dtype, n=3, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, device=cuda, generator=gen).to(dtype)
            for _ in range(n)]


def _close(got, want, dtype, f32_tol, bf16_atol=2.0 ** -16):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=f32_tol, rtol=0)
    else:
        # Both sides compute in f32 from the same bf16 inputs and round
        # once: at most one bf16 ulp apart (2^-7 relative).
        torch.testing.assert_close(got.float(), want.float(), atol=bf16_atol,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,s,w", SHAPES)
def test_kernel_matches_plain(cuda, dtype, d, s, w):
    q, k, v = _inputs(cuda, (2, 3, d, s), dtype, seed=s)
    before = band.launch_count()
    got = band.roll_banded_attention(q, k, v, w)
    torch.cuda.synchronize()
    assert band.launch_count() == before + 1
    want = band.plain_banded_attention(q, k, v, w)
    _close(got, want, dtype, 1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,s,w", SHAPES)
def test_training_kernels_match_plain(cuda, dtype, d, s, w, rate):
    """The training forward (output, saved weights, in-kernel mask) and the
    backward against their plain versions on the same inputs. f32: the
    forward within 1e-5 as the eval kernel; the backward within 1e-4, for
    sums of up to W^2 terms and the softmax backward in other orders. bf16:
    the forward as the eval kernel; the backward's f32 sums differ by the
    same 1e-4 before the one rounding, which can exceed one ulp of a
    gradient that cancels to near 0, so its absolute bound is 1e-4."""
    q, k, v, g = _inputs(cuda, (2, 3, d, s), dtype, n=4, seed=s + w)
    seed = 2**33 + 5 if rate else None
    out, wts = band.band_forward_train(q, k, v, w, rate, seed)
    ref_out, ref_wts = band.plain_band_forward_train(q, k, v, w, rate, seed)
    grads = band.band_backward(q, k, v, g, wts, w, rate, seed)
    ref_grads = band.plain_band_backward(q, k, v, g, wts, w, rate, seed)
    torch.cuda.synchronize()
    _close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(wts, ref_wts, atol=1e-5, rtol=0)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == dtype
        _close(got, want, dtype, 1e-4, bf16_atol=1e-4)


def test_mask_equals_golden_words(cuda):
    bits = band.keep_bits(2, 5, 3, GOLDEN_SEED, cuda)
    assert bits.flatten().tolist() == GOLDEN_WORDS
    big = band.keep_bits(7, 7, 3137, 99, cuda)
    assert torch.equal(big.cpu(), band.keep_bits(7, 7, 3137, 99, "cpu"))


def test_launch_counters_and_gradients(cuda):
    """Each wrapper counts its own launches: the lean eval forward outside
    autograd, the training forward and the backward under it; and q, k, v
    receive gradients on the card."""
    band.reset_launch_count()
    q, k, v = (t.requires_grad_() for t in _inputs(cuda, (2, 2, 64, 600),
                                                   torch.float32))
    with torch.no_grad():
        band.roll_banded_attention(q, k, v, 7)
    out = band.roll_banded_attention(q, k, v, 7, (0.1, 3))
    assert out.grad_fn is not None
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert [band.launch_count(kind) for kind in band.LAUNCH_KINDS] == [1, 1, 1]
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 40, device=cuda)
    wts = torch.zeros(2, 7, 40, device=cuda)
    with pytest.raises(ValueError):  # layout
        band.roll_banded_attention(q, q, q[..., :20].contiguous(), 7)
    with pytest.raises(ValueError):  # stride
        band.band_forward_train(q.transpose(2, 3).contiguous().transpose(
            2, 3), q, q, 7)
    with pytest.raises(ValueError):  # window
        band.band_forward_train(q, q, q, band.MAX_WINDOW + 1)
    with pytest.raises(ValueError):  # head dim
        x = torch.zeros(1, 2, 24, 40, device=cuda)
        band.band_forward_train(x, x, x, 7)
    with pytest.raises(TypeError):  # dtype
        x = q.half()
        band.band_backward(x, x, x, x, wts, 7)
    with pytest.raises(ValueError):  # saved weights on the wrong device
        band.band_backward(q, q, q, q, wts.cpu(), 7)


# --- flash attention ------------------------------------------------------------

# (d, S): one key, ragged last tiles on both axes, exact tiles, the ViT-B/16
# and ViT-B/4 lengths.
FLASH_SHAPES = [(16, 1), (64, 1), (64, 127), (32, 129), (128, 197),
                (16, 512), (64, 577), (64, 1025), (64, 3137)]


def _flash_close(got, want, dtype, f32_tol):
    """f32 within ``f32_tol``. bf16: the kernels round the softmax weights
    (and ds) to bf16 for the tensor cores, the plain versions keep f32; the
    results agree within 2 bf16 ulps of max(|plain|, a quarter of the
    tensor's largest entry)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=f32_tol, rtol=0)
        return
    got, want = got.float(), want.float()
    floor = max(0.25 * float(want.abs().max()), 2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(floor))) - 7)
    assert float(((got - want).abs() / ulp).max()) <= 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,s", FLASH_SHAPES)
def test_flash_kernels_match_plain(cuda, dtype, d, s):
    """Eval forward, training forward with its log-sum-exp, and backward;
    f32 forward within 1e-5 and backward within 1e-4 (TF32 plays no part:
    the f32 kernels are scalar)."""
    q, k, v, g = _inputs(cuda, (2, 3, s, d), dtype, n=4, seed=s + d)
    before = [flash.launch_count(kind) for kind in flash.LAUNCH_KINDS]
    with torch.no_grad():
        lean = flash.flash_attention(q, k, v)
    out, lse = flash.flash_forward_train(q, k, v)
    grads = flash.flash_backward(q, k, v, out, lse, g)
    again = flash.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert [flash.launch_count(kind) for kind in flash.LAUNCH_KINDS] == [
        before[0] + 1, before[1] + 1, before[2] + 2]
    ref_out, ref_lse = flash.plain_flash_forward(q, k, v)
    ref_grads = flash.plain_flash_backward(q, k, v, out, lse, g)
    assert torch.equal(lean, out)
    _flash_close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _flash_close(got, want, dtype, 1e-4)


def test_flash_launch_counters_and_gradients(cuda):
    flash.reset_launch_count()
    q, k, v = (t.requires_grad_() for t in _inputs(cuda, (2, 2, 600, 64),
                                                   torch.bfloat16))
    with torch.no_grad():
        flash.flash_attention(q, k, v)
    out = flash.flash_attention(q, k, v)
    assert out.grad_fn is not None
    # A strided cotangent, as the model's head merge hands it back.
    out.transpose(1, 2).reshape(2, 600, 128).float().square().sum().backward()
    torch.cuda.synchronize()
    assert [flash.launch_count(kind) for kind in flash.LAUNCH_KINDS] == [
        1, 1, 1]
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 40, 16, device=cuda)
    with pytest.raises(ValueError):  # shapes
        flash.flash_attention(q, q, q[:, :, :20].contiguous())
    with pytest.raises(ValueError):  # stride
        x = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash.flash_attention(x, x, x)
    with pytest.raises(ValueError):  # head dim
        x = torch.zeros(1, 2, 40, 24, device=cuda)
        flash.flash_attention(x, x, x)
    with pytest.raises(TypeError):  # dtype
        x = q.half()
        flash.flash_attention(x, x, x)
    with pytest.raises(ValueError):  # alignment
        x = torch.zeros(1 * 2 * 40 * 16 + 2, device=cuda)[2:].view(1, 2, 40, 16)
        flash.flash_attention(x, x, x)
    lse = torch.zeros(1, 2, 40, device=cuda)
    with pytest.raises(ValueError):  # lse on the wrong device
        flash.flash_backward(q, q, q, q, lse.cpu(), q)


# --- fused short-S attention --------------------------------------------------

# One key, ragged last tiles on both axes, exact tiles, the ViT-B/16 length
# and the op's longest sequence.
FUSED_SEQS = [1, 17, 128, 197, 256, 577, 1024]


# (S, d, rate) whose worst bf16 gradient entry lies just past 2 ulps (2.01
# to 2.12 on an H100), held to 3; the other 51 bf16 cases hold 2. The kernels
# round the weights (and ds) to bf16 for the tensor cores where the plain
# version keeps f32, and the worst of a case's 10^4 to 10^6 entries sits in
# the tail of that noise. A fault breaks the rms bound first.
FUSED_LOOSE_CASES = frozenset({(17, 32, 0.1), (17, 128, 0.1), (577, 16, 0.0),
                               (577, 128, 0.0), (1024, 128, 0.0)})


def _fused_close(got, want, dtype, f32_tol, ulps=2.0):
    """f32 within ``f32_tol``. bf16 against the plain version run in f32 on
    the same bf16 values: within ``ulps`` bf16 ulps of max(|plain|, a
    quarter of the tensor's largest entry)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=f32_tol, rtol=0)
        return
    got, want = got.float(), want.float()
    floor = max(0.25 * float(want.abs().max()), 2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(floor))) - 7)
    worst = float(((got - want).abs() / ulp).max())
    assert worst <= ulps, f"{worst:.2f} bf16 ulps"


def _rms_close(got, want):
    """The error's rms within 2^-8 of the plain result's rms."""
    got, want = got.float(), want.float()
    rms = float((got - want).pow(2).mean().sqrt())
    assert rms <= 2.0 ** -8 * float(want.pow(2).mean().sqrt()) + 1e-6


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fused.HEAD_DIMS)
@pytest.mark.parametrize("s", FUSED_SEQS)
def test_fused_kernels_match_plain(cuda, dtype, d, s, rate):
    """Eval forward (rate 0), training forward with its log-sum-exp and the
    in-kernel mask, and backward; f32 forward within 1e-5 and backward
    within 1e-4 against the plain version's direct row sum, which shows
    that the kernel's rowsum(g * out) is the same number under dropout.
    The bf16 backward is held entry by entry to a reference that takes the
    row sum from the kernel's bf16 out, as the kernel does, and by its rms
    to the direct row sum (not at S = 1, where the true dq and dk are 0).
    Two backward runs give the same bits."""
    q, k, v, g = _inputs(cuda, (2, 3, s, d), dtype, n=4, seed=s + d)
    seed = 2**40 + s if rate else None
    before = [fused.launch_count(kind) for kind in fused.LAUNCH_KINDS]
    out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    again = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    torch.cuda.synchronize()
    assert [fused.launch_count(kind) for kind in fused.LAUNCH_KINDS] == [
        before[0], before[1] + 1, before[2] + 2]
    bf16 = dtype == torch.bfloat16
    rq, rk, rv, rg = ((x.float() for x in (q, k, v, g)) if bf16
                      else (q, k, v, g))
    ref_out, ref_lse = fused.plain_fused_mha_forward(rq, rk, rv, rate, seed)
    ref_grads = fused.plain_fused_mha_backward(
        rq, rk, rv, rg, rate, seed, out=out.float() if bf16 else None)
    if rate == 0.0:
        with torch.no_grad():
            lean = fused.fused_multi_head_attention(q, k, v)
        assert fused.launch_count("fwd") == before[0] + 1
        assert torch.equal(lean, out)
    ulps = 3.0 if (s, d, rate) in FUSED_LOOSE_CASES else 2.0
    _fused_close(out, ref_out, dtype, 1e-5, ulps)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _fused_close(got, want, dtype, 1e-4, ulps)
    if bf16 and s > 1:
        direct = fused.plain_fused_mha_backward(rq, rk, rv, rg, rate, seed)
        for got, want in zip(grads[:2], direct[:2]):
            _rms_close(got, want)


def test_fused_mask_equals_plain_generator(cuda):
    seed = (7 << 32) | 12345
    for rows, s in ((3, 1), (5, 37), (6, 197), (2, 1024)):
        got = fused.keep_bits(rows, s, seed, cuda)
        assert torch.equal(got.cpu(), fused.keep_bits(rows, s, seed, "cpu"))


def test_fused_launch_counters_and_gradients(cuda):
    fused.reset_launch_count()
    q, k, v = (t.requires_grad_() for t in _inputs(cuda, (2, 2, 197, 64),
                                                   torch.bfloat16))
    with torch.no_grad():
        fused.fused_multi_head_attention(q, k, v)
    out = fused.fused_multi_head_attention(q, k, v, dropout_rate=0.1,
                                           dropout_seed=3)
    assert out.grad_fn is not None
    # A strided cotangent, as the model's head merge hands it back.
    out.transpose(1, 2).reshape(2, 197, 128).float().square().sum().backward()
    torch.cuda.synchronize()
    assert [fused.launch_count(kind) for kind in fused.LAUNCH_KINDS] == [
        1, 1, 1]
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


def test_fused_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 40, 16, device=cuda)
    with pytest.raises(ValueError):  # shapes
        fused.fused_multi_head_attention(q, q, q[:, :, :20].contiguous())
    with pytest.raises(ValueError):  # stride
        x = q.transpose(2, 3).contiguous().transpose(2, 3)
        fused.fused_multi_head_attention(x, x, x)
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(1, 2, 40, 24, device=cuda)
        fused.fused_multi_head_attention(x, x, x)
    with pytest.raises(ValueError):  # longer than the op's range
        x = torch.zeros(1, 1, fused.MAX_TILE_SEQ + 1, 16, device=cuda)
        fused.fused_multi_head_attention(x, x, x)
    with pytest.raises(TypeError):  # dtype
        x = q.half()
        fused.fused_multi_head_attention(x, x, x)
    with pytest.raises(ValueError):  # dropout without a seed
        fused.fused_multi_head_attention(q, q, q, dropout_rate=0.1)
    lse = torch.zeros(1, 2, 40, device=cuda)
    with pytest.raises(ValueError):  # lse on the wrong device
        fused.fused_mha_backward(q, q, q, q, lse.cpu(), q)


# --- tile band (K6, K7, K8) -----------------------------------------------------


def _tile_close(got, want, dtype, f32_tol):
    """f32 within ``f32_tol``. bf16: both sides round the weights (and ds)
    to bf16, as JAX does, so an f32 difference of 1e-7 can round one weight
    the other way on one side; in a sum of 2*hw + 1 terms with a weight near
    1 that moves an entry by 2^-8 of an input (up to about 4.5): up to 4.5
    ulps of a quarter of the tensor's largest entry, plus 1 for the final
    rounding. So 6 ulps of max(|plain|, that quarter), and the error's rms
    within 2^-8 of the plain rms."""
    _fused_close(got, want, dtype, f32_tol, ulps=6.0)
    if dtype == torch.bfloat16:
        _rms_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", tile.HEAD_DIMS)
@pytest.mark.parametrize("w", [3, 4, 7, 15, 33])
@pytest.mark.parametrize("s", [None, 197, 1000, 3137])  # None: S = 2W + 1
def test_tile_band_kernels_match_plain(cuda, dtype, d, w, s):
    """K6, K7 (before the edge fold) and K8 against their plain versions:
    f32 forward within 1e-5, backward within 1e-4; two backward runs give
    the same bits; K8 equals K6's plain version too."""
    s = s or 2 * w + 1
    q, k, v, g = (x.view(6, s, d) for x in _inputs(cuda, (2, 3, s, d), dtype,
                                                   n=4, seed=s + w + d))
    before = [tile.launch_count(kind) for kind in tile.LAUNCH_KINDS]
    out = tile.tile_band_forward(q, k, v, w)
    grads = tile.tile_band_backward(q, k, v, g, w)
    again = tile.tile_band_backward(q, k, v, g, w)
    out_b = tile.banded_attention_v4b(*(x.view(2, 3, s, d) for x in (q, k, v)),
                                      w)
    torch.cuda.synchronize()
    assert [tile.launch_count(kind) for kind in tile.LAUNCH_KINDS] == [
        before[0] + 1, before[1] + 2, before[2] + 1]
    ref = tile.plain_tile_band_forward(q, k, v, w)
    _tile_close(out, ref, dtype, 1e-5)
    _tile_close(out_b.view(6, s, d), ref, dtype, 1e-5)
    for got, rerun, want in zip(grads, again,
                                tile.plain_tile_band_backward(q, k, v, g, w)):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _tile_close(got, want, dtype, 1e-4)


def test_tile_band_k8_matches_its_plain_version_on_tiles(cuda):
    q, k, v = _inputs(cuda, (2, 3, 197, 64), torch.float32, seed=8)
    t, halo = 200, tile.MAX_HALF_WINDOW
    ke, ve = (tile._window_tiles(x.view(6, 197, 64), t, halo, t)
              for x in (k, v))
    qt = tile._pad_seq(q.view(6, 197, 64), 0, 3).view(6, 1, t, 64)
    torch.testing.assert_close(
        tile.window_tile_band(qt, ke, ve, 7),
        tile.plain_window_tile_band(qt, ke, ve, 7), atol=1e-5, rtol=0)


def test_tile_band_composite_launches_and_gradients(cuda, monkeypatch):
    """With the two variables set, windowed_latent_attention on the card
    runs K6 (and K7 under autograd), equals the gather oracle at odd W in
    f32, and gives q, k, v finite gradients."""
    monkeypatch.setenv("FAVIT_MHLA_IMPL", "shiftband")
    monkeypatch.setenv("FAVIT_USE_PALLAS_MHLA", "1")
    tile.reset_launch_count()
    band.reset_launch_count()
    q, k, v = (t.requires_grad_() for t in _inputs(cuda, (2, 2, 600, 64),
                                                   torch.float32))
    with torch.no_grad():
        oracle = window._gather_windowed_attention(q, k, v, 7)
        torch.testing.assert_close(window.windowed_latent_attention(q, k, v, 7),
                                   oracle, atol=1e-5, rtol=0)
    out = window.windowed_latent_attention(q, k, v, 7)
    out.transpose(1, 2).square().sum().backward()
    torch.cuda.synchronize()
    assert [tile.launch_count(kind) for kind in tile.LAUNCH_KINDS] == [2, 1, 0]
    assert band.launch_count() == 0
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


def test_tile_band_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(6, 40, 16, device=cuda)
    with pytest.raises(ValueError):  # shapes
        tile.tile_band_forward(q, q, q[:, :20].contiguous(), 7)
    with pytest.raises(ValueError):  # stride
        x = q.transpose(1, 2).contiguous().transpose(1, 2)
        tile.tile_band_forward(x, x, x, 7)
    with pytest.raises(ValueError, match="window_size"):
        tile.tile_band_backward(q, q, q, q, tile.MAX_WINDOW + 1)
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(6, 40, 24, device=cuda)
        tile.tile_band_forward(x, x, x, 7)
    with pytest.raises(TypeError):  # dtype
        x = q.half()
        tile.tile_band_forward(x, x, x, 7)
    with pytest.raises(ValueError, match="halo"):  # K8 takes a halo of 16
        qt = torch.zeros(6, 1, 64, 16, device=cuda)
        kt = torch.zeros(6, 1, 64 + 64, 16, device=cuda)
        tile.window_tile_band(qt, kt, kt, 7)
