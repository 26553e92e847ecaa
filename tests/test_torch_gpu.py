"""The band, flash-attention, fused short-S attention and tile-band kernels
on an NVIDIA Hopper GPU against their plain versions, SLIC and the SPPP
models on the card, the checkpoint manager's async snapshot and restore
there, and the parallel layer at world size 1 (the wrappers, the
sequence-parallel band, a 1-stage pipeline).

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
# The band kernels' tiling (d, S, W): S at every residue mod 8 (a channel
# row's alignment within 16 bytes), S just below, at and above multiples of
# their 512-query tile, rows shorter than a tile (S = 2W + 1), W on both
# sides of the slot-cap dispatch (8 | 9) and at the cap, every head dim.
BWD_SHAPES = SHAPES + [
    (16, 1001, 7), (32, 1002, 7), (64, 1003, 7), (128, 1004, 7),
    (16, 1005, 8), (32, 1006, 9), (64, 1007, 16), (128, 3137, 7),
    (64, 511, 7), (64, 512, 7), (64, 513, 7), (32, 1023, 9), (32, 1025, 8),
    (64, 17, 8), (32, 19, 9), (128, 33, 16), (16, 3, 1),
    (64, 1000, 8), (64, 1000, 9), (64, 1000, 16), (16, 3137, 9),
]


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
@pytest.mark.parametrize("d,s,w", BWD_SHAPES)
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
@pytest.mark.parametrize("d,s,w", BWD_SHAPES)
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


@pytest.mark.parametrize("side", ["previous", "next"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), 3e38])
def test_band_backward_reads_no_other_row(cuda, d, bad, side):
    """Row 1 of three (S = 1001: every channel row starts at another offset
    within 16 bytes, so the backward's aligned copies take in bytes of the
    neighbouring rows) gets bit-identical dq, dk and dv when the previous or
    the next row's q, k, v, g and weights hold NaN, inf or 3e38."""
    s, w, rate, seed = 1001, 7, 0.1, 11
    q, k, v, g = _inputs(cuda, (1, 3, d, s), torch.bfloat16, n=4, seed=d)
    _, wts = band.band_forward_train(q, k, v, w, rate, seed)
    clean = band.band_backward(q, k, v, g, wts, w, rate, seed)
    other = 0 if side == "previous" else 2
    for x in (q, k, v, g):
        x[0, other] = bad
    wts[other] = bad
    poisoned = band.band_backward(q, k, v, g, wts, w, rate, seed)
    torch.cuda.synchronize()
    for got, want in zip(poisoned, clean):
        assert torch.isfinite(want[0, 1]).all()
        assert torch.equal(got[0, 1], want[0, 1])


@pytest.mark.parametrize("side", ["previous", "next"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), 3e38])
def test_band_forward_reads_no_other_row(cuda, d, bad, side):
    """Row 1 of three (S = 1001, as the backward's test) gets a
    bit-identical eval output, training output and saved weights when the
    previous or the next row's q, k and v hold NaN, inf or 3e38."""
    s, w, rate, seed = 1001, 7, 0.1, 11
    q, k, v = _inputs(cuda, (1, 3, d, s), torch.bfloat16, seed=d)

    def forward():
        out = band.roll_banded_attention(q, k, v, w)
        out_train, wts = band.band_forward_train(q, k, v, w, rate, seed)
        return out, out_train, wts.view(1, 3, w, s)

    clean = forward()
    other = 0 if side == "previous" else 2
    for x in (q, k, v):
        x[0, other] = bad
    poisoned = forward()
    torch.cuda.synchronize()
    for got, want in zip(poisoned, clean):
        assert torch.isfinite(want[0, 1]).all()
        assert torch.equal(got[0, 1], want[0, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,s,w", [(64, 3137, 7), (32, 1001, 9),
                                   (128, 513, 16), (16, 15, 7)])
def test_band_forward_eval_equals_training_at_rate_0(cuda, dtype, d, s, w):
    """At rate 0 the eval form and the training form of the forward give
    the same bits of out: the weights' write changes nothing of the sum."""
    q, k, v = _inputs(cuda, (2, 3, d, s), dtype, seed=s)
    out = band.roll_banded_attention(q, k, v, w)
    out_train, _ = band.band_forward_train(q, k, v, w, 0.0, None)
    torch.cuda.synchronize()
    assert torch.equal(out, out_train)


def test_band_backward_is_deterministic(cuda):
    """Two backward runs on the same inputs give the same bits (no
    atomics)."""
    w, rate, seed = 7, 0.1, 5
    q, k, v, g = _inputs(cuda, (2, 3, 64, 3137), torch.bfloat16, n=4)
    _, wts = band.band_forward_train(q, k, v, w, rate, seed)
    first = band.band_backward(q, k, v, g, wts, w, rate, seed)
    second = band.band_backward(q, k, v, g, wts, w, rate, seed)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
        x = torch.zeros(1, 2, 16, 300, device=cuda)
        band.band_forward_train(x, x, x, band.MAX_WINDOW + 1)
    with pytest.raises(ValueError, match="S > 2"):  # a row of S <= 2W
        x = torch.zeros(1, 2, 20, 14, device=cuda)
        band.band_forward_train(x, x, x, 7)
    with pytest.raises(TypeError):  # dtype
        x = q.half()
        band.band_backward(x, x, x, x, wts, 7)
    with pytest.raises(ValueError):  # saved weights on the wrong device
        band.band_backward(q, q, q, q, wts.cpu(), 7)


# The kernels' range: every head dim that is a multiple of 8 up to
# 256 and every window up to JAX's roll-band limit of 129; a short list of
# each, on both sides of the slot groups (16 | 17) and at the limit.
RANGE_HEAD_DIMS = (16, 24, 64, 80, 128, 256)
RANGE_WINDOWS = (7, 17, 64, 129)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", RANGE_WINDOWS)
@pytest.mark.parametrize("d", RANGE_HEAD_DIMS)
def test_band_kernels_across_head_dims_and_windows(cuda, d, w, dtype, rate):
    """Eval forward, training forward (output, saved weights, mask) and
    backward against their plain versions at the head dims and windows the
    kernels now take, S = 1001 (two tiles, every channel row at its own
    offset within 16 bytes): the tolerances of the grid above. The backward
    runs twice with the same bits."""
    s = 1001
    q, k, v, g = _inputs(cuda, (1, 2, d, s), dtype, n=4, seed=d + w)
    seed = 2**33 + 7 if rate else None
    band.reset_launch_count()
    with torch.no_grad():
        lean = band.roll_banded_attention(q, k, v, w, (rate, seed))
    out, wts = band.band_forward_train(q, k, v, w, rate, seed)
    grads = band.band_backward(q, k, v, g, wts, w, rate, seed)
    again = band.band_backward(q, k, v, g, wts, w, rate, seed)
    torch.cuda.synchronize()
    assert [band.launch_count(kind) for kind in band.LAUNCH_KINDS] == [1, 1, 2]
    ref_out, ref_wts = band.plain_band_forward_train(q, k, v, w, rate, seed)
    ref_grads = band.plain_band_backward(q, k, v, g, wts, w, rate, seed)
    _close(lean, ref_out, dtype, 1e-5)
    _close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(wts, ref_wts, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _close(got, want, dtype, 1e-4, bf16_atol=1e-4)


@pytest.mark.parametrize("w", RANGE_WINDOWS)
def test_band_wide_windows_at_the_row_edges(cuda, w):
    """Rows no longer than a few windows (S = 2W + 1, and one tile past a
    tile edge, S = 513): the edge rule fills whole slot groups from rows 0
    and S-1, and the backward folds them back."""
    for s in (2 * w + 1, 513):
        if s <= 2 * w:
            continue
        q, k, v, g = _inputs(cuda, (1, 2, 80, s), torch.float32, n=4, seed=s)
        out, wts = band.band_forward_train(q, k, v, w, 0.1, 3)
        grads = band.band_backward(q, k, v, g, wts, w, 0.1, 3)
        ref_out, ref_wts = band.plain_band_forward_train(q, k, v, w, 0.1, 3)
        ref_grads = band.plain_band_backward(q, k, v, g, wts, w, 0.1, 3)
        torch.cuda.synchronize()
        _close(out, ref_out, torch.float32, 1e-5)
        torch.testing.assert_close(wts, ref_wts, atol=1e-5, rtol=0)
        for got, want in zip(grads, ref_grads):
            _close(got, want, torch.float32, 1e-4)


def test_band_keep_bits_past_16_slots(cuda):
    """The kernels' dropout words at W = 17 and 129 are the plain
    generator's (groups of 4 slots a Philox draw)."""
    for w in (17, 129):
        got = band.keep_bits(3, w, 300, 2**40 + 9, cuda)
        assert torch.equal(got.cpu(), band.keep_bits(3, w, 300, 2**40 + 9,
                                                     "cpu"))


def test_band_kernels_reject_outside_their_range(cuda):
    """On a CUDA tensor the op raises past W = 129 (JAX's roll-band rule
    and message) and never runs the plain version instead; every head dim
    is inside the range (20 padded to 24, 264 in 33 chunks): the kernels
    launch."""
    band.reset_launch_count()
    x = torch.zeros(1, 2, 16, 300, device=cuda)
    with pytest.raises(ValueError, match="window_size <= 129"):
        band.roll_banded_attention(x, x, x, 130)
    assert [band.launch_count(kind) for kind in band.LAUNCH_KINDS] == [0, 0, 0]
    for d in (20, 264):
        x = torch.ones(1, 2, d, 40, device=cuda)
        out = band.roll_banded_attention(x, x, x, 7)
        torch.testing.assert_close(out, x, atol=1e-6, rtol=0)
        band.band_forward_train(x, x, x, 7)
    assert [band.launch_count(kind) for kind in band.LAUNCH_KINDS] == [2, 2, 0]


# --- flash attention ------------------------------------------------------------

# (d, S): one key, ragged last tiles on both axes, exact tiles, the ViT-B/16
# and ViT-B/4 lengths; then every head dim at the edges of the kernels' 64-
# and 128-row tiles (one short, exact, one past), and d = 128 at ViT-B/4's S.
FLASH_SHAPES = [(16, 1), (64, 1), (64, 127), (32, 129), (128, 197),
                (16, 512), (64, 577), (64, 1025), (64, 3137)]
FLASH_SHAPES += [(d, s) for d in (16, 32, 64, 128)
                 for s in (63, 64, 65, 128, 129, 255, 256, 257)
                 if (d, s) not in FLASH_SHAPES]
FLASH_SHAPES += [(128, 3137)]
# (d, S) whose bf16 gradients lie past 2 ulps on this test's inputs for the
# kernels before and after the Hopper redesign alike (dv 2.48 ulps for both,
# dq 3.00 before and 2.00 after, on an H100): at d = 16 and S = 129 a few
# weights are a large share of a sum and their bf16 rounding is not averaged
# away. Held to 3; every other case holds 2.
FLASH_LOOSE_CASES = frozenset({(16, 129)})


def _flash_close(got, want, dtype, f32_tol, max_ulps=2.0):
    """f32 within ``f32_tol``. bf16: the kernels round the softmax weights
    (and ds) to bf16 for the tensor cores, the plain versions keep f32; the
    results agree within ``max_ulps`` bf16 ulps of max(|plain|, a quarter
    of the tensor's largest entry)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=f32_tol, rtol=0)
        return
    got, want = got.float(), want.float()
    floor = max(0.25 * float(want.abs().max()), 2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(floor))) - 7)
    assert float(((got - want).abs() / ulp).max()) <= max_ulps


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
    max_ulps = 3.0 if (d, s) in FLASH_LOOSE_CASES else 2.0
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _flash_close(got, want, dtype, 1e-4, max_ulps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [65, 577])
@pytest.mark.parametrize("d", RANGE_HEAD_DIMS)
def test_flash_kernels_across_head_dims(cuda, d, s, dtype):
    """The head dims the kernels now take (padded to a tile width: 24 to
    32; 80, 256 exact) at a ragged tile (S = 65) and ViT-B/16's S = 577:
    the grid's tolerances; the backward runs twice with the same bits."""
    q, k, v, g = _inputs(cuda, (1, 3, s, d), dtype, n=4, seed=s + d)
    with torch.no_grad():
        lean = flash.flash_attention(q, k, v)
    out, lse = flash.flash_forward_train(q, k, v)
    grads = flash.flash_backward(q, k, v, out, lse, g)
    again = flash.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash.plain_flash_forward(q, k, v)
    ref_grads = flash.plain_flash_backward(q, k, v, out, lse, g)
    assert torch.equal(lean, out)
    _flash_close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _flash_close(got, want, dtype, 1e-4)


@pytest.mark.parametrize("d", [24, 80, 256])
def test_flash_padded_head_dims_read_no_other_head(cuda, d):
    """At a padded or new tile width the zero-filled columns past d and
    rows past S never take the next head's values: head 1 holds NaN, head
    0 comes out finite and equal to its plain version."""
    s = 65
    q, k, v, g = _inputs(cuda, (1, 2, s, d), torch.bfloat16, n=4, seed=d)
    for x in (q, k, v, g):
        x[0, 1] = float("nan")
    head = [x[:, :1].contiguous() for x in (q, k, v, g)]
    out, lse = flash.flash_forward_train(q, k, v)
    grads = flash.flash_backward(q, k, v, out, lse, g)
    ref_out, _ = flash.plain_flash_forward(*head[:3])
    ref_grads = flash.plain_flash_backward(*head[:3], out[:, :1].contiguous(),
                                           lse[:, :1].contiguous(), head[3])
    torch.cuda.synchronize()
    _flash_close(out[:, :1], ref_out, torch.bfloat16, 0.0)
    for got, want in zip(grads, ref_grads):
        assert torch.isfinite(got[:, :1]).all()
        _flash_close(got[:, :1], want, torch.bfloat16, 0.0)


def test_flash_kernels_reject_outside_their_range(cuda):
    """Only an empty head dim is outside the kernels' range now: d = 20
    (padded to 24) and 264 (the wide blocks) launch them."""
    flash.reset_launch_count()
    x = torch.zeros(1, 2, 40, 0, device=cuda)
    with pytest.raises(ValueError, match="d >= 1"):
        flash.flash_attention(x, x, x)
    assert [flash.launch_count(k) for k in flash.LAUNCH_KINDS] == [0, 0, 0]
    for d in (20, 264):
        x = torch.ones(1, 2, 40, d, device=cuda)
        torch.testing.assert_close(flash.flash_attention(x, x, x), x,
                                   atol=1e-6, rtol=0)
    assert [flash.launch_count(k) for k in flash.LAUNCH_KINDS] == [2, 0, 0]


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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), 3e38])
def test_flash_kernels_read_no_other_head(cuda, d, bad):
    """The q, k, v, g rows of head 1 hold huge or non-finite values; head 0
    (S = 65: a ragged last tile of every kernel) must come out finite and
    equal to the plain version on head 0 alone. The kernels' tensor maps
    zero-fill a tile past S instead of reading the next head's rows."""
    s = 65
    q, k, v, g = _inputs(cuda, (1, 2, s, d), torch.bfloat16, n=4, seed=d)
    for x in (q, k, v, g):
        x[0, 1] = bad
    head = [x[:, :1].contiguous() for x in (q, k, v, g)]
    out, lse = flash.flash_forward_train(q, k, v)
    with torch.no_grad():
        lean = flash.flash_attention(q, k, v)
    ref_out, ref_lse = flash.plain_flash_forward(*head[:3])
    grads = flash.flash_backward(q, k, v, out, lse, g)
    ref_grads = flash.plain_flash_backward(*head[:3], out[:, :1].contiguous(),
                                           lse[:, :1].contiguous(), head[3])
    torch.cuda.synchronize()
    for got in (out, lean, lse, *grads):
        assert torch.isfinite(got[:, :1]).all()
    _flash_close(out[:, :1], ref_out, torch.bfloat16, 0.0)
    torch.testing.assert_close(lse[:, :1], ref_lse, atol=1e-5, rtol=0)
    for got, want in zip(grads, ref_grads):
        _flash_close(got[:, :1], want, torch.bfloat16, 0.0)


def test_flash_launches_on_a_dense_vit_step(cuda):
    """One bf16 train step and one eval pass of dense ViT-B/4 cut to 2
    blocks launch the training forward and the backward once per block in
    the step and the eval forward once per block in the pass."""
    import numpy as np

    from focused_attention_vit_tpu_torch import train
    from focused_attention_vit_tpu_torch.models import VisionTransformer

    model = VisionTransformer(img_size=224, patch_size=4, num_classes=10,
                              depth=2,
                              generator=torch.Generator().manual_seed(0))
    state = train.create_train_state(model, train.make_adamw(1e-4))
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, size=2)
    flash.reset_launch_count()
    _, metrics = train.make_train_step(224, compute_dtype=torch.bfloat16)(
        state, u8, y, 0)
    torch.cuda.synchronize()
    assert [flash.launch_count(k) for k in flash.LAUNCH_KINDS] == [0, 2, 2]
    assert np.isfinite(float(metrics["loss_sum"]))
    flash.reset_launch_count()
    train.make_eval_step(224, compute_dtype=torch.bfloat16)(
        state, u8, y, np.ones(2, dtype=bool))
    torch.cuda.synchronize()
    assert [flash.launch_count(k) for k in flash.LAUNCH_KINDS] == [2, 0, 0]


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 40, 16, device=cuda)
    with pytest.raises(ValueError):  # shapes
        flash.flash_attention(q, q, q[:, :, :20].contiguous())
    with pytest.raises(ValueError):  # stride
        x = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash.flash_attention(x, x, x)
    with pytest.raises(ValueError):  # head dim
        x = torch.zeros(1, 2, 40, 0, device=cuda)
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
# and the op's longest sequence; 208, 255, 256 and 257 lie around the
# lengths where the dispatch moves from the whole-row kernels to the tiled
# ones (the backward's at d = 64 is 208, the forward's 256).
FUSED_SEQS = [1, 17, 128, 197, 208, 255, 256, 257, 577, 1024]


# (S, d, rate) whose worst bf16 gradient entry lies just past 2 ulps on an
# H100, held to 3; the other bf16 cases hold 2. The kernels round the
# weights (and ds) to bf16 for the tensor cores, as the function does, where
# the plain version run in f32 keeps them exact, and the worst of a case's
# 10^4 to 10^6 entries sits in the tail of that noise. Readings: 17/32/0.1
# dv 2.17, 17/128/0.1 dv 2.59 (whole-row kernels; the earlier tiled
# kernels read the same); 197/16/0.1 dq 2.27 and 256/32/0 dq 2.15 (the
# earlier tiled kernels 1.40 and 1.98); 257/16/0.1 dv 2.76, 257/32/0 dq
# 2.09, 257/64/0 dk 2.36 (1.88 before), 577/16/0 dk 2.03, 577/128/0 dv
# 2.07, 1024/128/0 dk 2.01 (tiled kernels on the flash blocks). Over 16
# input seeds the kernels before and after average the same on dq and dk
# (1.43-1.48 and 1.26-1.37 ulps) with the same worst cases. A fault breaks
# the rms bound first.
FUSED_LOOSE_CASES = frozenset({(17, 32, 0.1), (17, 128, 0.1), (197, 16, 0.1),
                               (256, 32, 0.0), (257, 16, 0.1), (257, 32, 0.0),
                               (257, 64, 0.0), (577, 16, 0.0), (577, 128, 0.0),
                               (1024, 128, 0.0)})


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


# The head dims of the whole-row kernels in both directions.
FUSED_ROW_HEAD_DIMS = (16, 32, 64, 128)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", FUSED_ROW_HEAD_DIMS)
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


# S around each tile width's whole-row limit (64 at D = 192 and 256, 192 at
# 80) and past it, the ViT-B/16 and ViT-H/14 lengths.
FUSED_RANGE_SEQS = [17, 65, 193, 197, 257]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", RANGE_HEAD_DIMS + (8, 192))
@pytest.mark.parametrize("s", FUSED_RANGE_SEQS)
def test_fused_kernels_across_head_dims(cuda, dtype, d, s, rate):
    """The fused kernels at head dims past the four of the grid above:
    padded tile widths (8 and 24 run at 16 and 32, zeros past d), 80, 192
    and 256, by the same rules (f32 forward within 1e-5, backward within
    1e-4; bf16 within 3 ulps entry by entry and by the rms rule), the
    eval forward equal to the training forward at rate 0, two backward
    runs bit-identical."""
    q, k, v, g = _inputs(cuda, (2, 3, s, d), dtype, n=4, seed=s + d)
    seed = 2**40 + s if rate else None
    out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    again = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    rq, rk, rv, rg = ((x.float() for x in (q, k, v, g)) if bf16
                      else (q, k, v, g))
    ref_out, ref_lse = fused.plain_fused_mha_forward(rq, rk, rv, rate, seed)
    ref_grads = fused.plain_fused_mha_backward(
        rq, rk, rv, rg, rate, seed, out=out.float() if bf16 else None)
    if rate == 0.0:
        with torch.no_grad():
            assert torch.equal(fused.fused_multi_head_attention(q, k, v), out)
    _fused_close(out, ref_out, dtype, 1e-5, 3.0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _fused_close(got, want, dtype, 1e-4, 3.0)
    if bf16:
        direct = fused.plain_fused_mha_backward(rq, rk, rv, rg, rate, seed)
        for got, want in zip(grads[:2], direct[:2]):
            _rms_close(got, want)


@pytest.mark.parametrize("s", [65, 197, 257])
@pytest.mark.parametrize("d", FUSED_ROW_HEAD_DIMS + (24, 80, 256))
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), 3e38])
def test_fused_kernels_read_no_other_head(cuda, d, s, bad):
    """The q, k, v, g rows of head 1 hold huge or non-finite values; head 0
    must come out finite and bit for bit as the same kernels give it on
    head 0 alone (the dropout stream is keyed on the row, which is 0 in
    both). S = 197 takes the whole-row kernels, whose tensor maps zero-fill
    a row's padding instead of reading the next head; S = 257 the tiled
    ones (S = 65 the whole-row kernel at every tile width, S = 197 past
    it at 192 and 256; d = 24 and 80 read tiles wider than the head)."""
    q, k, v, g = _inputs(cuda, (1, 2, s, d), torch.bfloat16, n=4, seed=d)
    for x in (q, k, v, g):
        x[0, 1] = bad
    head = [x[:, :1].contiguous() for x in (q, k, v, g)]
    seed = 2**40 + d
    out, lse = fused.fused_mha_forward_train(q, k, v, 0.1, seed)
    with torch.no_grad():
        lean = fused.fused_multi_head_attention(q, k, v)
        lean_head = fused.fused_multi_head_attention(*head[:3])
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, 0.1, seed)
    out_head, lse_head = fused.fused_mha_forward_train(*head[:3], 0.1, seed)
    grads_head = fused.fused_mha_backward(*head[:3], out_head, lse_head,
                                          head[3], 0.1, seed)
    torch.cuda.synchronize()
    for got, want in ((out, out_head), (lean, lean_head), (lse, lse_head),
                      *zip(grads, grads_head)):
        assert torch.isfinite(got[:, :1]).all()
        assert torch.equal(got[:, :1], want)


@pytest.mark.parametrize("s,kernels", [(197, 1), (577, 3)])
def test_fused_backward_kernels_a_call(cuda, s, kernels):
    """At ViT-B/16's S = 197 the backward is one kernel a call (the
    whole-row kernel); a row longer than a block holds takes the tiled
    kernels' three (delta, dk/dv, dq). Counted by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, g = _inputs(cuda, (2, 12, s, 64), torch.bfloat16, n=4)
    out, lse = fused.fused_mha_forward_train(q, k, v, 0.1, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused.fused_mha_backward(q, k, v, out, lse, g, 0.1, 5)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "fused" in e.name]
    assert len(names) == kernels, names


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
    with pytest.raises(ValueError, match="head dims"):  # JAX's d % 8 rule
        x = torch.zeros(1, 2, 40, 12, device=cuda)
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


# S for the tile band: 2W + 1 (None); rows of one 64-row step, where both
# edges fall in one step (20: below 2 * (W//2) + 1 at W = 33, 48: K7's one
# step, 64); 64 k + 1 (65, 3137: a last step of one query); K7's run of 8
# steps a block (496 rows) and one row past it; K6's run of 8 steps (512
# queries) ending inside a row (511), at its end (512) and one past it
# (513); the ViT-B/16 length; 1000.
TILE_LENGTHS = [None, 20, 48, 64, 65, 197, 496, 497, 511, 512, 513, 1000,
                3137]


# The ring kernels' head dims (hw <= 16) and windows.
TILE_RING_HEAD_DIMS = (16, 32, 64, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", TILE_RING_HEAD_DIMS)
@pytest.mark.parametrize("w", [1, 3, 4, 7, 15, 33])
@pytest.mark.parametrize("s", TILE_LENGTHS)
def test_tile_band_kernels_match_plain(cuda, dtype, d, w, s):
    """K6, K7 (with the edge fold, W = 1 folding nothing) and K8 against
    their plain versions: f32 forward within 1e-5, backward within 1e-4;
    two forward and two backward runs give the same bits; K8 equals K6's
    plain version too."""
    s = s or 2 * w + 1
    q, k, v, g = (x.view(6, s, d) for x in _inputs(cuda, (2, 3, s, d), dtype,
                                                   n=4, seed=s + w + d))
    before = [tile.launch_count(kind) for kind in tile.LAUNCH_KINDS]
    out = tile.tile_band_forward(q, k, v, w)
    out_again = tile.tile_band_forward(q, k, v, w)
    grads = tile.tile_band_backward(q, k, v, g, w)
    again = tile.tile_band_backward(q, k, v, g, w)
    out_b = tile.banded_attention_v4b(*(x.view(2, 3, s, d) for x in (q, k, v)),
                                      w)
    torch.cuda.synchronize()
    assert [tile.launch_count(kind) for kind in tile.LAUNCH_KINDS] == [
        before[0] + 2, before[1] + 2, before[2] + 1]
    assert torch.equal(out, out_again)
    ref = tile.plain_tile_band_forward(q, k, v, w)
    _tile_close(out, ref, dtype, 1e-5)
    _tile_close(out_b.view(6, s, d), ref, dtype, 1e-5)
    for got, rerun, want in zip(grads, again,
                                tile.plain_bwd_rule(q, k, v, g, w)):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _tile_close(got, want, dtype, 1e-4)


# The windows and head dims past W = 129 and d = 256 (where the wide and
# streamed kernels of earlier sources split; all run the wgmma kernels
# now): JAX's halo 80, 128 and 352,
# and the head dims 264, 384 (2 heads at D = 768) and 768 (1 head).
TILE_STREAM_WINDOWS = (131, 257, 683)
TILE_STREAM_HEAD_DIMS = (264, 384, 768)
# The grid past the ring kernels: every window of the range at every
# head dim of it, S = W + 1 (shorter than a band: a query near one edge
# also reads clamped positions past the other) and just past 2W (one or
# two 64-row steps with both edges folded), the ViT-B/16 and MHLA-H/14
# lengths, and one row of 3137.
TILE_RANGE_CASES = [(w, s) for w in RANGE_WINDOWS + TILE_STREAM_WINDOWS
                    for s in (w + 1, 2 * w + 1, 2 * w + 2, 197, 1370, 3137)
                    if s > 2 * w or s == w + 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", RANGE_HEAD_DIMS + (8, 192)
                         + TILE_STREAM_HEAD_DIMS)
@pytest.mark.parametrize("w,s", TILE_RANGE_CASES)
def test_tile_band_kernels_across_head_dims_and_windows(cuda, dtype, d, w,
                                                        s):
    """K6, K7 (with the edge fold) and K8 at JAX's halo (16, 32, 64 at W =
    7/17, 64 and 129; 80, 128, 352 at W = 131, 257, 683; the wgmma kernels
    past the ring kernels' range, as at d = 264, 384, 768) and the padded head dims against their
    plain versions by the grid's rules above; two runs of each
    bit-identical."""
    q, k, v, g = (x.view(6, s, d) for x in _inputs(cuda, (2, 3, s, d), dtype,
                                                   n=4, seed=s + w + d))
    before = [tile.launch_count(kind) for kind in tile.LAUNCH_KINDS]
    out = tile.tile_band_forward(q, k, v, w)
    out_again = tile.tile_band_forward(q, k, v, w)
    grads = tile.tile_band_backward(q, k, v, g, w)
    again = tile.tile_band_backward(q, k, v, g, w)
    out_b = tile.banded_attention_v4b(*(x.view(2, 3, s, d) for x in (q, k, v)),
                                      w)
    torch.cuda.synchronize()
    assert [tile.launch_count(kind) for kind in tile.LAUNCH_KINDS] == [
        before[0] + 2, before[1] + 2, before[2] + 1]
    assert torch.equal(out, out_again)
    ref = tile.plain_tile_band_forward(q, k, v, w)
    _tile_close(out, ref, dtype, 1e-5)
    _tile_close(out_b.view(6, s, d), ref, dtype, 1e-5)
    for got, rerun, want in zip(grads, again,
                                tile.plain_bwd_rule(q, k, v, g, w)):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _tile_close(got, want, dtype, 1e-4)


# The wgmma kernels' edges (csrc/tile_band_sm90.cuh): blocks of 64 queries,
# chunks of 64 keys from t - halo, d in 16-column steps of 64-column tiles.
# At W = 131, 257 and 683 (halo 80, 128, 352): S one short of and one past a
# multiple of 64 (the last block's queries past S, or one query in it),
# long enough that the first and last blocks' chunks cross each end of the
# line and lie wholly past it (K6's and K7's clamped rows); d = 24 and 264,
# off the grid of 16 (a last step of 8 columns and zeros, a last column
# tile of 8).
TILE_SM90_WINDOWS = (131, 257, 683)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [24, 264])
@pytest.mark.parametrize("w", TILE_SM90_WINDOWS)
@pytest.mark.parametrize("extra", [-1, 1])
def test_tile_band_wgmma_kernels_at_their_edges(cuda, dtype, d, w, extra):
    """K6, K7 (folded) and K8 on the wgmma kernels against their plain
    versions by the grid's rules, S = 64 m + extra past 2 halo + 64; two
    forward and two backward runs bit-identical."""
    halo = tile._halo(tile.DEFAULT_BLOCK, w // 2)
    s = 64 * ((2 * halo + 63) // 64 + 2) + extra
    q, k, v, g = (x.view(2, s, d) for x in _inputs(cuda, (1, 2, s, d), dtype,
                                                   n=4, seed=s + w + d))
    out = tile.tile_band_forward(q, k, v, w)
    out_again = tile.tile_band_forward(q, k, v, w)
    grads = tile.tile_band_backward(q, k, v, g, w)
    again = tile.tile_band_backward(q, k, v, g, w)
    out_b = tile.banded_attention_v4b(*(x.view(1, 2, s, d) for x in (q, k, v)),
                                      w)
    torch.cuda.synchronize()
    assert torch.equal(out, out_again)
    ref = tile.plain_tile_band_forward(q, k, v, w)
    _tile_close(out, ref, dtype, 1e-5)
    _tile_close(out_b.view(2, s, d), ref, dtype, 1e-5)
    for got, rerun, want in zip(grads, again,
                                tile.plain_bwd_rule(q, k, v, g, w)):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _tile_close(got, want, dtype, 1e-4)


# Head dims where the wgmma kernels' kept tiles no longer fit beside the
# ring: K7's Q and G from d = 776 (1024, and 1280: ViT-H's width in one head,
# which the CLI reaches through MHLA-H/14 with one head on the tile band),
# K6/K8's Q from d = 1480 (2048); each streams through the ring with K and V
# instead. At the model's W = 7 and at W = 257 (halo 128), S = 321: the
# first and last blocks' chunks cross each end of the line.
TILE_STREAMED_HEAD_DIMS = (1024, 1280, 2048)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [7, 257])
@pytest.mark.parametrize("d", TILE_STREAMED_HEAD_DIMS)
def test_tile_band_kernels_past_the_kept_tiles(cuda, dtype, d, w):
    """K6, K7 (folded) and K8 at head dims whose Q (and G) tiles do not fit
    in shared memory beside the ring, against their plain versions by the
    grid's rules; two forward and two backward runs bit-identical."""
    s = 321
    q, k, v, g = (x.view(2, s, d) for x in _inputs(cuda, (1, 2, s, d), dtype,
                                                   n=4, seed=s + w + d))
    tile.reset_launch_count()
    out = tile.tile_band_forward(q, k, v, w)
    out_again = tile.tile_band_forward(q, k, v, w)
    grads = tile.tile_band_backward(q, k, v, g, w)
    again = tile.tile_band_backward(q, k, v, g, w)
    out_b = tile.banded_attention_v4b(*(x.view(1, 2, s, d) for x in (q, k, v)),
                                      w)
    torch.cuda.synchronize()
    assert [tile.launch_count(k_) for k_ in tile.LAUNCH_KINDS] == [2, 2, 1]
    assert torch.equal(out, out_again)
    ref = tile.plain_tile_band_forward(q, k, v, w)
    _tile_close(out, ref, dtype, 1e-5)
    _tile_close(out_b.view(2, s, d), ref, dtype, 1e-5)
    for got, rerun, want in zip(grads, again,
                                tile.plain_bwd_rule(q, k, v, g, w)):
        assert got.dtype == dtype and torch.equal(got, rerun)
        _tile_close(got, want, dtype, 1e-4)


@pytest.mark.parametrize("w,d,s", [(257, 80, 1370), (683, 80, 1370),
                                   (129, 256, 300), (129, 80, 1370),
                                   (7, 768, 3137)])
def test_tile_band_backward_runs_are_bit_identical(cuda, w, d, s):
    """Three bf16 K7 runs give the same bits at MHLA-H/14's wide windows
    (W = 257, 683), at W = 129 (d = 80 and 256) and at d = 768: every sum in
    a fixed order, no atomics."""
    q, k, v, g = _inputs(cuda, (4, s, d), torch.bfloat16, n=4, seed=w + d)
    first = tile.tile_band_backward(q, k, v, g, w)
    for _ in range(2):
        again = tile.tile_band_backward(q, k, v, g, w)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("kernel", ["K6", "K7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poison", [float("nan"), float("inf"), 3e38])
@pytest.mark.parametrize("s", [48, 65, 497, 3137])
@pytest.mark.parametrize("w,d", [(7, 64), (7, 80), (129, 80), (65, 256),
                                 (257, 80), (7, 384)])
def test_tile_band_backward_reads_only_its_row(cuda, dtype, poison, s,
                                               kernel, w, d):
    """NaN, inf or 3e38 in the neighbouring (b*h) rows of q, k, v and g
    leave a row's K6 output, and its K7 dq, dk and dv, bit-identical: the
    kernels read no row but their own, the clamped halo included (the ring
    kernels at (7, 64), the wgmma ones at the other (W, d))."""
    q, k, v, g = _inputs(cuda, (3, s, d), dtype, n=4, seed=s)

    def run():
        if kernel == "K6":
            return [tile.tile_band_forward(q, k, v, w)]
        return tile.tile_band_backward(q, k, v, g, w)

    clean = [x[1].clone() for x in run()]
    for x in (q, k, v, g):
        x[0].fill_(poison)
        x[2].fill_(poison)
    got = run()
    torch.cuda.synchronize()
    for a, b in zip(got, clean):
        assert torch.equal(a[1], b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [32, 200, 256])
@pytest.mark.parametrize("w,d", [(7, 64), (7, 24), (17, 80), (64, 64),
                                 (129, 80), (129, 256), (257, 80), (7, 384)])
def test_tile_band_k8_matches_its_plain_version_on_tiles(cuda, t, dtype, w,
                                                         d):
    """K8 on three window tiles of t rows a (b*h) row (JAX's tile lengths
    at S <= 32, S = 197 and the 256-row cap, raised to JAX's 2 halo where
    the halo is longer; none a multiple of 64 but 256) against its plain
    version, and NaN, inf or 3e38 in the neighbouring tiles (the row's
    other tiles, the other rows) leave the middle tile of the middle row
    bit-identical: K8 reads its own window rows only."""
    halo = tile._halo(tile.DEFAULT_BLOCK, w // 2)
    t = max(t, 2 * halo)
    s = 3 * t - 3
    q, k, v = (x.view(3, s, d) for x in _inputs(cuda, (3, s, d), dtype,
                                                seed=t))
    ke, ve = (tile._window_tiles(x, t, halo, 3 * t) for x in (k, v))
    qt = tile._pad_seq(q, 0, 3).view(3, 3, t, d).contiguous()
    got = tile.window_tile_band(qt, ke, ve, w)
    _tile_close(got, tile.plain_window_tile_band(qt, ke, ve, w), dtype, 1e-5)
    clean = got[1, 1].clone()
    for poison in (float("nan"), float("inf"), 3e38):
        for x in (qt, ke, ve):
            x[[0, 2]] = poison
            x[1, [0, 2]] = poison
        again = tile.window_tile_band(qt, ke, ve, w)
        torch.cuda.synchronize()
        assert torch.equal(again[1, 1], clean), poison


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
    # A window past 129 and a head dim past 256 are taken (the wgmma
    # kernels): each call returns its shapes.
    x = torch.zeros(6, 300, 16, device=cuda)
    assert all(t.shape == x.shape
               for t in tile.tile_band_backward(x, x, x, x, 131))
    x = torch.zeros(6, 40, 264, device=cuda)
    assert tile.tile_band_forward(x, x, x, 7).shape == x.shape
    with pytest.raises(TypeError):  # dtype
        x = q.half()
        tile.tile_band_forward(x, x, x, 7)
    with pytest.raises(ValueError, match="halo"):  # JAX's halo at W = 7: 16
        qt = torch.zeros(6, 1, 64, 16, device=cuda)
        kt = torch.zeros(6, 1, 64 + 64, 16, device=cuda)
        tile.window_tile_band(qt, kt, kt, 7)


@pytest.mark.parametrize("name,env,op,want", [
    ("PretrainedMHLAViTExperiment",
     {"FAVIT_MHLA_IMPL": "shiftband", "FAVIT_USE_PALLAS_MHLA": "1"}, tile,
     {"fwd": 2 + 2, "bwd": 2, "fwd_b": 0}),
    ("PretrainedTraditionalViTExperiment", {"FAVIT_FUSED_MHA": "1"}, fused,
     {"fwd": 2, "fwd_train": 2, "bwd": 2}),
])
def test_pretrained_experiments_launch_their_kernels(cuda, monkeypatch,
                                                     tmp_path, name, env,
                                                     op, want):
    """E5 (MHLA-B/16, 2 blocks) under the tile-band opt-in launches K6 and
    K7, and E3 (ViT-B/16, 2 blocks) with the fused switch K3 and K4: one
    bf16 train step and one eval pass after loading the vit_b_16 fixture
    (the merge takes the first 2 of its 12 blocks)."""
    import numpy as np

    from focused_attention_vit_tpu_torch import experiments as exp
    from focused_attention_vit_tpu_torch.data.pretrained import write_fixture

    for key, val in env.items():
        monkeypatch.setenv(key, val)
    write_fixture(str(tmp_path / "weights"))
    e = getattr(exp, name)(
        img_size=224, patch_size=16, depth=2, batch_size=4,
        compute_dtype="bfloat16", subset_size=8,
        data_dir=str(tmp_path / "data"), results_dir=str(tmp_path / "res"),
        pretrained_cache_dir=str(tmp_path / "weights"))
    e.setup()
    assert e.pretrained_loaded
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, size=4)
    op.reset_launch_count()
    band.reset_launch_count()
    _, metrics = e.train_step(e.state, u8, y, 0)
    e.eval_step(e.state, u8, y, np.ones(4, dtype=bool))
    torch.cuda.synchronize()
    assert {k: op.launch_count(k) for k in op.LAUNCH_KINDS} == want
    assert band.launch_count() == 0
    assert np.isfinite(float(metrics["loss_sum"]))


# --- the SPPP slice: SLIC, pooling, the kernels at S = 17, the models -----------


def _slic_golden():
    import numpy as np
    from pathlib import Path

    fix = np.load(Path(__file__).resolve().parent / "fixtures"
                  / "slic_golden.npz")
    return torch.from_numpy(fix["images"]), int(fix["n_segments"])


@pytest.mark.parametrize("mode", [False, True, "host"])
def test_slic_on_the_card_equals_the_cpu(cuda, mode):
    """SLIC on the card gives the CPU port's labels on the committed 32^2
    golden images (connectivity off, the device pass, the host pass), also
    under bf16 autocast."""
    from focused_attention_vit_tpu_torch.ops.slic import slic_segment

    images, r = _slic_golden()
    want = slic_segment(images, r, enforce_connectivity=mode)
    got = slic_segment(images.to(cuda), r, enforce_connectivity=mode)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        auto = slic_segment(images.to(cuda), r, enforce_connectivity=mode)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want) and torch.equal(auto.cpu(), want)


@pytest.mark.parametrize("pooling", ["mean", "max", "attention"])
def test_segment_pool_in_bf16_on_the_card(cuda, pooling):
    from focused_attention_vit_tpu_torch.ops import segment_pool as sp

    gen = torch.Generator().manual_seed(1)
    emb = torch.randn(8, 196, 768, generator=gen).bfloat16()
    ids = torch.randint(0, 16, (8, 196), generator=gen)
    want = sp.segment_pool(emb, ids, 16, pooling)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got = sp.segment_pool(emb.to(cuda), ids.to(cuda), 16, pooling)
    assert got.dtype == torch.bfloat16
    # f32 sums in another order, each rounded once to bf16.
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               atol=2.0 ** -16, rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", TILE_RING_HEAD_DIMS)
@pytest.mark.parametrize("w", [4, 7])
def test_tile_band_kernels_at_17_tokens(cuda, dtype, d, w):
    """K6 and K7 at the SPPP models' S = 17 (a 16-query step and a 1-query
    step a row) over E6's B*h = 1536 rows."""
    q, k, v, g = _inputs(cuda, (1536, 17, d), dtype, n=4, seed=17 + d + w)
    out = tile.tile_band_forward(q, k, v, w)
    grads = tile.tile_band_backward(q, k, v, g, w)
    torch.cuda.synchronize()
    _tile_close(out, tile.plain_tile_band_forward(q, k, v, w), dtype, 1e-5)
    for got, want in zip(grads, tile.plain_bwd_rule(q, k, v, g, w)):
        _tile_close(got, want, dtype, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_band_kernels_at_17_tokens(cuda, dtype, d):
    """K1 (eval and training) and K2 at S = 17, W = 4 over B*h = 384: an
    S-minor channel row of 34 bf16 bytes, not 16-byte aligned."""
    q, k, v, g = _inputs(cuda, (32, 12, d, 17), dtype, n=4, seed=d)
    _close(band.roll_banded_attention(q, k, v, 4),
           band.plain_banded_attention(q, k, v, 4), dtype, 1e-5)
    out, wts = band.band_forward_train(q, k, v, 4, 0.0, None)
    ref_out, ref_wts = band.plain_band_forward_train(q, k, v, 4, 0.0, None)
    grads = band.band_backward(q, k, v, g, wts, 4, 0.0, None)
    ref_grads = band.plain_band_backward(q, k, v, g, wts, 4, 0.0, None)
    torch.cuda.synchronize()
    _close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(wts, ref_wts, atol=1e-5, rtol=0)
    for got, want in zip(grads, ref_grads):
        _close(got, want, dtype, 1e-4, bf16_atol=1e-4)


@pytest.mark.parametrize("name,env,op,kind", [
    ("SPPPViT", {}, None, None),
    ("SPPPViTMHLA", {"FAVIT_MHLA_IMPL": "shiftband",
                     "FAVIT_USE_PALLAS_MHLA": "1"}, tile, "fwd"),
    ("PretrainedSPPPViTWithMHLA", {"FAVIT_MHLA_IMPL": "roll"}, band, "fwd"),
])
def test_sppp_models_on_the_card_equal_the_cpu(cuda, monkeypatch, name, env,
                                               op, kind):
    """The three SPPP models (32^2, patch 4, D=64, 2 blocks) in f32 on the
    card against the same weights on the CPU, TF32 off; under their
    kernel's variables each block launches it once a forward."""
    import numpy as np

    from focused_attention_vit_tpu_torch import models

    for key, val in env.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    kw = dict(use_mhla=True) if name == "SPPPViTMHLA" else {}
    cpu = getattr(models, name)(img_size=32, patch_size=4, num_classes=10,
                                embed_dim=64, depth=2, num_heads=4,
                                **kw).eval()
    card = getattr(models, name)(img_size=32, patch_size=4, num_classes=10,
                                 embed_dim=64, depth=2, num_heads=4,
                                 device=cuda, **kw).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 32, 32, 3)).astype(np.float32))
    if op is not None:
        op.reset_launch_count()
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    if op is not None:
        assert op.launch_count(kind) == 2


# --- checkpoints on the card ------------------------------------------------------

def _ckpt_state(device, seed=0):
    from focused_attention_vit_tpu_torch import train
    from focused_attention_vit_tpu_torch.models import VisionTransformer

    model = VisionTransformer(img_size=32, patch_size=8, num_classes=10,
                              embed_dim=64, depth=2, num_heads=4,
                              generator=torch.Generator().manual_seed(seed))
    return train.create_train_state(model, train.make_adamw(1e-3),
                                    device=device)


def _ckpt_step(state, key):
    import numpy as np

    from focused_attention_vit_tpu_torch import train

    rng = np.random.default_rng(key)
    u8 = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 8)
    return train.make_train_step(32)(state, u8, y, key)[0]


def _host_copy(state):
    opt = state.tx.adamw.state_dict()["state"]
    return ({k: v.cpu().clone() for k, v in state.model.state_dict().items()},
            {(i, n): t.cpu().clone() for i, s in opt.items()
             for n, t in s.items()})


@pytest.mark.parametrize("hold", [False, True], ids=["free", "held"])
def test_async_snapshot_on_the_card_precedes_the_next_step(
        cuda, tmp_path, monkeypatch, hold):
    """``save()`` clones on the training stream and returns; the next step's
    in-place AdamW update is queued after the clones, so what is written is
    the state at the call, whether the background pull runs at once or is
    held until after the step."""
    import threading

    from focused_attention_vit_tpu_torch.train import checkpoint

    if hold:
        release = threading.Event()
        real = checkpoint._pull_to_host
        monkeypatch.setattr(checkpoint, "_pull_to_host",
                            lambda *a: (release.wait(30), real(*a))[1])
    state = _ckpt_step(_ckpt_state(cuda), 0)
    before = _host_copy(state)
    # Keep the stream busy, so that the clones are still queued when save()
    # returns and the next step is queued behind them.
    x = torch.randn(4096, 4096, device=cuda)
    for _ in range(20):
        x = x @ x / 64
    mngr = checkpoint.CheckpointManager(str(tmp_path), async_save=True)
    mngr.save(1, state)
    state = _ckpt_step(state, 1)
    if hold:
        torch.cuda.synchronize()
        release.set()
    mngr.close()
    fresh = _ckpt_state("cpu", seed=5)
    mngr.restore(fresh)
    got = _host_copy(fresh)
    after = _host_copy(state)
    for k, v in before[0].items():
        assert torch.equal(got[0][k], v), k
    for k, v in before[1].items():
        assert torch.equal(got[1][k], v), k
    assert not torch.equal(after[0]["head.weight"], before[0]["head.weight"])


def test_restore_onto_the_card(cuda, tmp_path):
    """A checkpoint saved from the CPU restores into a state on the card:
    parameters and AdamW moments on the card and bit-equal, the step
    counters on the host as AdamW keeps them; the next step runs there."""
    from focused_attention_vit_tpu_torch.train import checkpoint

    state = _ckpt_step(_ckpt_state("cpu"), 0)
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    mngr.save(1, state)
    on_card = mngr.restore(_ckpt_state(cuda, seed=3))
    want, got = _host_copy(state), _host_copy(on_card)
    assert all(p.is_cuda for p in on_card.model.parameters())
    opt = on_card.tx.adamw.state_dict()["state"]
    assert all(s["exp_avg"].is_cuda and not s["step"].is_cuda
               for s in opt.values())
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert (on_card.step, on_card.tx.count) == (1, 1)
    stepped = _ckpt_step(on_card, 1)
    assert all(torch.isfinite(p).all() for p in stepped.model.parameters())


# --- the favit:: operators, a card artifact, remat's launches --------------


def _op_cases(cuda):
    """(op, args, plain version's output) at small shapes, bf16."""
    from focused_attention_vit_tpu_torch.ops import library

    q, k, v = _inputs(cuda, (2, 3, 64, 300), torch.bfloat16, seed=16)
    qt, kt, vt = (x.transpose(2, 3).contiguous() for x in (q, k, v))
    seed = 2**63 + 12345  # above int64: travels as two 32-bit halves
    lo, hi = seed & 0xFFFFFFFF, seed >> 32
    return [
        (library.band_fwd, (q, k, v, 7, 0.1, lo, hi),
         band.plain_band_forward_train(q, k, v, 7, 0.1, seed)[0]),
        (library.band_fwd_train, (q, k, v, 7, 0.1, lo, hi),
         band.plain_band_forward_train(q, k, v, 7, 0.1, seed)),
        (library.flash_fwd, (qt, kt, vt, 512),
         flash.plain_flash_forward(qt, kt, vt)[0]),
        (library.fused_mha_fwd, (qt, kt, vt, 0.1, lo, hi),
         fused.plain_fused_mha_forward(qt, kt, vt, 0.1, seed)[0]),
        (library.tile_band_fwd, tuple(x.reshape(6, 300, 64) for x in
                                      (qt, kt, vt)) + (7,),
         tile.plain_tile_band_forward(*(x.reshape(6, 300, 64) for x in
                                        (qt, kt, vt)), 7)),
    ]


def test_custom_ops_launch_their_kernels(cuda):
    """Each ``favit::`` op's CUDA implementation launches its kernel (the
    launch counted inside the op) and agrees with the plain version; its
    fake implementation gives the kernel output's shape, dtype and
    strides; a seed at or above 2**63 draws the plain version's mask."""
    for op, args, want in _op_cases(cuda):
        mods = (band, flash, fused, tile)
        for m in mods:
            m.reset_launch_count()
        got = op(*args)
        torch.cuda.synchronize()
        assert sum(m.launch_count(kind) for m in mods
                   for kind in m.LAUNCH_KINDS) == 1, op
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        # The op's plumbing, not the kernels' error bounds (the tests
        # above hold those): a few bf16 ulps.
        for g, w in pairs:
            torch.testing.assert_close(g.float(), w.float(), atol=2.0 ** -6,
                                       rtol=2.0 ** -6)
        torch.library.opcheck(op, args, test_utils=(
            "test_schema", "test_faketensor"))


def test_card_artifact_round_trip(cuda, tmp_path):
    """A 2-block MHLA ViT at S=577 exported on the card serves the live
    Predictor's probabilities bit for bit, K1 launched by the replayed
    program."""
    import numpy as np

    from focused_attention_vit_tpu_torch.export import (
        load_serving_artifact,
        save_serving_artifact,
    )
    from focused_attention_vit_tpu_torch.infer import Predictor
    from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA

    model = VisionTransformerMHLA(img_size=96, patch_size=4, num_classes=10,
                                  embed_dim=128, depth=2, num_heads=2,
                                  window_size=7)
    live = Predictor(model, img_size=96, device="cuda", batch_size=4)
    art = save_serving_artifact(live, str(tmp_path / "art"),
                                input_hw=(32, 32))
    exported = load_serving_artifact(art)
    images = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3),
                                               dtype=np.uint8)
    band.reset_launch_count()
    got = exported.predict_proba(images)
    assert band.launch_count("fwd") == 2 * 2
    np.testing.assert_array_equal(got, live.predict_proba(images))


@pytest.mark.parametrize("policy,fwd_per_block", [
    (None, 1), ("full", 2), ("band_weights", 1)])
def test_remat_band_launches(cuda, policy, fwd_per_block):
    """K1's training form launches once a block a step without remat,
    twice under full remat (the recompute) and once under
    ``band_weights``, whose policy saves its output; K2 once a block."""
    from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
    from focused_attention_vit_tpu_torch.models.layers import DropoutRNG

    kw = {} if policy is None else dict(remat=True, remat_policy=policy)
    model = VisionTransformerMHLA(img_size=96, patch_size=4, num_classes=10,
                                  embed_dim=128, depth=2, num_heads=2,
                                  attn_dropout=0.1, device="cuda",
                                  **kw).train()
    x = torch.randn(2, 96, 96, 3, device="cuda")
    band.reset_launch_count()
    model(x, DropoutRNG(3, "cuda")).square().sum().backward()
    torch.cuda.synchronize()
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [
        0, 2 * fwd_per_block, 2]


@pytest.mark.parametrize("wrapper", ["ddp", "fsdp", "tp"])
def test_world_one_wrappers_launch_the_band_kernels(cuda, tmp_path,
                                                    wrapper):
    """A world-1 NCCL group: DDP, FSDP2 and tensor parallelism at tp=1
    train an MHLA model at S=577 (the band kernels) with AdamW at the
    experiments' learning rate to the plain path's losses and parameters
    (f32, dropout off) and launch K1's training form and K2 once a block a
    step inside the wrapper."""
    import numpy as np
    import torch.distributed as dist

    from focused_attention_vit_tpu_torch import train
    from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
    from focused_attention_vit_tpu_torch.parallel import make_mesh, shard_state

    def fresh():
        model = VisionTransformerMHLA(
            img_size=96, patch_size=4, num_classes=10, embed_dim=128,
            depth=2, num_heads=2, generator=torch.Generator().manual_seed(1))
        return train.create_train_state(model, train.make_adamw(1e-4))

    rng = np.random.default_rng(0)
    data = [(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 10, 4)) for _ in range(2)]
    plain = fresh()
    step = train.make_train_step(96)
    want = [float(step(plain, x, y, i)[1]["loss_sum"])
            for i, (x, y) in enumerate(data)]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        state = shard_state(fresh(), mesh, fsdp=wrapper == "fsdp",
                            ddp=wrapper == "ddp",
                            tensor_parallel=wrapper == "tp")
        step = train.make_train_step(96, mesh=mesh)
        got = []
        for i, (x, y) in enumerate(data):
            band.reset_launch_count()
            got.append(float(step(state, x, y, i)[1]["loss_sum"]))
            torch.cuda.synchronize()
            assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [
                0, 2, 2]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        for n, p in plain.model.named_parameters():
            q = state.layout.params[n]
            q = q.full_tensor() if hasattr(q, "full_tensor") else q
            torch.testing.assert_close(q, p, atol=1e-5, rtol=0)
    finally:
        dist.destroy_process_group()


def test_masked_block_on_the_card(cuda):
    """An MHLA block at S=577 with a mask: all ones in bf16 equals the
    unmasked kernel path (K1) within the bf16 rule; a random mask in f32
    equals the CPU's plain masked shift band within 1e-4."""
    from focused_attention_vit_tpu_torch.models.layers import (
        MHLATransformerBlock,
    )

    block = MHLATransformerBlock(128, 2, 7).eval()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 577, 128, generator=gen)
    mask = (torch.rand(2, 577, 577, generator=gen) > 0.3).float()
    with torch.no_grad():
        want = block(x, mask)
        block.to(cuda)
        got = block(x.to(cuda), mask.to(cuda))
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
        block.to(torch.bfloat16)
        xb = x.to(cuda, torch.bfloat16)
        band.reset_launch_count()
        unmasked = block(xb)
        assert band.launch_count("fwd") == 1
        masked = block(xb, torch.ones(2, 577, 577, device=cuda))
        assert band.launch_count("fwd") == 1  # the mask takes no kernel
        _close(masked, unmasked, torch.bfloat16, None, bf16_atol=2.0 ** -5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_virtual_sequence_shards_at_mhla_b4_width(cuda, dtype):
    """The SP band of 4 virtual shards (``parallel/sequence.py``, plain on
    the card) at MHLA-B/4 width (h=12, d=64, S=3137, W=7; L=785, 3 pad
    rows) stitched together equals the plain shift band and K1's eval
    output (f32 1e-5, bf16 within 2 ulps), and in f32 its gradients
    through the exchange equal the plain band's within 1e-4."""
    from focused_attention_vit_tpu_torch.parallel import sequence

    q, k, v = _inputs(cuda, (2, 12, 3137, 64), dtype)
    with torch.no_grad():
        got = sequence.virtual_sp_windowed_attention(q, k, v, 7, 4)
        plain = window._shift_banded_attention(q, k, v, 7)
        k1 = band.roll_banded_attention(
            *(t.transpose(2, 3).contiguous() for t in (q, k, v)),
            7).transpose(2, 3)
    for ref in (plain, k1):
        _close(got, ref, dtype, 1e-5)
    if dtype == torch.float32:
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        g = torch.randn_like(q)
        a = torch.autograd.grad(
            sequence.virtual_sp_windowed_attention(q, k, v, 7, 4),
            (q, k, v), g)
        b = torch.autograd.grad(window._shift_banded_attention(q, k, v, 7),
                                (q, k, v), g)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=1e-4, rtol=0)


def test_one_stage_pipeline_at_mhla_b4_width(cuda, tmp_path):
    """GPipe over a 1-stage ``stage`` dimension of a world-1 NCCL group:
    2 blocks at MHLA-B/4 width (S=3137, D=768, 12 heads), batch 4 in 2
    microbatches, f32, equals the plain step at microbatch 2 in losses and
    parameters within 1e-5, and launches K1's training form and K2 once a
    block a microbatch."""
    import numpy as np
    import torch.distributed as dist

    from focused_attention_vit_tpu_torch import train
    from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
    from focused_attention_vit_tpu_torch.parallel import make_mesh, shard_state

    def fresh(**kw):
        model = VisionTransformerMHLA(
            depth=2, num_classes=10,
            generator=torch.Generator().manual_seed(1), **kw)
        return train.create_train_state(model, train.make_adamw(1e-4))

    rng = np.random.default_rng(0)
    data = [(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 10, 4)) for _ in range(2)]
    plain = fresh()
    step = train.make_train_step(224, augment=False, microbatch=2)
    want = [float(step(plain, x, y, i)[1]["loss_sum"])
            for i, (x, y) in enumerate(data)]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, unit_dims=("stage",))
        state = shard_state(fresh(scan_layers=True, pp_mesh=mesh,
                                  pp_microbatches=2), mesh)
        step = train.make_train_step(224, augment=False, mesh=mesh)
        got = []
        for i, (x, y) in enumerate(data):
            band.reset_launch_count()
            got.append(float(step(state, x, y, i)[1]["loss_sum"]))
            torch.cuda.synchronize()
            assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [
                0, 4, 4]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        for n, p in plain.model.named_parameters():
            torch.testing.assert_close(state.layout.params[n], p, atol=1e-5,
                                       rtol=0)
    finally:
        dist.destroy_process_group()


# --- every head dim: off the grid of 8 (padded) and past 256 -------------------

# Off the grid of 8 (4 -> 8, 12 -> 16, 36 -> 40: the pad's zero columns) and
# past 256 (264 and 384: the wide blocks' ragged last chunk and slice; 768
# and 1280: ViT-B's and ViT-H's width in one head).
ANY_HEAD_DIMS = (4, 12, 36, 264, 384, 768, 1280)
# The wide blocks' 64-row tiles: one short, exact, one past, two tiles and
# a ragged one; then ViT-B/16's S.
WIDE_SEQS = (63, 64, 65, 129, 197)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", WIDE_SEQS)
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
def test_flash_kernels_at_any_head_dim(cuda, d, s, dtype):
    """K5's eval forward, training forward and backward at every kind of
    head dim and the wide blocks' tile edges, against the plain versions by
    the flash grid's rule (f32 within 1e-5 and 1e-4; bf16 within 2 ulps of
    max(|plain|, a quarter of the largest entry)); the eval and training
    outputs bit-equal; the backward twice with the same bits; one launch a
    call."""
    q, k, v, g = _inputs(cuda, (1, 2, s, d), dtype, n=4, seed=s + d)
    flash.reset_launch_count()
    with torch.no_grad():
        lean = flash.flash_attention(q, k, v)
    out, lse = flash.flash_forward_train(q, k, v)
    grads = flash.flash_backward(q, k, v, out, lse, g)
    again = flash.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert [flash.launch_count(k_) for k_ in flash.LAUNCH_KINDS] == [1, 1, 2]
    ref_out, ref_lse = flash.plain_flash_forward(q, k, v)
    ref_grads = flash.plain_flash_backward(q, k, v, out, lse, g)
    assert torch.equal(lean, out) and out.shape == q.shape
    _flash_close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.shape == q.shape and torch.equal(got, rerun)
        _flash_close(got, want, dtype, 1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [65, 197, 257])
@pytest.mark.parametrize("d", [264, 384, 768, 1280])
def test_fused_kernels_past_256(cuda, d, s, dtype, rate):
    """K3 and K4 past d = 256, where no whole-row kernel holds a row and
    every S takes the wide blocks with the Philox mask: against the plain
    versions by the fused grid's loose rule (3 ulps entry by entry, as
    FUSED_LOOSE_CASES; the rms bound), the backward run twice with the same
    bits."""
    q, k, v, g = _inputs(cuda, (1, 2, s, d), dtype, n=4, seed=s + d)
    seed = 2**35 + 3 if rate else None
    rq, rk, rv, rg = (x.float() for x in (q, k, v, g))
    out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    again = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    torch.cuda.synchronize()
    ref_out, ref_lse = fused.plain_fused_mha_forward(rq, rk, rv, rate, seed)
    ref_grads = fused.plain_fused_mha_backward(
        rq, rk, rv, rg, rate, seed,
        out=out.float() if dtype == torch.bfloat16 else None)
    _fused_close(out, ref_out, dtype, 1e-5, ulps=3.0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert torch.equal(got, rerun)
        _fused_close(got, want, dtype, 1e-4, ulps=3.0)
        if dtype == torch.bfloat16:
            _rms_close(got, want)


# The wide blocks' slice plan at its edges (ops/flash_attention.wide_plan,
# with the small-grid rule off so that these small grids take the plans of
# the large ones): a column past and short of a warpgroup's share or of a
# slice (264 past 256; 392 and 520 past the 3- and 8-tile shares of 384 and
# 512; 776, 1032 and 2056 past 768, 1024 and 2048, 2056 streaming every
# kernel's own tiles), at S one short of, at and past a 64-row tile, at
# ViT-B/16's 197 and at ViT-H/14's 1370.
WIDE_EDGE_DIMS = (264, 392, 512, 520, 776, 1032, 2056)
WIDE_EDGE_SEQS = (63, 64, 65, 197, 1370)


@pytest.mark.parametrize("op", ["flash", "fused"])
@pytest.mark.parametrize("s", WIDE_EDGE_SEQS)
@pytest.mark.parametrize("d", WIDE_EDGE_DIMS)
def test_wide_blocks_at_the_plan_edges(cuda, monkeypatch, op, d, s):
    """K5 (eval and training forward, backward) and K3/K4 (dropout 0.1) in
    bf16 at the slice plan's edges, against the plain versions by their
    grids' rules (flash: 2 ulps; fused: 3 ulps and the rms bound); the
    eval output equal to the training one, the backward run twice with the
    same bits. The fused op's rows end at 1024: it takes S = 1024 for
    1370."""
    monkeypatch.setattr(flash, "CARD_SMS", 0)
    if op == "fused":
        s = min(s, fused.MAX_TILE_SEQ)
    q, k, v, g = _inputs(cuda, (1, 2, s, d), torch.bfloat16, n=4,
                         seed=s + d)
    if op == "flash":
        with torch.no_grad():
            lean = flash.flash_attention(q, k, v)
        out, lse = flash.flash_forward_train(q, k, v)
        grads = flash.flash_backward(q, k, v, out, lse, g)
        again = flash.flash_backward(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.plain_flash_forward(q, k, v)
        ref_grads = flash.plain_flash_backward(q, k, v, out, lse, g)
        assert torch.equal(lean, out)
        _flash_close(out, ref_out, torch.bfloat16, 0.0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
        for got, rerun, want in zip(grads, again, ref_grads):
            assert torch.equal(got, rerun)
            _flash_close(got, want, torch.bfloat16, 0.0)
        return
    out, lse = fused.fused_mha_forward_train(q, k, v, 0.1, 9)
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, 0.1, 9)
    again = fused.fused_mha_backward(q, k, v, out, lse, g, 0.1, 9)
    torch.cuda.synchronize()
    rq, rk, rv, rg = (x.float() for x in (q, k, v, g))
    ref_out, ref_lse = fused.plain_fused_mha_forward(rq, rk, rv, 0.1, 9)
    ref_grads = fused.plain_fused_mha_backward(rq, rk, rv, rg, 0.1, 9,
                                               out=out.float())
    _fused_close(out, ref_out, torch.bfloat16, 0.0, ulps=3.0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert torch.equal(got, rerun)
        _fused_close(got, want, torch.bfloat16, 0.0, ulps=3.0)
        _rms_close(got, want)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("op", ["flash", "fused"])
def test_wide_forms_launch_the_wide_kernels(cuda, monkeypatch, op, narrow):
    """At d = 768 each wide form (eval forward, training forward, backward)
    counts one launch of its op's counter and no other, at the full plan
    and at a small grid's narrowed one; and it runs the wide blocks: only
    they take the slice plan, so with the plan's arguments zeroed every
    form's launch fails."""
    if not narrow:
        monkeypatch.setattr(flash, "CARD_SMS", 0)
    m = flash if op == "flash" else fused
    q, k, v, g = _inputs(cuda, (2, 1, 197, 768), torch.bfloat16, n=4, seed=5)
    forms = {
        "fwd": lambda: (flash.flash_attention(q, k, v) if op == "flash"
                        else fused.fused_multi_head_attention(q, k, v)),
        "fwd_train": lambda: (flash.flash_forward_train(q, k, v)
                              if op == "flash" else
                              fused.fused_mha_forward_train(q, k, v, 0.1, 3)),
    }
    out, lse = forms["fwd_train"]()
    forms["bwd"] = lambda: (flash.flash_backward(q, k, v, out, lse, g)
                            if op == "flash" else
                            fused.fused_mha_backward(q, k, v, out, lse, g,
                                                     0.1, 3))
    for kind, fn in forms.items():
        m.reset_launch_count()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        assert [m.launch_count(k_) for k_ in m.LAUNCH_KINDS] == [
            int(kind == k_) for k_ in m.LAUNCH_KINDS]
    monkeypatch.setattr(m, "wide_args", lambda x, direction: [0] * (
        2 if direction == "fwd" else 4))
    for kind, fn in forms.items():
        with pytest.raises(RuntimeError, match="launch failed"):
            with torch.no_grad():
                fn()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,w", [(15, 7), (513, 7), (35, 17), (1001, 17)])
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
def test_band_kernels_at_any_head_dim(cuda, d, s, w, dtype, rate):
    """K1 (eval and training forms) and K2 at every kind of head dim, rows
    of 2W + 1 and one past a 512-query tile, W on both sides of the slot
    groups: against the plain versions by the head-dim grid's rule (bf16
    gradients within 2 ulps or 1e-4 absolute); the backward twice with the
    same bits."""
    q, k, v, g = _inputs(cuda, (1, 2, d, s), dtype, n=4, seed=d + s)
    seed = 2**33 + 7 if rate else None
    band.reset_launch_count()
    with torch.no_grad():
        lean = band.roll_banded_attention(q, k, v, w, (rate, seed))
    out, wts = band.band_forward_train(q, k, v, w, rate, seed)
    grads = band.band_backward(q, k, v, g, wts, w, rate, seed)
    again = band.band_backward(q, k, v, g, wts, w, rate, seed)
    torch.cuda.synchronize()
    assert [band.launch_count(kind) for kind in band.LAUNCH_KINDS] == [1, 1, 2]
    ref_out, ref_wts = band.plain_band_forward_train(q, k, v, w, rate, seed)
    ref_grads = band.plain_band_backward(q, k, v, g, wts, w, rate, seed)
    _close(lean, ref_out, dtype, 1e-5)
    _close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(wts, ref_wts, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.shape == q.shape and torch.equal(got, rerun)
        _close(got, want, dtype, 1e-4, bf16_atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,s", [(7, 65), (33, 500), (129, 300)])
@pytest.mark.parametrize("d", [4, 12, 36])
def test_tile_band_kernels_off_the_grid(cuda, d, w, s, dtype):
    """K6, K7 (folded) and K8 at head dims off the grid of 8, padded to it:
    against their plain versions by the tile band's rule (6 ulps and the
    rms bound in bf16)."""
    q, k, v, g = _inputs(cuda, (4, s, d), dtype, n=4, seed=d + w)
    tile.reset_launch_count()
    out = tile.tile_band_forward(q, k, v, w)
    grads = tile.tile_band_backward(q, k, v, g, w)
    out_b = tile.banded_attention_v4b(*(x.view(1, 4, s, d) for x in (q, k, v)),
                                      w).view(4, s, d)
    torch.cuda.synchronize()
    assert [tile.launch_count(k_) for k_ in tile.LAUNCH_KINDS] == [1, 1, 1]
    ref = tile.plain_tile_band_forward(q, k, v, w)
    _tile_close(out, ref, dtype, 1e-5)
    _tile_close(out_b, ref, dtype, 1e-5)
    for got, want in zip(grads, tile.plain_bwd_rule(q, k, v, g, w)):
        assert got.shape == q.shape
        _tile_close(got, want, dtype, 1e-4)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), 3e38])
@pytest.mark.parametrize("op", ["flash", "fused", "band"])
def test_wide_head_dims_read_no_other_head(cuda, op, bad):
    """At d = 384 (the wide blocks' ragged last slice and chunk; the band's
    48 chunks) the next head's rows hold NaN, inf or 3e38: head 0's output
    and gradients come out finite and equal to its plain version."""
    d, s = 384, 197
    shape = (1, 2, d, s) if op == "band" else (1, 2, s, d)
    q, k, v, g = _inputs(cuda, shape, torch.bfloat16, n=4, seed=11)
    for x in (q, k, v, g):
        x[0, 1] = bad
    head = [x[:, :1].contiguous() for x in (q, k, v, g)]
    if op == "flash":
        out, lse = flash.flash_forward_train(q, k, v)
        grads = flash.flash_backward(q, k, v, out, lse, g)
        ref_out, _ = flash.plain_flash_forward(*head[:3])
        ref_grads = flash.plain_flash_backward(
            *head[:3], out[:, :1].contiguous(), lse[:, :1].contiguous(),
            head[3])
    elif op == "fused":
        out, lse = fused.fused_mha_forward_train(q, k, v, 0.1, 5)
        grads = fused.fused_mha_backward(q, k, v, out, lse, g, 0.1, 5)
        hq, hk, hv, hg = (x.float() for x in head)
        ref_out, _ = fused.plain_fused_mha_forward(hq, hk, hv, 0.1, 5)
        ref_grads = fused.plain_fused_mha_backward(
            hq, hk, hv, hg, 0.1, 5, out=out[:, :1].float())
    else:
        out, wts = band.band_forward_train(q, k, v, 7, 0.1, 5)
        grads = band.band_backward(q, k, v, g, wts, 7, 0.1, 5)
        ref_out, _ = band.plain_band_forward_train(*head[:3], 7, 0.1, 5)
        ref_grads = band.plain_band_backward(
            *head, wts[:1].contiguous(), 7, 0.1, 5)
    torch.cuda.synchronize()
    close = _flash_close if op == "flash" else (
        lambda a, b, dt, tol: _fused_close(a, b, dt, tol, ulps=3.0)
        if op == "fused" else _close(a, b, dt, tol, bf16_atol=1e-4))
    assert torch.isfinite(out[:, :1]).all()
    close(out[:, :1], ref_out, torch.bfloat16, 0.0)
    for got, want in zip(grads, ref_grads):
        assert torch.isfinite(got[:, :1]).all()
        close(got[:, :1], want, torch.bfloat16, 1e-4)


@pytest.mark.parametrize("model,heads,patch,op", [
    ("mhla", 2, 4, "band"), ("mhla", 64, 4, "band"),
    ("vit", 1, 4, "flash"), ("vit", 64, 4, "flash"),
    ("vit", 2, 16, "fused"), ("vit", 3, 4, "flash"), ("vit", 4, 4, "flash"),
    ("vit", 3, 16, "fused")])
def test_head_count_paths_launch_their_kernels(cuda, monkeypatch, model,
                                               heads, patch, op):
    """A 2-block model at D = 768 with 1, 2, 3, 4 or 64 heads (d = 768,
    384, 256, 192, 12):
    one bf16 train step (attention dropout 0.1 where the op draws it) and
    one eval pass launch the op's training forward and backward once a
    block in the step and its eval forward once a block in the pass; the
    other attention ops launch nothing."""
    import numpy as np

    from focused_attention_vit_tpu_torch import train
    from focused_attention_vit_tpu_torch.models import (
        VisionTransformer,
        VisionTransformerMHLA,
    )

    ops = {"band": band, "flash": flash, "fused": fused}
    if op == "fused":
        monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    cls = VisionTransformerMHLA if model == "mhla" else VisionTransformer
    kw = {"attn_dropout": 0.1} if op in ("band", "fused") else {}
    net = cls(img_size=224, patch_size=patch, num_classes=10, embed_dim=768,
              depth=2, num_heads=heads,
              generator=torch.Generator().manual_seed(0), **kw)
    state = train.create_train_state(net, train.make_adamw(1e-4))
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, size=2)
    for m in ops.values():
        m.reset_launch_count()
    _, metrics = train.make_train_step(224, compute_dtype=torch.bfloat16)(
        state, u8, y, 0)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss_sum"]))
    want = {name: [0, 0, 0] for name in ops}
    want[op] = [0, 2, 2]
    assert {name: [m.launch_count(k) for k in m.LAUNCH_KINDS]
            for name, m in ops.items()} == want
    for m in ops.values():
        m.reset_launch_count()
    train.make_eval_step(224, compute_dtype=torch.bfloat16)(
        state, u8, y, np.ones(2, dtype=bool))
    torch.cuda.synchronize()
    want[op] = [2, 0, 0]
    assert {name: [m.launch_count(k) for k in m.LAUNCH_KINDS]
            for name, m in ops.items()} == want


# --- the blocks at the tile widths 192 and 256 (csrc/flash_block256.cuh) ------

# Head dims at those widths (136 and 200 with zero columns in the tiles, 192
# and 256 exact), at S one short of, at and one past the 64-key tile, at
# ViT-B/16's 197 and at ViT-H/14's 1370.
BLOCK256_DIMS = (136, 192, 200, 256)
BLOCK256_SEQS = (63, 64, 65, 197, 1370)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", BLOCK256_SEQS)
@pytest.mark.parametrize("d", BLOCK256_DIMS)
def test_flash_kernels_at_tile_widths_192_and_256(cuda, d, s, dtype):
    """K5's eval forward, training forward and backward on the blocks of
    the tile widths 192 and 256, against the plain versions by the flash
    grid's rule (f32 within 1e-5 and 1e-4; bf16 within 2 ulps of
    max(|plain|, a quarter of the largest entry)); the eval and training
    outputs bit-equal; the backward twice with the same bits; one launch
    a call."""
    q, k, v, g = _inputs(cuda, (1, 2, s, d), dtype, n=4, seed=s + d)
    flash.reset_launch_count()
    with torch.no_grad():
        lean = flash.flash_attention(q, k, v)
    out, lse = flash.flash_forward_train(q, k, v)
    grads = flash.flash_backward(q, k, v, out, lse, g)
    again = flash.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert [flash.launch_count(k_) for k_ in flash.LAUNCH_KINDS] == [1, 1, 2]
    ref_out, ref_lse = flash.plain_flash_forward(q, k, v)
    ref_grads = flash.plain_flash_backward(q, k, v, out, lse, g)
    assert torch.equal(lean, out)
    _flash_close(out, ref_out, dtype, 1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert got.shape == q.shape and torch.equal(got, rerun)
        _flash_close(got, want, dtype, 1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [65, 197, 577])
@pytest.mark.parametrize("d", [192, 256])
def test_fused_kernels_at_tile_widths_192_and_256(cuda, d, s, dtype, rate):
    """K3 and K4 past the whole-row kernel's 64 keys at the tile widths 192
    and 256, on the same blocks with the Philox mask: against the plain
    versions by the fused grid's loose rule (3 ulps entry by entry; the
    rms bound), the eval forward equal to the training one at rate 0, the
    backward run twice with the same bits."""
    q, k, v, g = _inputs(cuda, (1, 3, s, d), dtype, n=4, seed=s + d)
    seed = 2**36 + 5 if rate else None
    rq, rk, rv, rg = (x.float() for x in (q, k, v, g))
    out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    again = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    torch.cuda.synchronize()
    if rate == 0.0:
        with torch.no_grad():
            assert torch.equal(fused.fused_multi_head_attention(q, k, v), out)
    ref_out, ref_lse = fused.plain_fused_mha_forward(rq, rk, rv, rate, seed)
    ref_grads = fused.plain_fused_mha_backward(
        rq, rk, rv, rg, rate, seed,
        out=out.float() if dtype == torch.bfloat16 else None)
    _fused_close(out, ref_out, dtype, 1e-5, ulps=3.0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for got, rerun, want in zip(grads, again, ref_grads):
        assert torch.equal(got, rerun)
        _fused_close(got, want, dtype, 1e-4, ulps=3.0)
        if dtype == torch.bfloat16:
            _rms_close(got, want)


@pytest.mark.parametrize("op", ["flash", "fused"])
@pytest.mark.parametrize("d", [136, 192, 256])
def test_block256_forms_run_one_dkv_and_one_dq(cuda, op, d):
    """At the tile widths 192 and 256 (S = 197) a backward launches one dkv
    and one dq kernel of csrc/flash_block256.cuh (no dk-then-dv pair), as
    the library counts them where it launches each, and its op counts one
    backward; a training forward launches none of them. Past 256 the wide
    blocks run and these counts stay 0."""
    source = f"{op}_attention_bwd" if op == "flash" else "fused_mha_bwd"
    m = flash if op == "flash" else fused

    def forms(d):
        q, k, v, g = _inputs(cuda, (2, 3, 197, d), torch.bfloat16, n=4,
                             seed=d)
        if op == "flash":
            out, lse = flash.flash_forward_train(q, k, v)
            return lambda: flash.flash_backward(q, k, v, out, lse, g)
        out, lse = fused.fused_mha_forward_train(q, k, v, 0.1, 7)
        return lambda: fused.fused_mha_backward(q, k, v, out, lse, g, 0.1, 7)

    flash.block256_launches(source)  # zeroes what earlier calls counted
    backward = forms(d)
    torch.cuda.synchronize()
    assert flash.block256_launches(source) == {"dkv": 0, "dq": 0}
    m.reset_launch_count()
    backward()
    torch.cuda.synchronize()
    assert flash.block256_launches(source) == {"dkv": 1, "dq": 1}
    assert [m.launch_count(k_) for k_ in m.LAUNCH_KINDS] == [0, 0, 1]
    for _ in range(3):
        backward()
    torch.cuda.synchronize()
    assert flash.block256_launches(source) == {"dkv": 3, "dq": 3}
    forms(264)()
    torch.cuda.synchronize()
    assert flash.block256_launches(source) == {"dkv": 0, "dq": 0}
