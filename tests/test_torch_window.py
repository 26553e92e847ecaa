"""The PyTorch port's window ops and band op against the JAX package, on the
CPU, in f32. Inputs come from a numpy seed and go through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu.ops import window as jwin
from focused_attention_vit_tpu.ops.mhla_band_roll import (
    roll_banded_attention as jax_roll_banded_attention,
)
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import window as twin
from focused_attention_vit_tpu_torch.ops.patch_embed import extract_patches

torch.set_num_threads(2)

# f32 on both sides; the sums run in different orders.
TOL = 1e-5


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("s,w", [(10, 7), (10, 4), (5, 7), (3, 4), (6, 6),
                                 (1, 1), (197, 7), (64, 4), (33, 5)])
def test_window_index_table_matches_jax(s, w):
    np.testing.assert_array_equal(
        twin.window_index_table(s, w), jwin.window_index_table(s, w)
    )


@pytest.mark.parametrize("s,w", [(10, 7), (197, 5)])
def test_band_log_multiplicity_matches_jax(s, w):
    np.testing.assert_array_equal(
        twin._band_log_multiplicity(s, w), jwin._band_log_multiplicity(s, w)
    )


@pytest.mark.parametrize("name,s,w", [
    ("_gather_windowed_attention", 12, 7),
    ("_gather_windowed_attention", 9, 4),
    ("_gather_windowed_attention", 40, 7),
    ("_dense_band_attention", 40, 7),
    ("_dense_band_attention", 64, 4),
    ("_dense_band_attention", 197, 5),
])
def test_bhsd_formulation_matches_jax(name, s, w):
    q, k, v = _qkv(s * 10 + w, (2, 3, s, 16))
    got = getattr(twin, name)(*map(torch.from_numpy, (q, k, v)), w)
    want = getattr(jwin, name)(*map(jnp.asarray, (q, k, v)), w)
    _close(got, want)


@pytest.mark.parametrize("s,w", [(65, 7), (100, 4), (577, 3)])
def test_shift_band_ds_matches_jax(s, w):
    q, k, v = _qkv(s + w, (2, 2, 16, s))
    got = twin._shift_banded_attention_ds(*map(torch.from_numpy, (q, k, v)), w)
    want = jwin._shift_banded_attention_ds(*map(jnp.asarray, (q, k, v)), w)
    _close(got, want)


@pytest.mark.parametrize("s", [12, 197, 577])
def test_windowed_latent_attention_dispatch_matches_jax(s):
    """Gather, dense band and (S > 512) band op, each against the JAX op's
    own dispatch on the CPU."""
    w = 7
    q, k, v = _qkv(s, (1, 2, s, 16))
    got = twin.windowed_latent_attention(*map(torch.from_numpy, (q, k, v)), w)
    want = jwin.windowed_latent_attention(*map(jnp.asarray, (q, k, v)), w)
    _close(got, want)
    qt, kt, vt = (np.ascontiguousarray(x.transpose(0, 1, 3, 2))
                  for x in (q, k, v))
    got_ds = twin.windowed_latent_attention_ds(
        *map(torch.from_numpy, (qt, kt, vt)), w)
    want_ds = jwin.windowed_latent_attention_ds(
        *map(jnp.asarray, (qt, kt, vt)), w)
    _close(got_ds, want_ds)


@pytest.mark.parametrize("s", [65, 577])
@pytest.mark.parametrize("w", [1, 3, 5, 7])
def test_band_op_plain_matches_jax_roll_kernel(s, w):
    """The band op on CPU tensors (its plain version) against the Pallas
    lane-roll kernel, run in interpret mode as the JAX tests run it."""
    q, k, v = _qkv(100 * s + w, (2, 2, 16, s))
    before = band.launch_count()
    got = band.roll_banded_attention(*map(torch.from_numpy, (q, k, v)), w)
    want = jax_roll_banded_attention(*map(jnp.asarray, (q, k, v)), w)
    _close(got, want)
    assert band.launch_count() == before  # the CPU path launches nothing


def test_band_op_bf16_plain_rounds_once():
    """bf16 in, f32 inside, bf16 out: equal to the f32 computation on the
    widened inputs, rounded once."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(3, (1, 2, 16, 40)))
    got = band.roll_banded_attention(q, k, v, 5)
    want = band.plain_banded_attention(q.float(), k.float(), v.float(), 5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("case,err", [
    ("short", ValueError),
    ("wide", None),      # W = 17: computed on the CPU
    ("head_dim", None),  # d = 24: computed on the CPU
    ("strided", ValueError),
    ("dtype", TypeError),
    ("rank", ValueError),
])
def test_band_op_rejects(case, err):
    """What the band op refuses on a CPU tensor; a window past 16 and a head
    dim outside the kernels' old instantiations are computed there (as
    JAX's shift band computes them), equal to the plain version. Their
    rejection on a CUDA tensor (W > 129, d not a multiple of 8) is in
    tests/test_torch_gpu.py."""
    s, w, d = 40, 7, 16
    shape = (1, 2, d, s)
    dtype = torch.float32
    if case == "short":
        shape = (1, 2, d, 2 * w)
    elif case == "wide":
        w = 17
    elif case == "head_dim":
        shape = (1, 2, 24, s)
    elif case == "dtype":
        dtype = torch.float16
    elif case == "rank":
        shape = (2, d, s)
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    if case == "strided":
        q = torch.zeros(1, 2, s, d).transpose(2, 3)
    if err is None:
        q, k, v = map(torch.from_numpy, _qkv(w + shape[2], shape))
        before = band.launch_count()
        got = band.roll_banded_attention(q, k, v, w)
        assert band.launch_count() == before
        torch.testing.assert_close(
            got, band.plain_banded_attention(q, k, v, w), atol=0, rtol=0)
        return
    with pytest.raises(err):
        band.roll_banded_attention(q, k, v, w)


@pytest.mark.parametrize("hw,p", [(32, 4), (24, 8), (8, 2)])
def test_extract_patches_matches_jax(hw, p):
    from focused_attention_vit_tpu.ops.patch_embed import (
        extract_patches as jax_extract_patches,
    )

    x = np.random.default_rng(hw).normal(size=(2, hw, hw, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        extract_patches(torch.from_numpy(x), p).numpy(),
        np.asarray(jax_extract_patches(jnp.asarray(x), p)),
    )
