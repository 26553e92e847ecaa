"""The port's SPPP ops against the JAX package and the numpy SLIC oracle, on
the CPU: the positional encodings, the dominant superpixel, the three
poolings and the centroids (within 1e-6 in f32), the blur and the grid
seeds, SLIC's labels (bit for bit, connectivity off on the committed
golden images against JAX and ``tools/slic_numpy.py``; the device
connectivity pass against JAX on the golden images and on seeded fuzz at
16^2-32^2), the connected components against scipy, the host connectivity
library against the oracle and JAX's binding, the 224^2 host path against
the committed skimage-faithful golden, SLIC under bf16 autocast, and the
g++ build."""

import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.optimize import linear_sum_assignment

from focused_attention_vit_tpu.ops import native_connectivity as jnc
from focused_attention_vit_tpu.ops import posenc as jposenc
from focused_attention_vit_tpu.ops import (  # the package's re-exports
    dominant_superpixel_per_patch as jax_dominant,
    segment_pool as jax_segment_pool,
    superpixel_centroids as jax_centroids,
)
from focused_attention_vit_tpu.ops import slic as jslic
from focused_attention_vit_tpu_torch.ops import native_connectivity as tnc
from focused_attention_vit_tpu_torch.ops import posenc, segment_pool, slic
from focused_attention_vit_tpu_torch.utils import kernel_build
from tools.slic_numpy import _enforce_connectivity as oracle_connectivity
from tools.slic_numpy import slic_numpy

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
TOL = 1e-6


def _golden(name="slic_golden.npz"):
    fix = np.load(FIXTURES / name)
    return (fix["images"], fix["golden_labels"], int(fix["n_segments"]),
            float(fix["compactness"]), float(fix["sigma"]))


def _jax_slic(images, r, m, sigma, mode, n_iter=10):
    return np.asarray(jslic.slic_segment(jnp.asarray(images), r, m, sigma,
                                         n_iter, mode))


def _port_slic(images, r, m, sigma, mode, n_iter=10):
    return slic.slic_segment(torch.from_numpy(images), r, m, sigma, n_iter,
                             mode).numpy()


# --- encodings, pooling, centroids ---------------------------------------------


# At 197 positions the argument of sin reaches 196, whose f32 spacing is
# 2^-16: the two libraries' exp may round it one spacing apart.
@pytest.mark.parametrize("s,d,tol", [(12, 16, TOL), (17, 64, TOL),
                                     (197, 768, 2.0 ** -16)])
def test_sinusoidal_encoding_matches_jax(s, d, tol):
    want = np.asarray(jposenc.sinusoidal_positional_encoding(s, d))
    got = posenc.sinusoidal_positional_encoding(s, d).numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("r,s", [(16, 17), (5, 5)])  # cls prepended or not
def test_centroid_encoding_matches_jax(r, s):
    cents = np.random.default_rng(1).uniform(size=(2, r, 2)).astype(
        np.float32)
    want = np.asarray(jposenc.centroid_positional_encoding(
        jnp.asarray(cents), 64, s))
    got = posenc.centroid_positional_encoding(torch.from_numpy(cents), 64, s)
    assert got.shape == (2, s, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    if r < s:  # the class token's centroid is (0.5, 0.5)
        np.testing.assert_allclose(got[:, 0, :32].numpy(),
                                   np.sin(0.5 * np.exp(
                                       np.arange(32) * -np.log(1e4) / 32))[
                                       None].repeat(2, 0), atol=1e-6)


def _segments(seed, b=3, h=32, w=32, r=16):
    rng = np.random.default_rng(seed)
    # Blocky labels, some ids absent, so that patches have ties and some
    # segments own no patch.
    coarse = rng.integers(0, r - 3, size=(b, h // 2, w // 2))
    return np.repeat(np.repeat(coarse, 2, 1), 2, 2).astype(np.int32)


@pytest.mark.parametrize("patch", [4, 8])
def test_dominant_superpixel_matches_jax(patch):
    seg = _segments(2)
    want = np.stack([np.asarray(jax_dominant(
        jnp.asarray(m), patch, 16)) for m in seg])
    got = segment_pool.dominant_superpixel_per_patch(torch.from_numpy(seg),
                                                     patch, 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # One image: [H, W] in, [N] out, as JAX's.
    np.testing.assert_array_equal(
        segment_pool.dominant_superpixel_per_patch(
            torch.from_numpy(seg[0]), patch, 16).numpy(), want[0])


@pytest.mark.parametrize("pooling", ["mean", "max", "attention"])
def test_segment_pool_matches_jax(pooling):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(3, 64, 32)).astype(np.float32)
    ids = rng.integers(0, 13, size=(3, 64)).astype(np.int32)  # 13..15 empty
    want = np.asarray(jax_segment_pool(jnp.asarray(emb), jnp.asarray(ids),
                                         16, pooling))
    got = segment_pool.segment_pool(torch.from_numpy(emb),
                                    torch.from_numpy(ids), 16, pooling)
    assert got.shape == (3, 16, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert not got[:, 13:].any()  # segments that own no patch: zeros
    with pytest.raises(ValueError, match="pooling type"):
        segment_pool.segment_pool(torch.from_numpy(emb),
                                  torch.from_numpy(ids), 16, "median")


@pytest.mark.parametrize("pooling", ["mean", "max", "attention"])
def test_segment_pool_in_bf16_casts_back_as_jax(pooling):
    """bf16 embeddings: f32 products, the result cast back to bf16, the
    member counts in bf16, as JAX's einsums with preferred f32."""
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(2, 64, 32)).astype(np.float32)
    ids = rng.integers(0, 16, size=(2, 64)).astype(np.int32)
    want = np.asarray(jax_segment_pool(
        jnp.asarray(emb, jnp.bfloat16), jnp.asarray(ids), 16,
        pooling).astype(jnp.float32))
    got = segment_pool.segment_pool(torch.from_numpy(emb).bfloat16(),
                                    torch.from_numpy(ids), 16, pooling)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7,
                               rtol=2 ** -7)


def test_centroids_match_jax():
    seg = _segments(5, b=2, h=24, w=20)
    want = np.asarray(jax_centroids(jnp.asarray(seg), 16))
    got = segment_pool.superpixel_centroids(torch.from_numpy(seg), 16)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    absent = [s for s in range(16) if not (seg[0] == s).any()]
    assert absent and (got[0, absent] == 0.5).all()


# --- blur and seeds --------------------------------------------------------------


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 2.0])
def test_gaussian_blur_matches_jax(sigma):
    img = np.random.default_rng(6).normal(size=(2, 20, 13, 3)).astype(
        np.float32)
    want = np.asarray(jax.vmap(lambda x: jslic.gaussian_blur(x, sigma))(
        jnp.asarray(img)))
    got = slic.gaussian_blur(torch.from_numpy(img), sigma)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(slic._gaussian_kernel1d(sigma or 1.0),
                                  jslic._gaussian_kernel1d(sigma or 1.0))
    # scipy's own filter, whose 4-sigma truncation and edge mode it copies.
    if sigma:
        np.testing.assert_allclose(
            got.numpy()[0], ndimage.gaussian_filter(
                img[0].astype(np.float64), (sigma, sigma, 0)), atol=1e-5)


def test_gaussian_blur_casts_back():
    img = torch.randn(2, 16, 16, 3).bfloat16()
    out = slic.gaussian_blur(img, 1.0)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, slic.gaussian_blur(img.float(), 1.0).bfloat16(), atol=0, rtol=0)


@pytest.mark.parametrize("h,w,r", [
    (32, 32, 16), (224, 224, 16), (24, 40, 9),  # skimage's grid
    (17, 45, 16), (32, 32, 10), (13, 29, 7), (48, 12, 25),  # the fallback
])
def test_grid_seeds_match_jax(h, w, r):
    got = slic._grid_seeds(h, w, r)
    assert got.shape == (r, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jslic._grid_seeds(h, w, r))


# --- labels ----------------------------------------------------------------------


def test_connectivity_off_is_bit_identical_to_jax_and_the_oracle():
    images, _, r, m, sigma = _golden()
    got = _port_slic(images, r, m, sigma, False)
    assert got.dtype == np.int32 and got.shape == images.shape[:3]
    np.testing.assert_array_equal(got, _jax_slic(images, r, m, sigma, False))
    for i, image in enumerate(images):
        want = slic_numpy(image, n_segments=r, compactness=m, sigma=sigma,
                          enforce_connectivity=False)
        np.testing.assert_array_equal(got[i], want, err_msg=f"image {i}")


def test_device_connectivity_is_bit_identical_to_jax_on_the_golden():
    images, golden, r, m, sigma = _golden()
    got = _port_slic(images, r, m, sigma, True)
    np.testing.assert_array_equal(got, _jax_slic(images, r, m, sigma, True))
    # JAX's own bar against the skimage golden (tests/test_ops.py).
    scores = []
    for i in range(len(images)):
        g = _dominant_np(golden[i], 4)
        o = segment_pool.dominant_superpixel_per_patch(
            torch.from_numpy(got[i]), 4, r).numpy()
        cont = np.zeros((g.max() + 1, r))
        np.add.at(cont, (g, o), 1)
        ri, ci = linear_sum_assignment(-cont)
        scores.append(cont[ri, ci].sum() / g.size)
    assert np.mean(scores) >= 0.72 and np.min(scores) >= 0.60, scores


@pytest.mark.parametrize("case", range(8))
def test_device_connectivity_fuzz_matches_jax(case):
    rng = np.random.default_rng(4242 + case)
    h, w = (int(v) for v in rng.integers(16, 33, size=2))
    r = int(rng.choice([4, 9, 16, 25]))
    m = float(rng.choice([0.05, 0.1, 1.0, 10.0]))
    sigma = float(rng.choice([0.0, 1.0]))
    images = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    got = _port_slic(images, r, m, sigma, True)
    assert got.min() >= 0 and got.max() < r
    np.testing.assert_array_equal(got, _jax_slic(images, r, m, sigma, True),
                                  err_msg=f"h={h} w={w} R={r} m={m}")


def test_auto_picks_the_device_pass_up_to_64_squared(monkeypatch):
    calls = []
    monkeypatch.setattr(slic, "_host_connectivity",
                        lambda labels, r: calls.append("host") or labels)
    img = torch.randn(1, 64, 64, 3)
    torch.testing.assert_close(slic.slic_segment(img, 16),
                               slic.slic_segment(img, 16,
                                                 enforce_connectivity=True))
    assert calls == []
    slic.slic_segment(torch.randn(1, 64, 65, 3), 16, n_iter=1)
    assert calls == ["host"]
    with pytest.raises(ValueError, match="enforce_connectivity"):
        slic.slic_segment(img, 16, enforce_connectivity="on")


def _dominant_np(labels, p):
    h, w = labels.shape
    tiles = labels.reshape(h // p, p, w // p, p).transpose(0, 2, 1, 3)
    out = []
    for row in tiles.reshape(-1, p * p):
        vals, cnts = np.unique(row, return_counts=True)
        out.append(vals[np.argmax(cnts)])
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components_equal_scipy_partition(seed):
    seg = np.random.default_rng(seed).integers(0, 3, size=(2, 24, 30))
    comp = slic._connected_components(torch.from_numpy(seg)).numpy()
    want = np.asarray(jslic._connected_components(jnp.asarray(seg[0],
                                                              jnp.int32)))
    np.testing.assert_array_equal(comp[0], want)
    for i in range(2):
        expect = np.zeros_like(seg[i])
        nxt = 1
        for lab in np.unique(seg[i]):
            cc, n = ndimage.label(seg[i] == lab)
            for k in range(1, n + 1):
                expect[cc == k] = nxt
                nxt += 1
        pairs = set(zip(comp[i].ravel().tolist(), expect.ravel().tolist()))
        assert len(pairs) == len({a for a, _ in pairs}) == len(
            {b for _, b in pairs})
        # A component's id is its smallest flat index.
        flat = np.arange(seg[i].size).reshape(seg[i].shape)
        for c in np.unique(comp[i]):
            assert c == flat[comp[i] == c].min()


# --- the host library --------------------------------------------------------------


def test_host_library_matches_the_oracle_and_jax():
    rng = np.random.default_rng(7)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(8, 40, size=2))
        labels = rng.integers(0, 5, size=(h, w)).astype(np.int32)
        min_size = int(rng.integers(1, 12))
        got = tnc.enforce_connectivity_host(labels, min_size, 10 ** 6)
        np.testing.assert_array_equal(
            got, oracle_connectivity(labels.astype(np.int64), min_size))
    batch = rng.integers(0, 30, size=(5, 48, 40)).astype(np.int32)
    got = tnc.enforce_connectivity_host(batch, 4, 16, n_threads=3)
    assert got.min() >= 0 and got.max() < 16
    np.testing.assert_array_equal(
        got, jnc.enforce_connectivity_host(batch, 4, 16))
    for i in range(5):
        np.testing.assert_array_equal(
            got[i], tnc.enforce_connectivity_host(batch[i], 4, 16))


def test_host_mode_matches_jax():
    images = np.random.default_rng(8).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(_port_slic(images, 16, 0.1, 1.0, "host"),
                                  _jax_slic(images, 16, 0.1, 1.0, "host"))


def test_host_mode_at_224_against_the_skimage_golden():
    """JAX's thresholds (tests/test_ops.py): patch-dominant agreement at
    patch 16 under optimal matching >= 0.97, image 0 pixel-equal to the
    golden on >= 0.98 of its pixels. No JAX call."""
    images, golden, r, m, sigma = _golden("slic_golden_224.npz")
    got = _port_slic(images[:2], r, m, sigma, "auto")  # auto is host here
    scores = []
    for i in range(2):
        a, b = _dominant_np(golden[i], 16), _dominant_np(got[i], 16)
        n = int(max(a.max(), b.max())) + 1
        cont = np.zeros((n, n))
        np.add.at(cont, (a, b), 1)
        ri, ci = linear_sum_assignment(-cont)
        scores.append(cont[ri, ci].sum() / a.size)
    assert np.mean(scores) >= 0.97, scores
    assert (got[0] == golden[0]).mean() >= 0.98


# --- dtype and autocast ---------------------------------------------------------------


def test_slic_under_bf16_autocast_gives_the_f32_labels():
    images, _, r, m, sigma = _golden()
    x = torch.from_numpy(images)
    want = slic.slic_segment(x, r, m, sigma, enforce_connectivity=True)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = slic.slic_segment(x, r, m, sigma, enforce_connectivity=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # bf16 pixels are read as their f32 values.
    xb = x.bfloat16()
    torch.testing.assert_close(
        slic.slic_segment(xb, r, m, sigma, enforce_connectivity=False),
        slic.slic_segment(xb.float(), r, m, sigma,
                          enforce_connectivity=False), atol=0, rtol=0)


# --- the g++ build ---------------------------------------------------------------------


def test_native_build_writes_under_build_and_raises_without_gxx(monkeypatch):
    lib = kernel_build.build_native("connectivity")
    assert lib.is_file()
    assert lib.parent.parent == REPO / "build" / "native"
    assert lib.parent.name.startswith("connectivity-")
    assert "-O3" in (lib.parent / "build.log").read_text()
    monkeypatch.setattr(kernel_build, "NATIVE_BUILD_ROOT",
                        REPO / "build" / "native-test-absent")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(kernel_build.NativeBuildError, match="g\\+\\+ not found"):
        kernel_build.build_native("connectivity")
    assert not (REPO / "build" / "native-test-absent").exists()


def test_native_build_failure_names_the_cause(monkeypatch, tmp_path):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(kernel_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "NATIVE_BUILD_ROOT", tmp_path / "out")
    with pytest.raises(kernel_build.NativeBuildError, match="g\\+\\+ exited"):
        kernel_build.build_native("broken")
    assert os.listdir(tmp_path / "out")  # its build.log stays for the reader
