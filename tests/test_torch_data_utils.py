"""The port's data and utility modules against the JAX package, on the CPU:
the native C++ prefetcher (the same batches as JAX's for the same seed,
resume's seed included; the uint8 refusal; close during iteration; a failed
build raises), E1 on both packages' default batch pipeline, the ImageNet
folder loader, ``--visualize``, patchify, and MHLA attention masks through
the band (values and gradients against JAX's ``_shift_banded_attention``
and ``windowed_latent_attention``). The JAX E1 runs once, in a module
fixture.
"""

import functools
import logging
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu import experiments as jexp
from focused_attention_vit_tpu.data import imagenet as jimagenet
from focused_attention_vit_tpu.data import native as jnative
from focused_attention_vit_tpu.experiments import base as jbase
from focused_attention_vit_tpu.ops import window as jwin
from focused_attention_vit_tpu.utils import patchify as jpatchify
from focused_attention_vit_tpu_torch import cli
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_to_state_dict,
)
from focused_attention_vit_tpu_torch.data import imagenet, native
from focused_attention_vit_tpu_torch.experiments import base
from focused_attention_vit_tpu_torch.models.layers import (
    DropoutRNG,
    MultiHeadLatentAttention,
)
from focused_attention_vit_tpu_torch.ops import window as twin
from focused_attention_vit_tpu_torch.train import loop
from focused_attention_vit_tpu_torch.utils import kernel_build, patchify, viz

torch.set_num_threads(2)

LOGIT_TOL, GRAD_TOL = 1e-4, 1e-5


def _cifar(root):
    """A tiny CIFAR-10 in the python format (5 training batches of 16, 16
    test images), which both packages' loaders read."""
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 16))}, f)
    return str(root)


def _image_folder(root, sizes=((9, 7), (12, 12), (5, 16))):
    """``train/`` and ``val/`` with two classes of PNGs of several sizes
    and modes (RGB, grey, RGBA), and a file that is not an image."""
    from PIL import Image

    rng = np.random.default_rng(3)
    for split in ("train", "val"):
        for cls in ("b_dog", "a_cat"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i, (h, w) in enumerate(sizes):
                mode, c = [("RGB", 3), ("L", 1), ("RGBA", 4)][i % 3]
                px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
                Image.fromarray(px[..., 0] if c == 1 else px, mode).save(
                    d / f"{i}.png")
            (d / "notes.txt").write_text("not an image")
    return str(root)


# --- the native prefetcher --------------------------------------------------------------


def _epochs(prefetcher, n=3):
    try:
        return [list(prefetcher.epoch_batches()) for _ in range(n)]
    finally:
        prefetcher.close()


@pytest.mark.parametrize("epoch_offset", [0, 2])
def test_prefetcher_batches_equal_jax(epoch_offset):
    """Three epochs of shuffled batches, for the seed the training loop
    gives a run resumed after ``epoch_offset`` epochs: the same batches in
    the same order as JAX's ``NativePrefetcher``, each epoch a new order."""
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (37, 4, 4, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 37)
    seed = 42 + 1_000_003 * epoch_offset
    got = _epochs(native.NativePrefetcher(u8, y, 8, seed=seed))
    want = _epochs(jnative.NativePrefetcher(u8, y, 8, seed=seed))
    assert [len(e) for e in got] == [4, 4, 4]  # the ragged 5 dropped
    for ge, we in zip(got, want):
        for (gx, gy), (wx, wy) in zip(ge, we, strict=True):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert gy.dtype == np.int32 and gx.shape == (8, 4, 4, 3)
    orders = [np.concatenate([gy for _, gy in e]) for e in got]
    assert not np.array_equal(orders[0], orders[1])


def test_prefetcher_refuses_other_than_uint8():
    with pytest.raises(TypeError, match="uint8"):
        native.NativePrefetcher(np.zeros((8, 2, 2, 3), np.float32),
                                np.zeros(8), 4)


def test_prefetcher_close_during_iteration_stops_it():
    u8 = np.arange(16 * 12, dtype=np.uint8).reshape(16, 2, 2, 3)
    pf = native.NativePrefetcher(u8, np.arange(16), 4, seed=1)
    it = pf.epoch_batches()
    x, y = next(it)
    assert x.shape == (4, 2, 2, 3)
    pf.close()
    assert list(it) == []  # no call into the freed C++ object
    pf.close()  # a second close is a no-op
    assert list(pf.epoch_batches()) == []


def test_failed_build_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """Where JAX falls back to the numpy iterator, a failed g++ build of
    ``native/batcher.cpp`` raises out of the training loop, naming it."""
    (tmp_path / "batcher.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(kernel_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "NATIVE_BUILD_ROOT", tmp_path / "out")
    monkeypatch.delitem(kernel_build._loaded, "native/batcher", raising=False)
    data = {"train_images": np.zeros((8, 2, 2, 3), np.uint8),
            "train_labels": np.zeros(8, np.int32)}
    with pytest.raises(kernel_build.NativeBuildError,
                       match="g\\+\\+ exited .* native/batcher.cpp"):
        loop.train_and_evaluate(None, None, None, data, epochs=1,
                                batch_size=4)


# --- E1 on both packages' default batch pipeline --------------------------------------

E1 = dict(img_size=16, patch_size=4, num_classes=10, embed_dim=32, depth=1,
          num_heads=2, batch_size=32, epochs=2, subset_size=64, dropout=0.0,
          detailed_metrics=False)


@pytest.fixture(scope="module")
def e1_runs(tmp_path_factory):
    """E1 in both packages on a tiny CIFAR-10, augmentation off in both
    (its random streams differ) and neither batch pipeline patched: JAX's
    run and its initial params, and the port's run from those params, with
    the log lines of both."""
    tmp = tmp_path_factory.mktemp("e1")
    cifar = _cifar(tmp / "data")
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    root = logging.getLogger()
    root.addHandler(handler)
    old_level = root.level
    root.setLevel(logging.INFO)
    init = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for module in (jbase, base):
                mp.setattr(module, "make_train_step", functools.partial(
                    module.make_train_step, augment=False))
            # Probes only measure; each is a compile on the JAX side.
            mp.setattr(jbase.ExperimentBase, "_memory_probe",
                       lambda self, backward: {"gpu_memory_peak_mb": 0.0})
            j = jexp.TraditionalViTExperiment(
                **E1, data_dir=cifar, results_dir=str(tmp / "jres"))
            j.setup()
            init["params"] = jax.tree.map(np.asarray, j.state.params)
            j.train()
            mp.setattr(exp.TraditionalViTExperiment, "build_params",
                       lambda self, model: model.load_state_dict(
                           flax_vit_to_state_dict(init["params"])))
            t = exp.TraditionalViTExperiment(
                **E1, device="cpu", data_dir=cifar,
                results_dir=str(tmp / "tres"))
            t.setup()
            t.train()
    finally:
        root.removeHandler(handler)
        root.setLevel(old_level)
    return j, t, records


def test_e1_default_pipelines_give_the_same_run(e1_runs):
    """Both packages' default runs draw their batches from the native C++
    prefetcher, in the same order: two epochs' losses and accuracies agree
    within 1e-4 (dropout 0, augmentation off)."""
    j, t, records = e1_runs
    assert records.count(
        "train batch pipeline: native C++ prefetcher") == 2
    jtr, ttr = j.metrics["training"], t.metrics["training"]
    for k in ("train_losses", "val_losses"):
        np.testing.assert_allclose(ttr[k], jtr[k], atol=1e-4, rtol=0)
    for k in ("train_accs", "val_accs"):
        np.testing.assert_allclose(ttr[k], jtr[k], atol=1e-4, rtol=0)
    assert t.state.step == 4


# --- ImageNet folders and --visualize --------------------------------------------------


@pytest.mark.parametrize("subset_size", [None, 4])
def test_imagenet_folder_equals_jax(tmp_path, subset_size):
    root = _image_folder(tmp_path / "imagenet")
    got = imagenet.load_imagenet_subset(root, base_size=8,
                                        subset_size=subset_size, seed=5)
    want = jimagenet.load_imagenet_subset(root, base_size=8,
                                          subset_size=subset_size, seed=5)
    assert got["class_names"] == want["class_names"] == ["a_cat", "b_dog"]
    assert got["num_classes"] == 2 and got["synthetic"] is False
    for k in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(got[k], want[k])
    n = 6 if subset_size is None else 4
    assert got["train_images"].shape == (n, 8, 8, 3)
    assert got["train_images"].dtype == np.uint8
    imgs, labels = imagenet.get_sample_batch(got, batch_size=2)
    np.testing.assert_array_equal(imgs, got["train_images"][:2])
    imgs, labels = imagenet.get_sample_batch(batch_size=3, img_size=5)
    want = jimagenet.get_sample_batch(batch_size=3, img_size=5)
    np.testing.assert_array_equal(imgs, want[0])
    np.testing.assert_array_equal(labels, want[1])


def test_imagenet_names_the_missing_folder_and_pillow(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nowhere")):
        imagenet.load_imagenet_subset(str(tmp_path / "nowhere"))
    root = _image_folder(tmp_path / "imagenet")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        imagenet.load_imagenet_subset(root)


def test_cli_runs_imagenet_and_writes_the_visualizations(tmp_path,
                                                         monkeypatch):
    """``--dataset imagenet --visualize`` through ``cli.main``: the
    ImageFolder tree under ``<data_dir>/imagenet`` trains E1 (its two
    classes set the head), and both PNGs land in ``results_dir`` (drawn
    from CIFAR-10, as in JAX)."""
    data = tmp_path / "data"
    _cifar(data)
    _image_folder(data / "imagenet")
    monkeypatch.chdir(tmp_path)
    e = cli.main(["--experiment", "traditional", "--device", "cpu",
                  "--dataset", "imagenet", "--visualize", "--img_size", "16",
                  "--patch_size", "4", "--embed_dim", "32", "--depth", "1",
                  "--num_heads", "2", "--batch_size", "4", "--epochs", "1",
                  "--data_dir", str(data), "--no_detailed_metrics"])
    assert e.num_classes == 2 and e.data["train_images"].shape[1:] == (
        64, 64, 3)
    results = tmp_path / "results"
    for name in ("sample_images.png", "sample_patches.png",
                 "exp1_traditional.csv"):
        assert (results / name).stat().st_size > 0, name
    assert (results / "sample_images.png").read_bytes()[:4] == b"\x89PNG"


def test_visualize_names_matplotlib_when_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.visualize_images(np.zeros((2, 4, 4, 3)),
                             save_path=str(tmp_path / "x.png"))


def test_visualize_returns_figures_without_a_path():
    fig = viz.visualize_patches(np.zeros((8, 8, 3)), 4)
    assert len(fig.axes) == 4


# --- patchify ------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("size,patch,channels", [(8, 4, 3), (12, 3, 1)])
def test_patchify_equals_jax_and_inverts(batched, size, patch, channels):
    rng = np.random.default_rng(size)
    shape = ((2,) if batched else ()) + (size, size, channels)
    x = rng.normal(size=shape).astype(np.float32)
    got = patchify.patchify_image(torch.from_numpy(x), patch)
    want = jpatchify.patchify_image(jnp.asarray(x), patch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = (size // patch) ** 2
    assert got.shape == ((2,) if batched else ()) + (n, patch * patch
                                                     * channels)
    back = patchify.unpatchify_image(got, size, patch, channels)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jpatchify.unpatchify_image(want, size, patch, channels)))


# --- MHLA attention masks through the band -----------------------------------------


def _qkv_mask(s, b=2, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    mask = (rng.random((b, s, s)) > 0.3).astype(np.float32)
    mask[0, 1] = 0.0  # a fully masked query: uniform weights, both sides
    g = rng.normal(size=(b, h, s, d)).astype(np.float32)
    return q, k, v, mask, g


def _both(fn_t, fn_j, q, k, v, mask, g):
    """Values and q/k/v gradients of ``<fn(q, k, v), g>`` on both sides."""
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn_t(tq, tk, tv, torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()

    def loss(a, b_, c, m):
        return jnp.sum(fn_j(a, b_, c, m) * g)

    # Jitted: JAX's eager dispatch of the band's unrolled slots is slow.
    args = tuple(jnp.asarray(a) for a in (q, k, v, mask))
    want = jax.jit(fn_j)(*args)
    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("s", [9, 14, 15, 40])
def test_masked_window_attention_equals_jax(s):
    """``windowed_latent_attention`` with a mask at W=7: the gather form at
    S <= 2W (9, 14), the shift band with the banded mask above (15, 40)."""
    _both(lambda q, k, v, m: twin.windowed_latent_attention(q, k, v, 7, m),
          lambda q, k, v, m: jwin.windowed_latent_attention(q, k, v, 7, m),
          *_qkv_mask(s))


@pytest.mark.parametrize("w", [4, 7])
def test_masked_shift_band_with_a_weights_transform_equals_jax(w):
    """``_shift_banded_attention`` with the mask and a fixed
    ``weights_transform`` on its ``[B, h, W, S]`` weights (where the
    layer's dropout goes), and the banded mask itself, equal JAX's."""
    q, k, v, mask, g = _qkv_mask(33, seed=w)
    scale = np.random.default_rng(1).random((2, 2, w, 33)).astype(np.float32)
    _both(lambda q_, k_, v_, m: twin._shift_banded_attention(
              q_, k_, v_, w, lambda x: x * torch.from_numpy(scale), m),
          lambda q_, k_, v_, m: jwin._shift_banded_attention(
              q_, k_, v_, w, lambda x: x * scale, m),
          q, k, v, mask, g)
    np.testing.assert_array_equal(
        twin._banded_mask(torch.from_numpy(mask), 33, w).numpy(),
        np.asarray(jwin._banded_mask(jnp.asarray(mask), 33, w)))


def test_masked_layer_keeps_attention_dropout_at_banded_s(monkeypatch):
    """In training at banded S the masked layer takes the shift band and
    still drops the window weights (JAX ``models/layers.py`` :542-557): the
    band gets the mask and a dropout transform at the layer's rate; an
    all-ones mask in eval equals no mask."""
    layer = MultiHeadLatentAttention(32, 2, 7, dropout=0.5)
    x = torch.randn(2, 40, 32, generator=torch.Generator().manual_seed(0))
    ones = torch.ones(2, 40, 40)
    with torch.no_grad():
        torch.testing.assert_close(layer.eval()(x, attention_mask=ones),
                                   layer(x), atol=1e-6, rtol=0)
    seen = []
    real = twin._shift_banded_attention
    monkeypatch.setattr(twin, "_shift_banded_attention",
                        lambda *a: seen.append(a) or real(*a))
    layer.train()(x, DropoutRNG(3), attention_mask=ones)
    (q, k, v, w, transform, mask), = seen
    assert mask is ones and w == 7
    kept = transform(torch.ones(2, 2, 7, 40)) > 0
    assert abs(kept.float().mean().item() - 0.5) < 0.05
