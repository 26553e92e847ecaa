"""Serving artifacts of the port (``focused_attention_vit_tpu_torch/export.py``)
against the JAX package's (``focused_attention_vit_tpu/export.py``), and the
``favit::`` operators the artifacts call (``ops/library.py``).

Mirrors ``tests/test_export.py``: the artifact reproduces the live
Predictor bit for bit, loads without model code, overwrites atomically,
fails loudly when incomplete, serves through ``BatchingServer`` and HTTP,
and round-trips through ``serve --export_artifact``/``--from_export``. On
shared weights (``convert/from_jax.py``) its probabilities equal the JAX
artifact's within 1e-5 in f32. The JAX artifacts are exported once, in a
module fixture.
"""

import io
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu_torch import serve as tserve
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
)
from focused_attention_vit_tpu_torch.export import (
    ExportedPredictor,
    load_serving_artifact,
    save_serving_artifact,
)
from focused_attention_vit_tpu_torch.infer import Predictor
from focused_attention_vit_tpu_torch.models import (
    VisionTransformer,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.ops import flash_attention as flash
from focused_attention_vit_tpu_torch.ops import library
from focused_attention_vit_tpu_torch.ops import mha_kernel as fused
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(img_size=16, patch_size=4, num_classes=5, embed_dim=32, depth=1,
            num_heads=2)
# (name, geometry): the dense ViT (S=17), MHLA at S=17 (the dense band) and
# MHLA at S=785 (> 512: JAX's shift band, the port's band op), as JAX's
# tests/test_export.py:41 and :57.
CASES = {
    "vit": TINY,
    "vit_mhla": dict(TINY, img_size=32, patch_size=8),
    "vit_mhla_long_s": dict(TINY, img_size=112),
}
BATCH = 4


def _images(seed, n, hw):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3),
                                                dtype=np.uint8)


def _torch_model(name, geom):
    if name == "vit":
        return VisionTransformer(**geom)
    return VisionTransformerMHLA(window_size=7, **geom)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per case: JAX params, the images and the probabilities of JAX's
    artifact (save_serving_artifact, then load_serving_artifact)."""
    from focused_attention_vit_tpu import models as fmodels
    from focused_attention_vit_tpu.export import (
        load_serving_artifact as jax_load,
        save_serving_artifact as jax_save,
    )
    from focused_attention_vit_tpu.infer import Predictor as JaxPredictor

    out = {}
    for name, geom in CASES.items():
        if name == "vit":
            model = fmodels.VisionTransformer(**geom)
        else:
            model = fmodels.VisionTransformerMHLA(window_size=7,
                                                  use_mhla=True, **geom)
        size = geom["img_size"]
        params = model.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, size, size, 3)))["params"]
        pred = JaxPredictor(model, params, img_size=size, batch_size=BATCH,
                            compute_dtype=jnp.float32)
        art = jax_save(pred, str(tmp_path_factory.mktemp(name) / "art"))
        images = _images(size, 6, size)
        out[name] = dict(params=params, images=images,
                         probs=jax_load(art).predict_proba(images))
    return out


def _ported(name, jax_runs, **kw):
    geom = CASES[name]
    model = _torch_model(name, geom)
    convert = flax_vit_to_state_dict if name == "vit" else (
        flax_vit_mhla_to_state_dict)
    model.load_state_dict(convert(jax_runs[name]["params"]))
    return Predictor(model, img_size=geom["img_size"], device="cpu",
                     batch_size=kw.pop("batch_size", BATCH),
                     compute_dtype=torch.float32, **kw)


def _tiny_predictor(batch_size=8, seed=0, **kw):
    model = VisionTransformer(**TINY,
                              generator=torch.Generator().manual_seed(seed))
    return Predictor(model, img_size=16, device="cpu", batch_size=batch_size,
                     compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_matches_the_jax_artifact(name, jax_runs, tmp_path):
    """Shared weights: the port's artifact against JAX's within 1e-5 (f32),
    and against the port's live Predictor bit for bit; the long-S MHLA
    artifact holds the band op (``favit::band_fwd``) by name."""
    pred = _ported(name, jax_runs)
    art = save_serving_artifact(pred, str(tmp_path / "art"))
    loaded = load_serving_artifact(art)
    images = jax_runs[name]["images"]
    got = loaded.predict_proba(images)
    np.testing.assert_allclose(got, jax_runs[name]["probs"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got, pred.predict_proba(images))
    ops = {str(n.target) for n in loaded.program.graph.nodes
           if n.op == "call_function" and "favit" in str(n.target)}
    assert ops == ({"favit.band_fwd.default"} if name == "vit_mhla_long_s"
                   else set())


def test_artifact_round_trip_matches_live(tmp_path):
    pred = _tiny_predictor()
    loaded = load_serving_artifact(save_serving_artifact(
        pred, str(tmp_path / "art")))
    assert isinstance(loaded, ExportedPredictor)
    for n in (1, 8, 13):  # padding path included
        imgs = _images(n, n, 16)
        np.testing.assert_array_equal(loaded.predict_proba(imgs),
                                      pred.predict_proba(imgs))
    ids, conf = loaded.predict(imgs)
    assert ids.shape == (13,) and (conf <= 1.0).all()


def test_artifact_chunked_program_and_input_shape(tmp_path):
    """Batch 16 in chunks of 8, requests of 32x32 resized in the program
    (``input_hw``): equal to the live Predictor."""
    pred = _tiny_predictor(batch_size=16, chunk=8)
    loaded = load_serving_artifact(save_serving_artifact(
        pred, str(tmp_path / "art"), input_hw=(32, 32)))
    assert loaded.input_hw == (32, 32)
    imgs = _images(1, 19, 32)
    np.testing.assert_array_equal(loaded.predict_proba(imgs),
                                  pred.predict_proba(imgs))


def test_artifact_files_and_meta(tmp_path, monkeypatch):
    """Two files (the weights travel inside the program); the meta holds
    JAX's fields, the torch version, the device and the switches read at
    trace time."""
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    out = save_serving_artifact(_tiny_predictor(), str(tmp_path / "art"))
    assert sorted(os.listdir(out)) == ["meta.json", "serving_fn.pt2"]
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert (meta["batch_size"], meta["num_classes"], meta["input_hw"],
            meta["img_size"]) == (8, 5, [16, 16], 16)
    assert meta["torch_version"] == torch.__version__
    assert meta["device"] == "cpu"
    assert meta["trace_env"] == {"FAVIT_MHLA_IMPL": None,
                                 "FAVIT_USE_PALLAS_MHLA": None,
                                 "FAVIT_FUSED_MHA": "1"}
    # With the switch on, the short-S attention is the fused op.
    ops = {str(n.target) for n in load_serving_artifact(out).program.graph
           .nodes if "favit" in str(n.target)}
    assert ops == {"favit.fused_mha_fwd.default"}


def test_tile_band_artifact_exported_first(tmp_path, monkeypatch):
    """The tile-band path (``FAVIT_MHLA_IMPL=shiftband
    FAVIT_USE_PALLAS_MHLA=1``, reached on the CPU as the tile-band tests
    reach it) exported before any eager call: the artifact holds
    ``favit::tile_band_fwd`` and equals the live Predictor, whose edge-row
    indices, first made while the export traced, are real tensors."""
    from focused_attention_vit_tpu_torch.ops import window

    monkeypatch.setenv("FAVIT_MHLA_IMPL", "shiftband")
    monkeypatch.setenv("FAVIT_USE_PALLAS_MHLA", "1")
    monkeypatch.setattr(window, "_tile_band_on_card", lambda x: True)
    window._edge_slab_index.cache_clear()
    model = VisionTransformerMHLA(**TINY, window_size=7,
                                  generator=torch.Generator().manual_seed(2))
    pred = Predictor(model, img_size=16, device="cpu", batch_size=4,
                     compute_dtype=torch.float32)
    loaded = load_serving_artifact(save_serving_artifact(
        pred, str(tmp_path / "art")))
    ops = {str(n.target) for n in loaded.program.graph.nodes
           if "favit" in str(n.target)}
    assert ops == {"favit.tile_band_fwd.default"}
    imgs = _images(8, 5, 16)
    np.testing.assert_array_equal(loaded.predict_proba(imgs),
                                  pred.predict_proba(imgs))


def test_artifact_loads_without_model_code(tmp_path):
    """A fresh process loads and serves the artifact without importing any
    module of ``focused_attention_vit_tpu_torch.models`` (JAX
    tests/test_export.py:84)."""
    pred = _tiny_predictor()
    art = save_serving_artifact(pred, str(tmp_path / "art"))
    imgs = _images(5, 5, 16)
    np.save(tmp_path / "imgs.npy", imgs)
    code = (
        "import sys, numpy as np\n"
        "from focused_attention_vit_tpu_torch.export import "
        "load_serving_artifact\n"
        f"p = load_serving_artifact({art!r})\n"
        f"np.save({str(tmp_path / 'probs.npy')!r}, "
        f"p.predict_proba(np.load({str(tmp_path / 'imgs.npy')!r})))\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "'focused_attention_vit_tpu_torch.models')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    np.testing.assert_array_equal(np.load(tmp_path / "probs.npy"),
                                  pred.predict_proba(imgs))


def test_reexport_overwrites_atomically(tmp_path):
    """Re-exporting into an existing directory replaces it whole (a temp
    directory and a swap; JAX :181): the new weights load, and no temp
    directory is left."""
    art = str(tmp_path / "art")
    save_serving_artifact(_tiny_predictor(seed=0), art)
    second = _tiny_predictor(seed=9)
    save_serving_artifact(second, art)
    imgs = _images(3, 8, 16)
    np.testing.assert_array_equal(
        load_serving_artifact(art).predict_proba(imgs),
        second.predict_proba(imgs))
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]


def test_load_missing_or_partial_artifact_fails_loudly(tmp_path):
    with pytest.raises(FileNotFoundError, match="missing"):
        load_serving_artifact(str(tmp_path / "nope"))
    partial = tmp_path / "partial"
    partial.mkdir()
    (partial / "serving_fn.pt2").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="meta.json"):
        load_serving_artifact(str(partial))


def test_cuda_artifact_without_cuda_raises(tmp_path):
    """An artifact traced on the card does not fall back to the CPU: where
    CUDA is not available its load raises, naming the device."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    art = save_serving_artifact(_tiny_predictor(), str(tmp_path / "art"))
    meta_path = os.path.join(art, "meta.json")
    meta = json.load(open(meta_path))
    meta["device"] = "cuda"
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_serving_artifact(art)


def test_exported_predictor_through_batching_server(tmp_path):
    """The --from_export stack: the artifact behind ``BatchingServer``
    answers like the live path (JAX :225)."""
    pred = _tiny_predictor()
    loaded = load_serving_artifact(save_serving_artifact(
        pred, str(tmp_path / "art")))
    imgs = _images(4, 11, 16)
    with tserve.BatchingServer(loaded, max_delay_ms=1.0) as srv:
        probs = srv.predict_proba(imgs)
    np.testing.assert_array_equal(probs, pred.predict_proba(imgs))


SERVE_FLAGS = ["--model", "vit", "--img_size", "16", "--patch_size", "4",
               "--num_classes", "5", "--embed_dim", "32", "--depth", "1",
               "--num_heads", "2", "--compute_dtype", "float32",
               "--batch_size", "4", "--device", "cpu"]


def test_serve_cli_export_then_serve_over_http(tmp_path, capsys):
    """``serve --weights W --export_artifact DIR`` writes the artifact and
    exits; ``serve --from_export DIR`` builds the artifact's predictor,
    which answers ``POST /predict`` with the live path's probabilities."""
    model = VisionTransformer(**TINY,
                              generator=torch.Generator().manual_seed(4))
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    art = tmp_path / "art"
    tserve.main([*SERVE_FLAGS, "--weights", str(weights),
                 "--export_artifact", str(art)])
    assert f"serving artifact written to {art}" in capsys.readouterr().out
    args, pred = tserve.setup(["--from_export", str(art)])
    assert isinstance(pred, ExportedPredictor)
    _, live = tserve.setup([*SERVE_FLAGS, "--weights", str(weights)])
    imgs = _images(6, 6, 16)
    with tserve.BatchingServer(pred) as srv, \
            tserve.HTTPFrontend(srv, port=0) as fe:
        buf = io.BytesIO()
        np.save(buf, imgs)
        req = urllib.request.Request(f"http://{fe.host}:{fe.port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = np.load(io.BytesIO(resp.read()))
    np.testing.assert_array_equal(got, live.predict_proba(imgs))


@pytest.mark.parametrize("argv,flags", [
    (["--from_export", "a", "--export_artifact", "b"],
     ("--from_export", "--export_artifact")),
    (["--from_export", "a", "--checkpoint_dir", "c"],
     ("--from_export", "--checkpoint_dir")),
    (["--from_export", "a", "--weights", "w.pt"],
     ("--from_export", "--weights")),
    (["--weights", "w.pt", "--checkpoint_dir", "c"],
     ("--weights", "--checkpoint_dir")),
    ([], ("--weights", "--checkpoint_dir", "--from_export")),
], ids=["export_artifact", "checkpoint_dir", "weights", "two_sources",
        "no_source"])
def test_serve_cli_flag_conflicts(argv, flags, capsys):
    """Exactly one source; an artifact is exclusive with writing one, with
    a checkpoint and with weights. Each error names the flags (JAX
    ``serve.py:457-468`` and tests/test_export.py:209)."""
    with pytest.raises(SystemExit):
        tserve.main(argv)
    err = capsys.readouterr().err
    assert all(f in err for f in flags), err


def _op_args(name):
    """Small CPU arguments of each op, bf16, a seed of 2**63 + 7 where the
    op drops."""
    gen = torch.Generator().manual_seed(1)
    sminor = [torch.randn(2, 2, 16, 40, generator=gen).bfloat16()
              for _ in range(3)]
    tokens = [x.transpose(2, 3).contiguous() for x in sminor]
    rows = [x.reshape(4, 40, 16) for x in tokens]
    seed = 2**63 + 7
    lo, hi = seed & 0xFFFFFFFF, seed >> 32
    return {
        "band_fwd": (*sminor, 7, 0.25, lo, hi),
        "band_fwd_train": (*sminor, 7, 0.25, lo, hi),
        "flash_fwd": (*tokens, 16),
        "fused_mha_fwd": (*tokens, 0.25, lo, hi),
        "tile_band_fwd": (*rows, 7),
    }[name]


@pytest.mark.parametrize("name", list(library.OPS))
def test_op_fake_matches_cpu(name):
    """``torch.library.opcheck``: the schema, and the fake implementation's
    shape, dtype and strides against the CPU implementation's output."""
    op = getattr(torch.ops.favit, name)
    torch.library.opcheck(op.default, _op_args(name), test_utils=(
        "test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))


def test_ops_cpu_implementations_are_the_plain_versions():
    """Each op's CPU implementation is its kernel's plain version; a seed at
    or above 2**63 reaches the band's mask whole (its high bit counts)."""
    seed = 2**63 + 7
    args = _op_args("band_fwd_train")
    q, k, v = args[:3]
    out, wts = torch.ops.favit.band_fwd_train(*args)
    want = band.plain_band_forward_train(q, k, v, 7, 0.25, seed)
    assert torch.equal(out, want[0]) and torch.equal(wts, want[1])
    assert torch.equal(torch.ops.favit.band_fwd(*args), want[0])
    low = band.plain_band_forward_train(q, k, v, 7, 0.25, seed - 2**63)[0]
    assert not torch.equal(out, low)
    assert torch.equal(band.roll_banded_attention(q, k, v, 7, (0.25, seed)),
                       want[0])
    t = _op_args("fused_mha_fwd")
    assert torch.equal(torch.ops.favit.fused_mha_fwd(*t),
                       fused.plain_fused_mha_forward(*t[:3], 0.25, seed)[0])
    t = _op_args("flash_fwd")
    assert torch.equal(torch.ops.favit.flash_fwd(*t),
                       flash.plain_flash_forward(*t)[0])
    t = _op_args("tile_band_fwd")
    assert torch.equal(torch.ops.favit.tile_band_fwd(*t),
                       tile.plain_tile_band_forward(*t))
