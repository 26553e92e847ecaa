"""The port's pretrained fine-tune path against the JAX package, on the CPU
at a tiny size: the seeded checkpoint fixture, the checkpoint maps, the
shape-checked merge, the loader's head and miss rules, E3
``traditional_pretrained`` and E5 ``mhla_pretrained`` (weights and logits
after load, a frozen step, parameter counts, the CSV row, the CLI), the
conversion CLI, and ``PretrainedViTWithMHLA`` with its even-W finding.

A tiny torchvision variant (D=64, 2 blocks, 4 heads, patch 16) is added to
both packages' variant tables, so both fixture writers and both loaders take
it. Each JAX experiment runs once per module. f32 throughout: logits within
1e-4, gradients within 1e-5, maps and counts exact."""

import dataclasses
import functools
import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from focused_attention_vit_tpu import convert as jconvert
from focused_attention_vit_tpu import experiments as jexp
from focused_attention_vit_tpu.data import pretrained as jpre
from focused_attention_vit_tpu.experiments.pretrained_common import (
    merge_matching as jax_merge_matching,
)
from focused_attention_vit_tpu.models import (
    MHLATransformerBlock as JaxMHLABlock,
    PretrainedViTWithMHLA as JaxPretrainedViTWithMHLA,
    VisionTransformer as JaxVisionTransformer,
    VisionTransformerMHLA as JaxVisionTransformerMHLA,
)
from focused_attention_vit_tpu.train import steps as jsteps
from focused_attention_vit_tpu_torch import NotPortedError, cli, train
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch.convert import checkpoints as C
from focused_attention_vit_tpu_torch.convert.__main__ import (
    main as convert_main,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_pretrained_mhla_to_state_dict,
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
    flatten_params,
)
from focused_attention_vit_tpu_torch.data import pretrained as tpre
from focused_attention_vit_tpu_torch.experiments.pretrained_common import (
    merge_matching,
)
from focused_attention_vit_tpu_torch.models import (
    CrossAttentionViT,
    PretrainedViTWithMHLA,
    VisionTransformer,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.models.layers import (
    MHLATransformerBlock,
)
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tv4
from focused_attention_vit_tpu_torch.ops import patch_embed
from focused_attention_vit_tpu_torch.ops import window as twin

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(patch_size=16, embed_dim=64, depth=2, num_heads=4)
TINY12 = dict(TINY, depth=12)  # a deeper checkpoint for the same model
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-5
STEP_TOL = 5e-6  # tests/test_torch_train.py's grouped-optimizer test
TILE_ENV = {"FAVIT_MHLA_IMPL": "shiftband", "FAVIT_USE_PALLAS_MHLA": "1"}
# The experiments' geometry: the tiny variant at 224 pixels (S = 197).
EXP = dict(img_size=224, patch_size=16, embed_dim=64, depth=2, num_heads=4,
           num_classes=10, batch_size=16, epochs=1, subset_size=32,
           dropout=0.0, pretrained_model_variant="tiny",
           detailed_metrics=False)
E3_COLUMNS = [
    "model", "pretrained_source", "pretrained_model_variant",
    "freeze_layers", "img_size", "patch_size", "embed_dim", "depth",
    "num_heads", "total_parameters", "trainable_parameters",
    "frozen_parameters", "flops", "time_complexity", "space_complexity_mb",
    "model_size_mb", "avg_epoch_time", "total_training_time",
    "final_val_acc", "final_val_loss", "test_acc", "test_loss",
    "avg_inference_time_per_image", "peak_gpu_memory_mb",
]
E5_COLUMNS = E3_COLUMNS[:9] + ["window_size", "complexity_reduction_ratio"] + (
    E3_COLUMNS[9:])


@pytest.fixture(scope="module", autouse=True)
def tiny_variants():
    """The tiny variants in both packages' tables (the JAX tool reads the
    JAX table)."""
    with pytest.MonkeyPatch.context() as mp:
        for table in (jpre.TORCHVISION_VARIANTS, tpre.TORCHVISION_VARIANTS):
            mp.setitem(table, "tiny", TINY)
            mp.setitem(table, "tiny12", TINY12)
        yield


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A pretrained cache holding the port's tiny fixtures."""
    d = tmp_path_factory.mktemp("pretrained_weights")
    for variant in ("tiny", "tiny12"):
        tpre.write_fixture(str(d), variant)
    return str(d)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_pretrained_fixture", REPO / "tools" / "make_pretrained_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ckpt(cache, variant="tiny"):
    return torch.load(os.path.join(cache, f"{variant}_weights.pth"),
                      weights_only=True)


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], torch.as_tensor(np.asarray(want[k]))), k


# --- the fixture ----------------------------------------------------------------


@pytest.mark.parametrize("variant", ["tiny", "tiny12"])
def test_fixture_writer_matches_the_tool(cache, variant):
    want = _tool().make_state_dict(variant)
    got = tpre.make_fixture_state_dict(variant)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float16, k
        assert torch.equal(got[k], want[k]), k
    written = _ckpt(cache, variant)
    assert all(torch.equal(written[k], want[k]) for k in want)


def test_fixture_cli_writes_the_cache(tmp_path, capsys):
    tpre.main([str(tmp_path), "--variant", "tiny"])
    assert (tmp_path / "tiny_weights.pth").is_file()
    assert "seed 2026" in capsys.readouterr().out


# --- the checkpoint maps --------------------------------------------------------


@pytest.mark.parametrize("num_classes", [None, 1000, 10])
def test_torchvision_map_matches_jax(cache, num_classes):
    sd = _ckpt(cache)
    got = C.torchvision_vit_to_state_dict(sd, depth=2,
                                          num_classes=num_classes)
    params = jconvert.torchvision_vit_to_flax(sd, depth=2,
                                              num_classes=num_classes,
                                              num_heads=4)
    if num_classes == 10:  # head stripped on both sides
        assert "head" not in params and "head.weight" not in got
        params["head"] = {"kernel": np.zeros((64, 10), np.float32),
                          "bias": np.zeros(10, np.float32)}
        got = dict(got, **{"head.weight": torch.zeros(10, 64),
                           "head.bias": torch.zeros(10)})
    _assert_states_equal(got, flax_vit_to_state_dict(params))


def _hf_state(seed=3, d=64, depth=2, p=16, n_tokens=197, classes=None):
    """A synthetic HuggingFace ``ViTModel``-layout state dict."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    sd = {
        "embeddings.patch_embeddings.projection.weight": t(d, 3, p, p),
        "embeddings.patch_embeddings.projection.bias": t(d),
        "embeddings.cls_token": t(1, 1, d),
        "embeddings.position_embeddings": t(1, n_tokens, d),
        "layernorm.weight": t(d),
        "layernorm.bias": t(d),
    }
    for i in range(depth):
        pre = f"encoder.layer.{i}"
        for name, shape in [
                ("layernorm_before", (d,)), ("layernorm_after", (d,)),
                ("attention.attention.query", (d, d)),
                ("attention.attention.key", (d, d)),
                ("attention.attention.value", (d, d)),
                ("attention.output.dense", (d, d)),
                ("intermediate.dense", (4 * d, d)),
                ("output.dense", (d, 4 * d))]:
            sd[f"{pre}.{name}.weight"] = t(*shape)
            sd[f"{pre}.{name}.bias"] = t(shape[0])
    if classes:
        sd["classifier.weight"] = t(classes, d)
        sd["classifier.bias"] = t(classes)
    return sd


def test_hf_map_matches_jax():
    sd = _hf_state(classes=10)
    got = C.hf_vit_to_state_dict(sd, depth=2, num_classes=10)
    params = jconvert.hf_vit_to_flax(sd, depth=2, num_classes=10,
                                     num_heads=4)
    _assert_states_equal(got, flax_vit_to_state_dict(params))
    assert "head.weight" not in C.hf_vit_to_state_dict(sd, depth=2,
                                                       num_classes=7)


def test_patch_map_equals_the_convolution(cache):
    sd = _ckpt(cache)
    w, b = sd["conv_proj.weight"].float(), sd["conv_proj.bias"].float()
    img = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    want = torch.nn.functional.conv2d(img.permute(0, 3, 1, 2), w, b,
                                      stride=16).flatten(2).transpose(1, 2)
    got = torch.nn.functional.linear(patch_embed.extract_patches(img, 16),
                                     C.conv_patch_to_linear(w), b)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# --- the merge ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init(kind, img_size):
    cls = {"vit": JaxVisionTransformer,
           "mhla": functools.partial(JaxVisionTransformerMHLA,
                                     use_mhla=True, window_size=7)}[kind]
    model = cls(img_size=img_size, patch_size=16, num_classes=10,
                embed_dim=64, depth=2, num_heads=4)
    x = jnp.zeros((1, img_size, img_size, 3))
    return jax.tree.map(np.asarray,
                        jax.jit(model.init)(jax.random.PRNGKey(0), x)["params"])


def _port_model(kind, img_size):
    cls = {"vit": VisionTransformer,
           "mhla": functools.partial(VisionTransformerMHLA, use_mhla=True,
                                     window_size=7)}[kind]
    return cls(img_size=img_size, patch_size=16, num_classes=10,
               embed_dim=64, depth=2, num_heads=4)


@pytest.mark.parametrize("kind", ["vit", "mhla"])
@pytest.mark.parametrize("img_size,variant", [
    (224, "tiny"),    # the matching geometry: all but the head
    (32, "tiny"),     # pos_embed skipped
    (224, "tiny12"),  # depth 2 from a 12-block stack
])
def test_merge_counts_match_jax(cache, kind, img_size, variant):
    depth = tpre.TORCHVISION_VARIANTS[variant]["depth"]
    ckpt = C.torchvision_vit_to_state_dict(_ckpt(cache, variant), depth=depth,
                                           num_classes=10)
    jckpt = jconvert.torchvision_vit_to_flax(
        _ckpt(cache, variant), depth=depth, num_classes=10, num_heads=4)
    if kind == "mhla":
        ckpt = C.vit_state_to_mhla(ckpt, 2, 16)
        jckpt = jconvert.vit_params_to_mhla(jckpt, 2, 16)
    model = _port_model(kind, img_size)
    merged, copied, skipped = merge_matching(model.state_dict(), ckpt)
    _, jcopied, jskipped = jax_merge_matching(_jax_init(kind, img_size),
                                              jckpt)
    assert (copied, skipped) == (jcopied, jskipped)
    n = len(model.state_dict())
    assert copied + skipped == n - 2  # every tensor but the random head
    assert skipped == (1 if img_size == 32 else 0)  # pos_embed at 32 px
    model.load_state_dict(merged)
    assert torch.equal(model.blocks[1].attn.qkv.weight,
                       ckpt["blocks.1.attn.qkv.weight"])


def test_a_stack_with_holes_raises(cache):
    ckpt = C.torchvision_vit_to_state_dict(_ckpt(cache, "tiny12"), depth=12)
    holed = {k: v for k, v in ckpt.items() if not k.startswith("blocks.1.")}
    with pytest.raises(ValueError, match="holes"):
        C.vit_state_to_mhla(holed, 12, 16)
    jparams = jconvert.torchvision_vit_to_flax(_ckpt(cache, "tiny12"),
                                               depth=12, num_heads=4)
    jparams.pop("blocks_1")
    with pytest.raises(ValueError, match="holes"):
        jconvert.vit_params_to_mhla(jparams, 12, 16)


def test_mhla_surgery_matches_jax(cache):
    state = C.torchvision_vit_to_state_dict(_ckpt(cache), depth=2)
    got = C.vit_state_to_mhla(state, 2, 16)
    want = jconvert.vit_params_to_mhla(
        jconvert.torchvision_vit_to_flax(_ckpt(cache), depth=2,
                                         num_heads=4), 2, 16)
    _assert_states_equal(got, flax_vit_mhla_to_state_dict(want))
    assert torch.equal(got["blocks.0.attn.latent_proj.weight"],
                       torch.eye(16))
    assert "pos_embed" not in C.vit_state_to_mhla(state, 2, 16,
                                                  keep_pos_embed=False)


# --- the loader -----------------------------------------------------------------


@pytest.mark.parametrize("num_classes", [None, 1000, 10])
def test_loader_head_rule_matches_jax(cache, tmp_path, num_classes):
    state, cfg = tpre.load_pretrained_vit_params(
        "tiny", cache_dir=cache, num_classes=num_classes)
    # JAX writes its msgpack cache beside the .pth: give it its own copy.
    jdir = tmp_path / "jax"
    jdir.mkdir()
    os.link(os.path.join(cache, "tiny_weights.pth"), jdir / "tiny_weights.pth")
    params, jcfg = jpre.load_pretrained_vit_params(
        "tiny", cache_dir=str(jdir), num_classes=num_classes)
    assert cfg == jcfg == dict(TINY, img_size=224)
    assert ("head.weight" in state) == ("head" in params) == (
        num_classes != 10)
    assert torch.equal(state["blocks.1.mlp.fc2.weight"],
                       torch.from_numpy(params["blocks_1"]["mlp"]["fc2"]
                                        ["kernel"].T.copy()))
    assert torch.equal(state["cls_token"],
                       _ckpt(cache)["class_token"].float())


def test_loader_miss_rules(tmp_path, caplog, monkeypatch):
    with pytest.raises(FileNotFoundError, match="unavailable"):
        tpre.load_pretrained_vit_params("tiny", cache_dir=str(tmp_path),
                                        strict=True)
    with caplog.at_level("WARNING"):
        state, cfg = tpre.load_pretrained_vit_params(
            "tiny", cache_dir=str(tmp_path))
    assert state is None and cfg["depth"] == 2
    assert "RANDOM INITIALIZATION" in caplog.text
    with pytest.raises(FileNotFoundError):
        jpre.load_pretrained_vit_params("tiny", cache_dir=str(tmp_path),
                                        strict=True)
    # No HF snapshot (here: no transformers to import) is a miss too.
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert tpre.load_pretrained_vit_params(
        "tiny", source="huggingface", cache_dir=str(tmp_path))[0] is None
    with pytest.raises(ValueError, match="Unknown pretrained variant"):
        tpre.load_pretrained_vit_params("vit_x", cache_dir=str(tmp_path))


@pytest.mark.parametrize("source,name", [
    ("torchvision", "tiny_flax.msgpack"),
    ("huggingface", "tiny_hf_flax.msgpack")])
def test_a_msgpack_only_cache_loads(cache, tmp_path, monkeypatch, source,
                                   name):
    """A converted Flax cache that JAX wrote, and nothing else: the port
    reads it by its own msgpack reader (raised NotPortedError until the
    reader was ported) and gets the state the ``.pth`` gives, head rule
    included; with a ``.pth`` beside it the msgpack is read first, as in
    JAX."""
    monkeypatch.setitem(sys.modules, "transformers", None)  # no HF snapshot
    d = tmp_path / "msgpack_only"
    d.mkdir()
    jpre._write_msgpack_cache(str(d / name), jconvert.torchvision_vit_to_flax(
        _ckpt(cache), depth=2, num_heads=4))
    params, _ = jpre.load_pretrained_vit_params("tiny", source=source,
                                                cache_dir=str(d))
    assert params is not None
    want, _ = tpre.load_pretrained_vit_params("tiny", cache_dir=cache)
    got, _ = tpre.load_pretrained_vit_params("tiny", source=source,
                                             cache_dir=str(d))
    _assert_states_equal(got, want)
    _assert_states_equal(flax_vit_to_state_dict(params), want)
    headless, _ = tpre.load_pretrained_vit_params(
        "tiny", source=source, cache_dir=str(d), num_classes=10)
    assert "head.weight" not in headless and len(headless) == len(want) - 2
    torch.save({}, d / "tiny_weights.pth")  # unreadable as a ViT: not read
    again, _ = tpre.load_pretrained_vit_params("tiny", source=source,
                                               cache_dir=str(d))
    _assert_states_equal(again, want)


# --- E3 and E5 against JAX ------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_synthetic_dataset():
    """Every ``setup()`` here, JAX's and the port's, loads the same subset
    of the synthetic stand-in: each package builds the images it is cut
    from once."""
    from focused_attention_vit_tpu.experiments import base as jbase
    from focused_attention_vit_tpu_torch.experiments import base

    def cached(real):
        data = {}

        def load(name, data_dir, subset_size, seed):
            key = (name, subset_size, seed)
            if key not in data:
                data[key] = real(name, data_dir=data_dir,
                                 subset_size=subset_size, seed=seed)
            return dict(data[key])
        return load

    with pytest.MonkeyPatch.context() as mp:
        for module in (jbase, base):
            mp.setattr(module, "load_dataset", cached(module.load_dataset))
        yield


NAMES = {"e3": ("PretrainedTraditionalViTExperiment", flax_vit_to_state_dict),
         "e5": ("PretrainedMHLAViTExperiment", flax_vit_mhla_to_state_dict)}
X = np.random.default_rng(5).normal(size=(3, 224, 224, 3)).astype(np.float32)
U8 = np.random.default_rng(6).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
Y = np.array([1, 4, 7, 9])


def _dirs(tmp, cache):
    return dict(data_dir=str(tmp / "data"), results_dir=str(tmp / "results"),
                pretrained_cache_dir=cache)


def _jax_run(name, cache, tmp):
    """One JAX experiment with the body frozen: its params after load, its
    logits on X, its params after one grouped step on (U8, Y) without
    augmentation, and the experiment after train/evaluate/save_results."""
    cls, to_state = NAMES[name]
    e = getattr(jexp, cls)(**EXP, freeze_layers=True,
                           **_dirs(Path(tmp), cache))
    e.setup()
    loaded = to_state(jax.tree.map(np.asarray, e.state.params))
    logits = np.asarray(e.model.apply({"params": e.state.params},
                                      jnp.asarray(X)))
    step = jsteps.make_train_step(224, augment=False)
    # The step donates its input state: train on from the stepped one, as
    # the port's experiment does.
    e.state, _ = step(e.state, U8, Y, jax.random.PRNGKey(0))
    after = to_state(jax.tree.map(np.asarray, e.state.params))
    e.train()
    e.evaluate()
    e.save_results()
    return e, loaded, logits, after


@pytest.fixture(scope="module")
def jax_runs(cache, tmp_path_factory):
    return {name: _jax_run(name, cache, str(tmp_path_factory.mktemp(name)))
            for name in NAMES}


@pytest.fixture(scope="module")
def port_runs(cache, jax_runs, tmp_path_factory):
    """The port's E3 and E5, frozen, on the CPU: after load (with JAX's
    random head copied in), the logits on X, one grouped step, and
    train/evaluate/save_results."""
    out = {}
    for name, (cls, _) in NAMES.items():
        e = getattr(exp, cls)(**EXP, freeze_layers=True, device="cpu",
                              **_dirs(tmp_path_factory.mktemp(name), cache))
        e.setup()
        _, loaded, _, _ = jax_runs[name]
        loaded_here = {k: v.clone() for k, v in e.model.state_dict().items()}
        with torch.no_grad():
            e.model.head.weight.copy_(loaded["head.weight"])
            e.model.head.bias.copy_(loaded["head.bias"])
        before = {k: v.clone() for k, v in e.model.state_dict().items()}
        with torch.inference_mode():
            logits = e.model.eval()(torch.from_numpy(X)).numpy()
        step = train.make_train_step(224, augment=False)
        step(e.state, U8, Y, 0)
        after = {k: v.clone() for k, v in e.model.state_dict().items()}
        e.train()
        e.evaluate()
        e.save_results()
        out[name] = dict(e=e, loaded=loaded_here, before=before,
                         logits=logits, after=after)
    return out


@pytest.mark.parametrize("name", list(NAMES))
def test_loaded_weights_match_jax(name, jax_runs, port_runs):
    _, want, _, _ = jax_runs[name]
    got = port_runs[name]["loaded"]
    assert sorted(got) == sorted(want)
    for k in want:
        if not k.startswith("head."):  # random on both sides
            assert torch.equal(got[k], want[k]), k
    e = port_runs[name]["e"]
    assert e.pretrained_loaded
    assert e.merge_counts == {"copied": len(got) - 2, "skipped": 0}
    if name == "e5":
        assert torch.equal(got["blocks.1.attn.latent_proj.weight"],
                           torch.eye(16))


@pytest.mark.parametrize("name", list(NAMES))
def test_logits_after_load_match_jax(name, jax_runs, port_runs):
    _, _, want, _ = jax_runs[name]
    np.testing.assert_allclose(port_runs[name]["logits"], want,
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("name", list(NAMES))
def test_frozen_step_matches_jax(name, jax_runs, port_runs):
    """Frozen parameters keep their bits; the head (and E5's latent_proj)
    move as JAX's grouped step moves them."""
    _, _, _, want = jax_runs[name]
    run = port_runs[name]
    trained = {k for k in want if k.startswith("head.")
               or "latent_proj" in k}
    assert len(trained) == (2 if name == "e3" else 6)
    for k in want:
        if k in trained:
            assert not torch.equal(run["after"][k], run["before"][k]), k
            np.testing.assert_allclose(run["after"][k].numpy(),
                                       np.asarray(want[k]), atol=STEP_TOL,
                                       rtol=0, err_msg=k)
        else:
            assert torch.equal(run["after"][k], run["before"][k]), k
    frozen = [n for n, p in run["e"].model.named_parameters()
              if not p.requires_grad]
    assert sorted(frozen) == sorted(set(want) - trained)


@pytest.mark.parametrize("name", list(NAMES))
def test_param_counts_and_csv_match_jax(name, jax_runs, port_runs):
    import csv

    je = jax_runs[name][0]
    e = port_runs[name]["e"]
    assert e.param_counts == je.param_counts
    head = 64 * 10 + 10
    latent = 2 * (16 * 16 + 16) if name == "e5" else 0
    assert e.param_counts["trainable_params"] == head + latent
    ours, theirs = e.results_row(), je.results_row()
    columns = E3_COLUMNS if name == "e3" else E5_COLUMNS
    assert list(ours) == list(theirs) == columns
    for col in columns[:columns.index("model_size_mb") + 1]:
        assert ours[col] == theirs[col], col
    with open(os.path.join(e.results_dir, e.csv_filename), newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == columns and len(rows) == 2


@pytest.mark.parametrize("name", list(NAMES))
def test_experiment_fields_match_jax(name):
    cls = NAMES[name][0]
    ours = dataclasses.fields(getattr(exp, cls))
    theirs = dataclasses.fields(getattr(jexp, cls))
    assert [f.name for f in ours] == [f.name for f in theirs]
    differ = [a.name for a, b in zip(ours, theirs) if a.default != b.default]
    assert differ == ["auto_microbatch"]  # off in the port (TPU values)


def test_unfrozen_counts_and_groups(cache, tmp_path):
    e = exp.PretrainedMHLAViTExperiment(**EXP, device="cpu",
                                        **_dirs(tmp_path, cache))
    e.setup()
    n = sum(p.numel() for p in e.model.parameters())
    assert e.param_counts == {"total_params": n, "trainable_params": n,
                              "frozen_params": 0}
    assert all(p.requires_grad for p in e.model.parameters())
    groups = {g["label"]: len(g["params"])
              for g in e.state.tx.adamw.param_groups}
    assert groups == {"body": len(list(e.model.parameters())) - 6,
                      "latent": 4, "head": 2}
    assert e.group_lrs() == {"body": 1e-4, "latent": 5e-4, "head": 1e-3}
    # JAX's auto-microbatch shape, both values off on the card.
    assert e._auto_microbatch_value() is None
    e.patch_size = 4
    assert e._auto_microbatch_value() is None


def test_without_a_checkpoint_the_model_keeps_its_init(tmp_path, caplog):
    e = exp.PretrainedTraditionalViTExperiment(
        **EXP, device="cpu", data_dir=str(tmp_path / "data"),
        results_dir=str(tmp_path / "results"),
        pretrained_cache_dir=str(tmp_path / "empty"))
    with caplog.at_level("WARNING"):
        e.setup()
    assert not e.pretrained_loaded and "RANDOM" in caplog.text
    e.strict_pretrained = True
    with pytest.raises(FileNotFoundError):
        e.setup()


# --- the CLI --------------------------------------------------------------------

CLI_TINY = ["--device", "cpu", "--pretrained_model_variant", "tiny",
            "--img_size", "224", "--patch_size", "16", "--embed_dim", "64",
            "--depth", "2", "--num_heads", "4", "--batch_size", "16",
            "--epochs", "1", "--subset_size", "32", "--no_detailed_metrics"]


@pytest.mark.parametrize("name,csv_name,columns", [
    ("traditional_pretrained", "exp3_pretrained_traditional.csv",
     E3_COLUMNS),
    ("mhla_pretrained", "exp4_pretrained_mhla.csv", E5_COLUMNS)])
def test_cli_runs_the_pretrained_experiments(cache, tmp_path, monkeypatch,
                                             name, csv_name, columns):
    import csv

    monkeypatch.chdir(tmp_path)
    os.symlink(cache, tmp_path / "pretrained_weights")
    e = cli.main(["--experiment", name, *CLI_TINY, "--freeze_layers",
                  "--head_learning_rate", "0.01", "--window_size", "5"])
    assert e.pretrained_loaded and e.freeze_layers is True
    assert e.head_learning_rate == 0.01
    assert getattr(e, "window_size", 5) == 5
    with open(tmp_path / "results" / csv_name, newline="") as f:
        assert next(csv.reader(f)) == columns


@pytest.mark.parametrize("extra,flag", [
    (["--mu_dtype", "bfloat16"], "mu_dtype"),
    (["--remat"], "remat"),
    (["--visualize"], "visualize")])
@pytest.mark.parametrize("name", ["traditional_pretrained",
                                  "mhla_pretrained"])
def test_cli_rejects_what_is_not_ported(tmp_path, monkeypatch, name, extra,
                                        flag):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotPortedError, match=f"--{flag} .*not ported yet"):
        cli.main(["--experiment", name, "--device", "cpu", *extra])
    assert not (tmp_path / "results").exists()


@pytest.mark.parametrize("name", ["traditional_pretrained",
                                  "mhla_pretrained"])
def test_cli_takes_checkpoint_dir(cache, tmp_path, monkeypatch, name,
                                  capsys):
    """Was rejected until checkpointing was ported: the pretrained run
    saves its epoch, and the same command to more epochs resumes from the
    saved state (not from the checkpoint it was fine-tuned from)."""
    monkeypatch.chdir(tmp_path)
    os.symlink(cache, tmp_path / "pretrained_weights")
    argv = ["--experiment", name, *CLI_TINY, "--checkpoint_dir", "ckpt"]
    first = cli.main(argv)
    argv[argv.index("--epochs") + 1] = "2"
    second = cli.main(argv)
    assert "Resumed from checkpoint epoch 1" in capsys.readouterr().out
    assert len(second.metrics["training"]["train_losses"]) == 1
    assert second.state.step == 2 * first.state.step
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2",
                                                     "params_latest.pt"]


def test_convert_cli(cache, tmp_path, capsys):
    src = os.path.join(cache, "tiny_weights.pth")
    for to, model in (("vit", VisionTransformer(
            img_size=224, patch_size=16, num_classes=1000, embed_dim=64,
            depth=2, num_heads=4)), ("mhla", VisionTransformerMHLA(
                img_size=224, patch_size=16, num_classes=1000, embed_dim=64,
                depth=2, num_heads=4))):
        out = tmp_path / f"{to}.pt"
        assert convert_main([src, str(out), "--to", to, "--depth", "2",
                             "--num_heads", "4", "--embed_dim", "64"]) == 0
        model.load_state_dict(torch.load(out, weights_only=True),
                              strict=True)
    # The reference repo's ViT keys are the port's.
    convert_main([str(tmp_path / "vit.pt"), str(tmp_path / "ref_mhla.pt"),
                  "--format",
                  "reference", "--to", "mhla", "--depth", "1",
                  "--embed_dim", "64", "--num_heads", "4"])
    one = torch.load(tmp_path / "ref_mhla.pt", weights_only=True)
    assert "blocks.1.norm1.weight" not in one
    assert torch.equal(one["blocks.0.attn.latent_proj.weight"], torch.eye(16))
    assert "format=torchvision" in capsys.readouterr().out
    # --to sppp converts since the SPPP family was ported
    # (tests/test_torch_sppp.py), --to cross since the cross-attention
    # family was (tests/test_torch_cross_attention.py).
    assert convert_main([src, str(tmp_path / "sppp.pt"), "--to", "sppp",
                         "--depth", "2"]) == 0
    assert "pos_embed" not in torch.load(tmp_path / "sppp.pt",
                                         weights_only=True)
    assert convert_main([src, str(tmp_path / "x.pt"), "--to", "cross",
                         "--depth", "2"]) == 0
    CrossAttentionViT(img_size=224, patch_size=16, num_classes=1000,
                      embed_dim=64, depth=2, num_heads=4).load_state_dict(
        torch.load(tmp_path / "x.pt", weights_only=True), strict=True)


# --- PretrainedViTWithMHLA -------------------------------------------------------

GEOM = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=32, depth=2,
            num_heads=2, window_size=4)  # S = 65, W = 4


@functools.lru_cache(maxsize=None)
def _jax_pretrained_mhla(impl):
    model = JaxPretrainedViTWithMHLA(**GEOM)
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.asarray(x))[
        "params"]
    y = np.array([2, 5])

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), y]), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return params, x, y, np.asarray(logits), float(loss), grads


@pytest.mark.parametrize("impl", ["auto", "roll"])
def test_pretrained_mhla_matches_jax(monkeypatch, impl):
    monkeypatch.setenv("FAVIT_MHLA_IMPL", impl)
    params, x, y, want, loss_j, grads_j = _jax_pretrained_mhla(impl)
    sd = flax_pretrained_mhla_to_state_dict(params)
    model = PretrainedViTWithMHLA(**GEOM)
    assert set(sd) == set(model.state_dict())
    assert "blocks.0.mlp.3.weight" in sd
    model.load_state_dict(sd, strict=True)
    # The reference's own map reads the port's keys back to JAX's params.
    back = flatten_params(jconvert.reference_mhla_vit_to_flax(
        model.state_dict(), depth=2, num_heads=2))
    want_params = flatten_params(jax.tree.map(np.asarray, params))
    assert sorted(back) == sorted(want_params)
    for k, v in want_params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    band.reset_launch_count()
    loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(x)),
                                             torch.from_numpy(y))
    loss.backward()
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    assert abs(loss.item() - loss_j) < GRAD_TOL
    want_g = flax_pretrained_mhla_to_state_dict(grads_j)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[name]),
                                   atol=GRAD_TOL, err_msg=name)
    assert band.launch_count() == 0


def test_pretrained_mhla_defaults_and_refusals():
    model = PretrainedViTWithMHLA(depth=1, embed_dim=32, num_heads=2)
    assert (model.patch_size, model.window_size, model.num_classes) == (
        4, 4, 1000)
    assert model.blocks[0].attn.window_size == 4
    assert model.blocks[0].mlp.dropout == 0.0
    with pytest.raises(NotPortedError, match="sp_mesh"):
        PretrainedViTWithMHLA(depth=1, sp_mesh=object())
    block = MHLATransformerBlock(32, 2, 4)
    with pytest.raises(NotPortedError, match="§A 7"):
        block(torch.zeros(1, 9, 32), torch.ones(1, 9, 9))


@pytest.fixture()
def tile_path(monkeypatch):
    """The tile-band branch on both sides, as tests/test_torch_tile_band.py
    sets it: the two variables, JAX told it runs on a TPU, the port's
    device predicate told it runs on the card."""
    for key, val in TILE_ENV.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(twin, "_tile_band_on_card", lambda x: True)


def _even_w_block(seed=9, s=100, d=32, h=2, w=4):
    """An MHLA block at W=4 with q, k and v of unit scale (qkv and proj
    N(0, 1/D), identity latent_proj as after the surgery) and its JAX
    params, and an input of S tokens."""
    rng = np.random.default_rng(seed)
    model = PretrainedViTWithMHLA(img_size=8, patch_size=4, embed_dim=d,
                                  depth=1, num_heads=h, window_size=w)
    attn = model.blocks[0].attn
    with torch.no_grad():
        for lin in (attn.qkv, attn.proj):
            lin.weight.copy_(torch.from_numpy(rng.normal(
                0, d ** -0.5, lin.weight.shape).astype(np.float32)))
        attn.latent_proj.weight.copy_(torch.eye(d // h))
    params = jconvert.reference_mhla_vit_to_flax(model.state_dict(), depth=1,
                                                 num_heads=h)["blocks_0"]
    x = rng.normal(size=(1, s, d)).astype(np.float32)
    return model.blocks[0].eval(), params, x, JaxMHLABlock(d, h, window_size=w)


def _both_sides(block, params, x, jblock):
    with torch.inference_mode():
        got = block(torch.from_numpy(x)).numpy()
    # A fresh function each call: the trace reads the environment.
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(lambda p, v: jblock.apply(p, v))(
            {"params": params}, jnp.asarray(x)))
    return got, want


def test_even_window_model_differs_under_the_tile_band(tile_path,
                                                       monkeypatch):
    """ROADMAP §C 1 pinned on the W=4 class: under the tile-band opt-in an
    MHLA block of ``PretrainedViTWithMHLA`` (S = 100) reads W + 1 keys in
    its interior rows, so it differs from its default path (the dense
    band) by more than 0.5 there, in JAX as in the port; the port equals
    JAX within 1e-5 on each path."""
    block, params, x, jblock = _even_w_block()
    tv4.reset_launch_count()
    tile_t, tile_j = _both_sides(block, params, x, jblock)
    for key in TILE_ENV:
        monkeypatch.delenv(key)
    dense_t, dense_j = _both_sides(block, params, x, jblock)
    np.testing.assert_allclose(tile_t, tile_j, atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(dense_t, dense_j, atol=GRAD_TOL, rtol=GRAD_TOL)
    inner = slice(2, 98)
    assert np.abs(tile_t - dense_t)[:, inner].max() > 0.5
    assert np.abs(tile_j - dense_j)[:, inner].max() > 0.5
    assert [tv4.launch_count(k) for k in tv4.LAUNCH_KINDS] == [0, 0, 0]
