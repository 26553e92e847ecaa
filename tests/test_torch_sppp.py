"""The port's SPPP models and experiments against the JAX package, on the
CPU at a small size (32^2 images, patch 4, D=64, 2 blocks, 4 heads, R=16, so
S=17): ``SPPPViT`` (three poolings), ``SPPPViTMHLA`` (``use_mhla`` on and
off) and ``PretrainedSPPPViTWithMHLA`` (default and ``roll`` dispatch) from
JAX params through ``convert.from_jax``, the superpixel ids equal first,
then eval logits within 1e-4 and one step's gradients within 1e-5; E2
``sppp``, E4 ``sppp_pretrained`` and E6 ``sppp_mhla_pretrained``, each run
once in JAX and in the port (CSV columns and their values, theoretical
metrics, parameter counts, E4's copied and skipped tensors, E6's four
groups); the CLI and ``convert --to sppp``.

A tiny torchvision variant (D=64, 2 blocks, patch 16) is added to both
packages' variant tables for E4 and E6, which run at 64^2 pixels."""

import csv
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu import experiments as jexp
from focused_attention_vit_tpu.data import pretrained as jpre
from focused_attention_vit_tpu.experiments import (
    pretrained_common as jpretrained_common,
)
from focused_attention_vit_tpu.models import (
    PretrainedSPPPViTWithMHLA as JaxPretrainedSPPPViTWithMHLA,
    SPPPViT as JaxSPPPViT,
    SPPPViTMHLA as JaxSPPPViTMHLA,
)
from focused_attention_vit_tpu.ops import (  # the package's re-exports
    dominant_superpixel_per_patch as jax_dominant,
    slic_segment as jax_slic_segment,
)
from focused_attention_vit_tpu_torch import cli
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch.convert import checkpoints as C
from focused_attention_vit_tpu_torch.convert.__main__ import (
    main as convert_main,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_to_state_dict_for,
    load_flax_params_into_experiment,
)
from focused_attention_vit_tpu_torch.data import pretrained as tpre
from focused_attention_vit_tpu_torch.experiments import pretrained_common
from focused_attention_vit_tpu_torch.models import (
    PretrainedSPPPViTWithMHLA,
    SPPPViT,
    SPPPViTMHLA,
)
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops.segment_pool import (
    dominant_superpixel_per_patch,
)
from focused_attention_vit_tpu_torch.ops.slic import slic_segment

torch.set_num_threads(2)

LOGIT_TOL = 1e-4
GRAD_TOL = 1e-5
GEOM = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=64, depth=2,
            num_heads=4)
TINY = dict(patch_size=16, embed_dim=64, depth=2, num_heads=4)
X = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
Y = np.array([2, 5])

MODELS = {
    "sppp-mean": (JaxSPPPViT, SPPPViT, {}),
    "sppp-max": (JaxSPPPViT, SPPPViT, dict(pooling_type="max")),
    "sppp-attention": (JaxSPPPViT, SPPPViT, dict(pooling_type="attention")),
    "sppp_mhla": (JaxSPPPViTMHLA, SPPPViTMHLA, dict(use_mhla=True)),
    "sppp_mhla-dense": (JaxSPPPViTMHLA, SPPPViTMHLA, dict(use_mhla=False)),
    "pretrained_sppp_mhla": (JaxPretrainedSPPPViTWithMHLA,
                             PretrainedSPPPViTWithMHLA, {}),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name, impl):
    """JAX params, eval logits on X, and the CE loss and its gradients on
    (X, Y) (no dropout: every rate is 0)."""
    jcls, _, kw = MODELS[name]
    model = jcls(**GEOM, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FAVIT_MHLA_IMPL", impl)
        params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                     jnp.asarray(X))["params"]

        def loss_fn(p):
            logits = model.apply({"params": p}, jnp.asarray(X))
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(logp[jnp.arange(2), Y]), logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    return (jax.tree.map(np.asarray, params), np.asarray(logits), float(loss),
            jax.tree.map(np.asarray, grads))


def test_superpixel_ids_match_jax():
    """What the models pool by: SLIC at 32^2 (the device connectivity pass,
    as ``auto`` picks) and the dominant superpixel per 4x4 patch."""
    jseg = jax_slic_segment(jnp.asarray(X), num_segments=16)
    want = np.stack([np.asarray(jax_dominant(m, 4, 16)) for m in jseg])
    seg = slic_segment(torch.from_numpy(X), 16)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    got = dominant_superpixel_per_patch(seg, 4, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 4  # the pooling sees many segments


@pytest.mark.parametrize("name,impl", [
    *((n, "auto") for n in MODELS), ("pretrained_sppp_mhla", "roll")])
def test_model_matches_jax(monkeypatch, name, impl):
    monkeypatch.setenv("FAVIT_MHLA_IMPL", impl)
    params, want, loss_j, grads_j = _jax_model(name, impl)
    _, cls, kw = MODELS[name]
    model = cls(**GEOM, **kw)
    sd = flax_to_state_dict_for(model, params)
    assert set(sd) == set(model.state_dict()) and "pos_embed" not in sd
    model.load_state_dict(sd, strict=True)
    band.reset_launch_count()
    loss = torch.nn.functional.cross_entropy(
        model.train()(torch.from_numpy(X)), torch.from_numpy(Y))
    loss.backward()
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    assert abs(loss.item() - loss_j) < GRAD_TOL
    want_g = flax_to_state_dict_for(model, grads_j)
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[pname]),
                                   atol=GRAD_TOL, err_msg=pname)
    assert band.launch_count() == 0  # the CPU runs the plain band


def test_model_defaults_and_bf16():
    m = PretrainedSPPPViTWithMHLA(depth=1, embed_dim=32, num_heads=2)
    assert (m.patch_size, m.window_size, m.num_classes, m.num_superpixels,
            m.pooling_type, m.slic_connectivity) == (4, 4, 1000, 16, "mean",
                                                     "auto")
    assert m.blocks[0].attn.window_size == 4
    assert not hasattr(m, "pos_embed")
    dense = SPPPViT(depth=1, embed_dim=32, num_heads=2).blocks[0].attn
    assert dense.use_flash is False  # the fused switch never applies
    assert SPPPViTMHLA(depth=1, embed_dim=32, num_heads=2,
                       use_mhla=False).blocks[0].attn.use_flash is False
    # A bf16 model takes f32 images: SLIC reads them in f32, the patch
    # embedding in the model's dtype.
    model = SPPPViT(**GEOM).eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(X))
        got = model.to(torch.bfloat16)(torch.from_numpy(X))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, atol=0.05, rtol=0)


# --- E2, E4 and E6 against JAX ---------------------------------------------------

NAMES = {"e2": "SPPPExperiment", "e4": "PretrainedSPPPExperiment",
         "e6": "PretrainedSPPPMHLAExperiment"}
EXP = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
           num_classes=10, batch_size=16, epochs=1, subset_size=32,
           dropout=0.0, detailed_metrics=False)
E2_COLUMNS = [
    "model", "img_size", "patch_size", "embed_dim", "depth", "num_heads",
    "num_superpixels", "traditional_tokens", "sppp_tokens",
    "token_reduction_factor", "parameters", "flops", "time_complexity",
    "space_complexity_mb", "model_size_mb", "avg_epoch_time",
    "total_training_time", "final_val_acc", "final_val_loss", "test_acc",
    "test_loss", "avg_inference_time_per_image", "peak_gpu_memory_mb",
]
_PRE = ["model", "pretrained_source", "pretrained_model_variant",
        "freeze_layers"]
_COUNTS = ["total_parameters", "trainable_parameters", "frozen_parameters"]
E4_COLUMNS = (_PRE + E2_COLUMNS[1:10] + _COUNTS + E2_COLUMNS[11:])
E6_COLUMNS = (_PRE + E2_COLUMNS[1:7] + ["window_size"] + E2_COLUMNS[7:10]
              + ["complexity_reduction_ratio"] + _COUNTS + E2_COLUMNS[11:])
COLUMNS = {"e2": E2_COLUMNS, "e4": E4_COLUMNS, "e6": E6_COLUMNS}


@pytest.fixture(scope="module", autouse=True)
def tiny_variant():
    with pytest.MonkeyPatch.context() as mp:
        for table in (jpre.TORCHVISION_VARIANTS, tpre.TORCHVISION_VARIANTS):
            mp.setitem(table, "tiny", TINY)
        yield


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrained_weights")
    tpre.write_fixture(str(d), "tiny")
    return str(d)


@pytest.fixture(scope="module", autouse=True)
def one_synthetic_dataset():
    """Every ``setup()`` here loads the same subset of the synthetic
    stand-in, built once per package."""
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


def _kwargs(name, cache, tmp):
    kw = dict(EXP, data_dir=str(tmp / "data"),
              results_dir=str(tmp / "results"))
    if name != "e2":
        kw.update(pretrained_model_variant="tiny",
                  pretrained_cache_dir=cache)
    return kw


def _spy_merge(module, counts):
    real = module.merge_matching

    def spy(*args, **kw):
        merged, copied, skipped = real(*args, **kw)
        counts.append((copied, skipped))
        return merged, copied, skipped
    return spy


@pytest.fixture(scope="module")
def runs(cache, tmp_path_factory):
    """Each experiment once in JAX and once in the port, on the CPU: its
    weights after setup and the experiment after train/evaluate/
    save_results."""
    out = {}
    for name, cls in NAMES.items():
        sides = {}
        for side, pkg, common, to_state in (
                ("jax", jexp, jpretrained_common, None),
                ("port", exp, pretrained_common, True)):
            counts = []
            kw = _kwargs(name, cache, tmp_path_factory.mktemp(f"{name}{side}"))
            if to_state:
                kw["device"] = "cpu"
            e = getattr(pkg, cls)(**kw)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(common, "merge_matching",
                           _spy_merge(common, counts))
                e.setup()
            loaded = ({k: v.clone() for k, v in e.model.state_dict().items()}
                      if to_state else jax.tree.map(np.asarray,
                                                    e.state.params))
            e.train()
            e.evaluate()
            e.save_results()
            sides[side] = dict(e=e, loaded=loaded, merge=counts)
        out[name] = sides
    return out


@pytest.mark.parametrize("name", list(NAMES))
def test_experiment_csv_matches_jax(name, runs):
    je, e = runs[name]["jax"]["e"], runs[name]["port"]["e"]
    ours, theirs = e.results_row(), je.results_row()
    columns = COLUMNS[name]
    assert list(ours) == list(theirs) == columns
    for col in columns[:columns.index("model_size_mb") + 1]:
        assert ours[col] == theirs[col], col
    assert ours["sppp_tokens"] == 17 and ours["traditional_tokens"] == 17
    with open(os.path.join(e.results_dir, e.csv_filename), newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == columns and len(rows) == 2
    for key in ("traditional_complexity", "token_reduction",
                "complexity_reduction", "theoretical"):
        assert e.metrics.get(key) == je.metrics.get(key), key
    losses = (e.metrics["training"]["train_losses"]
              + [e.metrics["evaluation"]["test_loss"]])
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("name", ["e4", "e6"])
def test_pretrained_load_matches_jax(name, runs):
    jax_side, port = runs[name]["jax"], runs[name]["port"]
    assert port["e"].param_counts == jax_side["e"].param_counts
    # JAX's merge counts Flax leaves, the port's state-dict tensors: the
    # same tensors, one torch parameter a Flax leaf.
    assert port["merge"] == jax_side["merge"]
    n = len(port["loaded"])
    assert port["merge"] == [(n - 2, 0)]  # all but the random head
    assert port["e"].merge_counts == {"copied": n - 2, "skipped": 0}
    want = flax_to_state_dict_for(port["e"].model, jax_side["loaded"])
    assert sorted(want) == sorted(port["loaded"])
    for k, v in want.items():
        if not k.startswith("head."):
            assert torch.equal(port["loaded"][k], v), k
    if name == "e6":
        assert torch.equal(port["loaded"]["blocks.1.attn.latent_proj.weight"],
                           torch.eye(16))


def test_e6_groups_and_rates(runs):
    je, e = runs["e6"]["jax"]["e"], runs["e6"]["port"]["e"]
    assert e.group_lrs() == je.group_lrs() == {
        "body": 1e-4, "latent": 5e-4, "sppp": 2e-4, "head": 1e-3}
    labels = [e.label_fn(n) for n, _ in e.model.named_parameters()]
    assert labels.count("latent") == 4 and labels.count("head") == 2
    assert "sppp" not in labels and "frozen" not in labels
    bound = {g["label"]: len(g["params"])
             for g in e.state.tx.adamw.param_groups}
    assert bound == {"body": len(labels) - 6, "latent": 4, "head": 2}
    assert e.metrics["complexity_reduction"]["combined_ratio"] == (
        je.metrics["complexity_reduction"]["combined_ratio"])


def test_carried_weights_give_jax_logits(runs):
    """E2's JAX weights in the port's E2 give JAX's logits."""
    je, e = runs["e2"]["jax"]["e"], runs["e2"]["port"]["e"]
    params = jax.tree.map(np.asarray, je.state.params)
    load_flax_params_into_experiment(e, params)
    x = np.random.default_rng(9).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(je.model.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = e.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("name", list(NAMES))
def test_experiment_fields_match_jax(name):
    ours = dataclasses.fields(getattr(exp, NAMES[name]))
    theirs = dataclasses.fields(getattr(jexp, NAMES[name]))
    assert [f.name for f in ours] == [f.name for f in theirs]
    assert [f.default for f in ours] == [f.default for f in theirs]
    assert exp.SPPPPretrainedViTExperiment is exp.PretrainedSPPPExperiment


@pytest.mark.parametrize("value,want", [
    ("auto", "auto"), ("host", "host"), ("on", True), ("off", False),
    (True, True)])
def test_slic_connectivity_flag(value, want):
    e = exp.SPPPExperiment(slic_connectivity=value)
    assert e._slic_connectivity() == want
    assert jexp.SPPPExperiment(slic_connectivity=value)._slic_connectivity(
    ) == want


# --- the CLI and the conversion CLI ----------------------------------------------

CLI_TINY = ["--device", "cpu", "--pretrained_model_variant", "tiny",
            "--img_size", "32", "--patch_size", "16", "--embed_dim", "64",
            "--depth", "2", "--num_heads", "4", "--batch_size", "16",
            "--epochs", "1", "--subset_size", "32", "--no_detailed_metrics"]


@pytest.mark.parametrize("name,csv_name,columns,cls", [
    ("sppp", "exp2_sppp.csv", E2_COLUMNS, SPPPViT),
    ("sppp_pretrained", "exp3_pretrained_sppp.csv", E4_COLUMNS, SPPPViT),
    ("sppp_mhla_pretrained", "exp5_pretrained_sppp_mhla.csv", E6_COLUMNS,
     SPPPViTMHLA)])
def test_cli_runs_the_sppp_experiments(cache, tmp_path, monkeypatch, name,
                                       csv_name, columns, cls):
    monkeypatch.chdir(tmp_path)
    os.symlink(cache, tmp_path / "pretrained_weights")
    e = cli.main(["--experiment", name, *CLI_TINY, "--num_superpixels", "9",
                  "--pooling_type", "max", "--slic_connectivity", "host",
                  "--slic_iters", "3", "--compactness", "0.5",
                  "--window_size", "5"])
    assert type(e.model) is cls
    assert (e.num_superpixels, e.pooling_type, e.slic_connectivity,
            e.slic_iters, e.compactness) == (9, "max", "host", 3, 0.5)
    assert (e.model.num_superpixels, e.model.slic_connectivity) == (9, "host")
    assert getattr(e, "pretrained_loaded", True)
    assert getattr(e.model, "window_size", 5) == 5
    with open(tmp_path / "results" / csv_name, newline="") as f:
        assert next(csv.reader(f)) == columns


@pytest.mark.parametrize("name", ["cross_attention",
                                  "multihead_cross_attention"])
def test_cli_runs_cross_attention_sppp(cache, tmp_path, monkeypatch, name):
    """E7/E8 were rejected until the cross-attention family was ported:
    their SPPP sub-experiments (B, D) take the CLI's SPPP flags through to
    ``CrossAttentionSPPPViT`` and write their CSVs (the whole suites are
    held to JAX in tests/test_torch_cross_attention.py)."""
    from focused_attention_vit_tpu_torch.experiments import attention
    from focused_attention_vit_tpu_torch.models import CrossAttentionSPPPViT

    monkeypatch.setattr(attention, "SUITE", tuple(
        (n, cfg) for n, cfg in attention.SUITE if cfg["use_sppp"]))
    seen = []
    real = attention.CrossAttentionExperiment.run
    monkeypatch.setattr(attention.CrossAttentionExperiment, "run",
                        lambda self: (seen.append(self), real(self))[1])
    monkeypatch.chdir(tmp_path)
    os.symlink(cache, tmp_path / "pretrained_weights")
    assert cli.main(["--experiment", name, *CLI_TINY,
                     "--num_superpixels", "9", "--pooling_type", "max",
                     "--slic_connectivity", "off", "--slic_iters", "3",
                     "--compactness", "0.5"]) is None
    n = 5 if "multi" in name else 4
    assert [e.csv_filename for e in seen] == [
        f"exp{n}_{name}_sppp.csv", f"exp{n}_{name}_pretrained_sppp.csv"]
    for e in seen:
        assert type(e.model) is CrossAttentionSPPPViT
        assert (e.model.num_superpixels, e.model.pooling_type,
                e.model.slic_connectivity, e.model.slic_iters,
                e.model.compactness) == (9, "max", False, 3, 0.5)
        assert e.model.use_multi_head == ("multi" in name)
        assert os.path.exists(tmp_path / "results" / e.csv_filename)
    assert seen[1].pretrained_loaded and not seen[0].pretrained_loaded


def test_convert_cli_to_sppp(cache, tmp_path, capsys):
    src = os.path.join(cache, "tiny_weights.pth")
    out = tmp_path / "sppp.pt"
    assert convert_main([src, str(out), "--to", "sppp", "--depth", "2",
                         "--num_heads", "4", "--embed_dim", "64"]) == 0
    state = torch.load(out, weights_only=True)
    assert "pos_embed" not in state and "cls_token" in state
    want = C.vit_state_to_sppp(C.torchvision_vit_to_state_dict(
        torch.load(src, weights_only=True), depth=2))
    assert sorted(state) == sorted(want)
    assert all(torch.equal(state[k], v) for k, v in want.items())
    model = SPPPViT(img_size=224, patch_size=16, num_classes=1000,
                    embed_dim=64, depth=2, num_heads=4)
    model.load_state_dict(state, strict=True)
    assert "to=sppp" in capsys.readouterr().out
    # --to cross converts since the cross-attention family was ported; with
    # --drop_pos_embed it gives CrossAttentionSPPPViT's state.
    assert convert_main([src, str(tmp_path / "x.pt"), "--to", "cross",
                         "--drop_pos_embed", "--depth", "2"]) == 0
    from focused_attention_vit_tpu_torch.models import CrossAttentionSPPPViT

    CrossAttentionSPPPViT(img_size=224, patch_size=16, num_classes=1000,
                          embed_dim=64, depth=2, num_heads=4).load_state_dict(
        torch.load(tmp_path / "x.pt", weights_only=True), strict=True)
