"""The port's metrics, experiment base, E1 ``traditional`` and CLI against
the JAX package, on the CPU at a tiny size: the complexity formulas number
for number, the one-row CSV and its schema, evaluation on weights carried
across from a JAX E1 run, the memory probes, the microbatch rules and the
flags the port rejects by name. The JAX experiment runs once per module."""

import dataclasses
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from focused_attention_vit_tpu import experiments as jexp
from focused_attention_vit_tpu.cli import parse_args as jax_parse_args
from focused_attention_vit_tpu.utils import metrics as jmetrics
from focused_attention_vit_tpu_torch import cli
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch.convert.from_jax import (
    load_flax_params_into_experiment,
)
from focused_attention_vit_tpu_torch.models import VisionTransformer
from focused_attention_vit_tpu_torch.ops import mha_kernel as mha
from focused_attention_vit_tpu_torch.utils import metrics

torch.set_num_threads(2)

# tests/test_experiments.py:16-26.
TINY = dict(
    img_size=16,
    patch_size=4,
    num_classes=10,
    embed_dim=32,
    depth=1,
    num_heads=2,
    batch_size=32,
    epochs=1,
    subset_size=64,
)
# tests/test_experiments.py:43-49.
E1_COLUMNS = [
    "model", "img_size", "patch_size", "embed_dim", "depth", "num_heads",
    "parameters", "flops", "time_complexity", "space_complexity_mb",
    "model_size_mb", "avg_epoch_time", "total_training_time",
    "final_val_acc", "final_val_loss", "test_acc", "test_loss",
    "avg_inference_time_per_image", "peak_gpu_memory_mb",
]
DETERMINISTIC = E1_COLUMNS[:11]


_DATA = {}


@pytest.fixture(autouse=True)
def one_synthetic_dataset(monkeypatch):
    """Every ``setup()`` of the port in this module loads the same tiny
    subset of the synthetic stand-in (no data directory exists); build the
    50,000 images it is cut from once."""
    from focused_attention_vit_tpu_torch.experiments import base

    real = base.load_dataset

    def cached(name, data_dir, subset_size, seed):
        key = (name, subset_size, seed)
        if key not in _DATA:
            _DATA[key] = real(name, data_dir=data_dir,
                              subset_size=subset_size, seed=seed)
        return dict(_DATA[key])

    monkeypatch.setattr(base, "load_dataset", cached)


@pytest.fixture()
def dirs(tmp_path):
    return dict(data_dir=str(tmp_path / "data"),
                results_dir=str(tmp_path / "results"))


@pytest.fixture(scope="module")
def jax_e1(tmp_path_factory):
    """One JAX E1 run at the tiny size: the experiment after ``run()``."""
    tmp = tmp_path_factory.mktemp("jax_e1")
    e = jexp.TraditionalViTExperiment(
        **TINY, data_dir=str(tmp / "data"), results_dir=str(tmp / "results"))
    e.run()
    return e


@pytest.fixture(scope="module")
def port_e1(tmp_path_factory):
    """One port E1 run at the tiny size on the CPU."""
    tmp = tmp_path_factory.mktemp("port_e1")
    e = exp.TraditionalViTExperiment(
        **TINY, device="cpu", data_dir=str(tmp / "data"),
        results_dir=str(tmp / "results"))
    e.run()
    return e


# --- (e) utils/metrics -----------------------------------------------------------


@pytest.mark.parametrize("img,patch,dim,depth,heads,ratio,chans", [
    (224, 16, 768, 12, 12, 4.0, 3),
    (224, 4, 768, 12, 12, 4.0, 3),
    (16, 4, 32, 1, 2, 4.0, 3),
    (32, 8, 64, 3, 4, 2.5, 1),
    (96, 4, 48, 2, 3, 3.0, 3),
])
def test_vit_complexity_matches_jax(img, patch, dim, depth, heads, ratio,
                                    chans):
    args = (img, patch, dim, depth, heads, ratio, chans)
    assert metrics.calculate_vit_complexity(*args) == (
        jmetrics.calculate_vit_complexity(*args))


def test_vit_b16_complexity_is_pinned():
    got = metrics.calculate_vit_complexity(224, 16, 768, 12, 12)
    assert got == {
        "parameters": 86548456,  # with the reference's 1000-class head
        "flops": 17920723968,
        "time_complexity": 17920723968,
        "space_complexity_bytes": 354666400,
        "space_complexity_mb": 354666400 / (1024 * 1024),
    }


@pytest.mark.parametrize("kw", [
    dict(img_size=16, patch_size=4, num_classes=10, embed_dim=32, depth=1,
         num_heads=2),
    dict(img_size=32, patch_size=8, num_classes=7, embed_dim=48, depth=2,
         num_heads=3, mlp_ratio=2.0),
])
def test_model_size_matches_jax(kw):
    import jax.numpy as jnp

    from focused_attention_vit_tpu.models import (
        VisionTransformer as JaxVisionTransformer,
    )

    model = VisionTransformer(**kw)
    size = kw["img_size"]
    params = JaxVisionTransformer(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"]
    want = jmetrics.calculate_model_size(params)
    assert metrics.calculate_model_size(model) == want
    assert metrics.calculate_model_size(model.state_dict()) == want
    assert metrics.count_parameters(model.parameters()) == (
        want["parameters"])


def test_timing_and_memory_measurements_on_the_cpu():
    model = VisionTransformer(img_size=16, patch_size=4, num_classes=5,
                              embed_dim=32, depth=1, num_heads=2).eval()
    x = torch.zeros(2, 16, 16, 3)
    t = metrics.measure_inference_time(model, x, num_iterations=3, warm_up=1)
    assert set(t) == {"total_time", "avg_time", "fps"}
    assert t["avg_time"] > 0 and t["fps"] == pytest.approx(3 / t["total_time"])

    calls = []

    def step(state, a):
        calls.append(a)
        return state + 1, torch.tensor(0.0)

    t, state = metrics.measure_training_time(step, 0, "x", num_iterations=4)
    assert state == 5 and len(calls) == 5  # one warm-up step
    assert set(t) == {"total_time", "avg_time", "iterations_per_second"}

    params = list(model.parameters())
    for backward in (False, True):
        m = metrics.measure_memory_usage(lambda x, _p: model(x), x, params,
                                         backward=backward)
        assert set(m) == set(jmetrics.measure_memory_usage(
            lambda a: a, np.zeros(1)))
        assert m["cpu_memory_before_bytes"] > 0
        assert m["gpu_memory_peak_mb"] == 0.0  # no device on the CPU
    assert all(p.grad is None for p in params)  # the probe leaves no .grad


def test_rss_without_psutil(monkeypatch):
    monkeypatch.setattr(metrics, "psutil", None)
    assert metrics._rss_bytes() > 2**20


def test_benchmark_model_on_the_cpu():
    model = VisionTransformer(img_size=16, patch_size=4, num_classes=5,
                              embed_dim=32, depth=1, num_heads=2)
    out = metrics.benchmark_model(
        model, (16, 16, 3), num_classes=5, batch_size=2,
        num_inference_iterations=2, num_training_iterations=2, warm_up=1)
    assert out["theoretical"]["model_size"]["parameters"] == (
        metrics.count_parameters(model))
    assert set(out["actual"]) == {
        "inference_time", "training_time", "memory_usage_inference",
        "memory_usage_training"}
    assert all(p.grad is None for p in model.parameters())


# --- (f) E1 at the tiny size -----------------------------------------------------


def test_experiment_fields_match_jax():
    """The same dataclass fields in the same order; the defaults too, but
    for ``auto_microbatch``, which the port leaves off (the JAX value is a
    TPU measurement)."""
    ours = dataclasses.fields(exp.TraditionalViTExperiment)
    theirs = dataclasses.fields(jexp.TraditionalViTExperiment)
    assert [f.name for f in ours] == [f.name for f in theirs]
    differ = [a.name for a, b in zip(ours, theirs) if a.default != b.default]
    assert differ == ["auto_microbatch"]
    assert exp.TraditionalViTExperiment.auto_microbatch is None
    for method in ("setup", "train", "evaluate", "save_results", "run"):
        assert callable(getattr(exp.ExperimentBase, method))
    assert exp.__all__ == ["ExperimentBase", "TraditionalViTExperiment",
                           "SPPPExperiment",
                           "PretrainedTraditionalViTExperiment",
                           "PretrainedSPPPExperiment",
                           "SPPPPretrainedViTExperiment",
                           "PretrainedMHLAViTExperiment",
                           "PretrainedSPPPMHLAExperiment",
                           "CrossAttentionExperiment",
                           "run_cross_attention_experiments",
                           "run_multihead_cross_attention_experiments"]
    # Every name JAX exports, E7/E8's runners included.
    assert set(jexp.__all__) <= set(exp.__all__)


def test_e1_csv_has_the_reference_schema(port_e1):
    path = os.path.join(port_e1.results_dir, "exp1_traditional.csv")
    frame = pd.read_csv(path)
    assert list(frame.columns) == E1_COLUMNS
    assert len(frame) == 1
    row = frame.iloc[0]
    assert row["model"] == "Traditional ViT"
    assert np.isfinite(row[E1_COLUMNS[1:]].astype(float)).all()
    assert row["peak_gpu_memory_mb"] == 0.0  # ran on the CPU
    assert row["avg_epoch_time"] > 0 and row["total_training_time"] > 0
    assert list(port_e1.results_row()) == E1_COLUMNS


def test_e1_deterministic_columns_match_jax(port_e1, jax_e1):
    ours, theirs = port_e1.results_row(), jax_e1.results_row()
    assert list(ours) == list(theirs)
    for col in DETERMINISTIC:
        assert ours[col] == theirs[col], col
    theory = metrics.calculate_vit_complexity(16, 4, 32, 1, 2)
    assert ours["parameters"] == theory["parameters"]
    assert ours["flops"] == theory["flops"]


def test_e1_trains_probes_and_saves_the_confusion_matrix(port_e1):
    tr = port_e1.metrics["training"]
    assert len(tr["train_losses"]) == 1 and np.isfinite(tr["train_losses"][0])
    assert np.isfinite(tr["final_val_loss"])
    # Before, at epochs // 2 (= epoch 0 of 1, with a backward) and after.
    assert len(tr["memory_usage"]) == 3
    cm = np.load(os.path.join(port_e1.results_dir,
                              "exp1_traditional_confusion.npy"))
    assert cm.shape == (10, 10)
    assert cm.sum() == len(port_e1.data["test_labels"])
    det = port_e1.metrics["evaluation_detailed"]
    assert 0.0 <= det["auc_macro_ovr"] <= 1.0


def test_mid_run_probe_fires_once_at_half(dirs, monkeypatch):
    e = exp.TraditionalViTExperiment(**{**TINY, "epochs": 3}, device="cpu",
                                     detailed_metrics=False, **dirs)
    e.setup()
    probes = []
    real = e._memory_probe
    monkeypatch.setattr(
        e, "_memory_probe",
        lambda backward: probes.append(backward) or real(backward))
    e.train()
    assert probes == [False, True, False]
    assert len(e.metrics["training"]["train_losses"]) == 3


# --- (g) evaluation on weights carried across ------------------------------------


def test_evaluate_on_jax_weights_matches_jax(jax_e1, dirs):
    e = exp.TraditionalViTExperiment(**TINY, device="cpu", **dirs)
    e.setup()
    np.testing.assert_array_equal(e.data["test_images"],
                                  jax_e1.data["test_images"])
    params = jax.tree.map(np.asarray, jax_e1.state.params)
    load_flax_params_into_experiment(e, params)
    e.evaluate()
    ours, theirs = e.metrics["evaluation"], jax_e1.metrics["evaluation"]
    assert abs(ours["test_loss"] - theirs["test_loss"]) < 1e-4
    assert ours["test_acc"] == pytest.approx(theirs["test_acc"], abs=1e-9)
    np.testing.assert_array_equal(
        e.metrics["evaluation_detailed"]["confusion_matrix"],
        jax_e1.metrics["evaluation_detailed"]["confusion_matrix"])


def test_evaluate_with_the_fused_switch_on_gives_the_same_loss(
        jax_e1, dirs, monkeypatch):
    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    e = exp.TraditionalViTExperiment(**TINY, device="cpu",
                                     detailed_metrics=False, **dirs)
    e.setup()
    load_flax_params_into_experiment(
        e, jax.tree.map(np.asarray, jax_e1.state.params))
    e.evaluate()
    assert abs(e.metrics["evaluation"]["test_loss"]
               - jax_e1.metrics["evaluation"]["test_loss"]) < 1e-4
    assert [mha.launch_count(k) for k in mha.LAUNCH_KINDS] == [0, 0, 0]


# --- (h) rejected flags, microbatch rules, the CLI --------------------------------

BASE_ARGS = ["--experiment", "traditional", "--device", "cpu"]
REJECTED = [
    (["--dataset", "imagenet"], "dataset"),
    (["--profile_dir", "prof"], "profile_dir"),
    (["--remat"], "remat"),
    (["--remat_policy", "full"], "remat_policy"),
    (["--scan_layers"], "scan_layers"),
    (["--num_devices", "4"], "num_devices"),
    (["--tp", "2"], "tp"),
    (["--sp", "2"], "sp"),
    (["--pp", "2"], "pp"),
    (["--fsdp"], "fsdp"),
    (["--mu_dtype", "bfloat16"], "mu_dtype"),
    (["--visualize"], "visualize"),
]


@pytest.mark.parametrize("extra,flag", REJECTED, ids=[f for _, f in REJECTED])
def test_cli_rejects_what_is_not_ported(extra, flag, dirs, tmp_path,
                                        monkeypatch):
    """Each of these flags was refused by name until it was ported
    (tests/test_torch_train_flags.py runs the training flags,
    tests/test_torch_data_utils.py the data flags,
    tests/test_torch_parallel.py the mesh flags and
    tests/test_torch_sequence_pipeline.py ``--sp`` and ``--pp``): each now
    passes the CLI's checks and reaches the experiment's field
    (``--visualize``, which the CLI acts on itself, its parsed value)."""
    monkeypatch.chdir(tmp_path)
    argv = BASE_ARGS + extra + ["--data_dir", dirs["data_dir"],
                                "--results_dir", dirs["results_dir"]]
    args = cli.parse_args(argv)
    cli.reject_unsupported(args)
    if flag == "visualize":
        assert args.visualize is True
        return
    e = exp.TraditionalViTExperiment(**cli._common_kwargs(args))
    assert getattr(e, flag) == getattr(args, flag) != getattr(
        exp.TraditionalViTExperiment, flag)


CLI_TINY = ["--device", "cpu", "--img_size", "16", "--patch_size", "4",
            "--embed_dim", "32", "--depth", "1", "--num_heads", "2",
            "--batch_size", "32", "--subset_size", "64",
            "--no_detailed_metrics"]


@pytest.mark.parametrize("extra,sync", [
    (["--checkpoint_dir", "ckpt"], False),
    (["--checkpoint_dir", "ckpt", "--sync_checkpoint"], True)],
    ids=["checkpoint_dir", "sync_checkpoint"])
def test_cli_takes_the_checkpoint_flags(extra, sync, dirs, tmp_path,
                                        monkeypatch):
    """Were rejected until checkpointing was ported: each epoch is saved
    (in the background unless --sync_checkpoint) with the params sidecar,
    and the CSV is written."""
    from focused_attention_vit_tpu_torch.train import checkpoint

    seen = []
    real = checkpoint.CheckpointManager.__init__

    def spy(self, directory, max_to_keep=3, async_save=False):
        seen.append(async_save)
        real(self, directory, max_to_keep, async_save)

    monkeypatch.setattr(checkpoint.CheckpointManager, "__init__", spy)
    monkeypatch.chdir(tmp_path)
    e = cli.main(["--experiment", "traditional", *CLI_TINY, "--epochs", "2",
                  *extra, "--data_dir", dirs["data_dir"], "--results_dir",
                  dirs["results_dir"]])
    assert seen == [not sync] and not e.preempted
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2",
                                                     "params_latest.pt"]
    assert os.path.exists(os.path.join(dirs["results_dir"],
                                       "exp1_traditional.csv"))


@pytest.mark.parametrize("name", ["cross_attention",
                                  "multihead_cross_attention"])
def test_cli_dispatches_the_cross_attention_suites(name, tmp_path,
                                                   monkeypatch):
    """E7 and E8 were rejected until ported: the CLI runs the batch runner,
    which returns no experiment (so it never exits with 143), and refuses
    a checkpoint directory that its four runs would share."""
    calls = []
    for runner in ("run_cross_attention_experiments",
                   "run_multihead_cross_attention_experiments"):
        monkeypatch.setattr(exp, runner,
                            lambda args, r=runner: calls.append((r, args)))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--experiment", name, "--device", "cpu"]) is None
    want = ("run_multihead_cross_attention_experiments" if "multi" in name
            else "run_cross_attention_experiments")
    assert [c[0] for c in calls] == [want]
    assert calls[0][1].experiment == name
    with pytest.raises(ValueError, match="--checkpoint_dir"):
        cli.main(["--experiment", name, "--device", "cpu",
                  "--checkpoint_dir", "ckpt"])


@pytest.mark.parametrize("flag,value", [
    ("profile_dir", "x"), ("remat", True), ("remat_policy", "x"),
    ("scan_layers", True), ("sp", 2), ("pp", 2),
    ("dataset", "imagenet"), ("mu_dtype", "bfloat16"),
    ("num_devices", 2), ("tp", 2), ("fsdp", True)])
def test_experiment_rejects_what_is_not_ported(flag, value, dirs):
    """Each of these fields was refused by name until it was ported: the
    model or the optimizer carries them now, and a ``remat_policy`` without
    ``remat`` is refused as in JAX; ``dataset="imagenet"`` reads
    ``<data_dir>/imagenet`` and names it when it is missing; the mesh
    fields need the ranks of a process group (``--fsdp`` a mesh, as in JAX;
    ``--sp`` and ``--pp`` ask for one, which one CPU device cannot
    hold)."""
    e = exp.TraditionalViTExperiment(**TINY, device="cpu", **dirs,
                                     **{flag: value})
    if flag in ("dataset", "num_devices", "tp", "fsdp", "sp", "pp"):
        err, match = {
            "dataset": (FileNotFoundError, "imagenet"),
            "num_devices": (RuntimeError, "ranks are not started"),
            "sp": (ValueError,
                   r"tp=1 \* sp=2 \* pp=1 must divide device count 1"),
            "pp": (ValueError,
                   r"tp=1 \* sp=1 \* pp=2 must divide device count 1"),
            "tp": (ValueError, "tp=2 must divide device count 1"),
            "fsdp": (ValueError, "--fsdp requires a device mesh"),
        }[flag]
        with pytest.raises(err, match=match):
            e.setup()
        return
    e.torch_device = torch.device("cpu")
    e.model = e.build_model()
    if flag == "remat_policy":
        with pytest.raises(ValueError, match="only applies under"):
            e._check_remat_flags()
        return
    e._check_remat_flags()
    if flag in ("remat", "scan_layers"):
        assert getattr(e.model, flag) is True
    if flag == "mu_dtype":
        assert e.build_optimizer().mu_dtype == torch.bfloat16


@pytest.mark.parametrize("flag", ["checkpoint_dir", "sync_checkpoint"])
def test_experiment_takes_the_checkpoint_fields(flag, dirs, tmp_path):
    """Were rejected by name until checkpointing was ported: with a
    checkpoint directory (saves in the background, or blocking with
    ``sync_checkpoint``) a second run to more epochs resumes from the
    first's last epoch and trains only the rest."""
    kw = dict(TINY, device="cpu", detailed_metrics=False, **dirs,
              checkpoint_dir=str(tmp_path / "ckpt"),
              sync_checkpoint=flag == "sync_checkpoint")
    first = exp.TraditionalViTExperiment(**kw)
    first.run()
    second = exp.TraditionalViTExperiment(**{**kw, "epochs": 2})
    second.run()
    assert len(second.metrics["training"]["train_losses"]) == 1
    assert second.state.step == 4 and not second.preempted
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2",
                                                     "params_latest.pt"]


def test_cli_flag_surface_matches_jax():
    argv = ["--experiment", "traditional"]
    ours, theirs = vars(cli.parse_args(argv)), vars(jax_parse_args(argv))
    assert ours == theirs
    kwargs = cli._common_kwargs(cli.parse_args(argv))
    names = {f.name for f in dataclasses.fields(exp.TraditionalViTExperiment)
             if f.init}
    assert set(kwargs) <= names


def test_effective_microbatch_rules(dirs):
    e = exp.TraditionalViTExperiment(batch_size=128, **dirs)
    assert e._effective_microbatch() is None  # auto is off in the port
    e.auto_microbatch = 16
    assert e._effective_microbatch() == 16  # an auto value that divides
    e.auto_microbatch = 50
    assert e._effective_microbatch() is None  # auto falls back silently
    e.microbatch = 0
    assert e._effective_microbatch() is None  # 0 disables
    e.microbatch = 50  # not a divisor of 128: explicit flag errors loudly
    with pytest.raises(ValueError, match="divisor"):
        e._effective_microbatch()
    e.microbatch = 128  # == batch_size: no chunking possible, also loud
    with pytest.raises(ValueError, match="divisor"):
        e._effective_microbatch()
    e.microbatch = 64
    assert e._effective_microbatch() == 64
    e.microbatch = -1
    with pytest.raises(ValueError, match="positive"):
        e._effective_microbatch()


def test_lr_for_and_optimizer(dirs):
    e = exp.TraditionalViTExperiment(**TINY, device="cpu", **dirs)
    assert e.lr_for(1e-3) == 1e-3  # reference protocol: a bare float
    e.lr_schedule, e.warmup_epochs, e.epochs = "cosine", 1.0, 4
    e.data = {"train_images": np.zeros((64, 1))}  # 2 steps an epoch
    sched = e.lr_for(1e-3)
    assert sched(0) == 0.0 and sched(2) == pytest.approx(1e-3)
    assert sched(8) == pytest.approx(0.0, abs=1e-12)
    e.grad_clip_norm = 1.0
    spec = e.build_optimizer()
    assert spec.grad_clip_norm == 1.0 and spec.weight_decay == 0.05


def test_dataset_class_count_overrides_config(dirs):
    e = exp.TraditionalViTExperiment(**{**TINY, "num_classes": 7},
                                     device="cpu", **dirs)
    e.setup()
    assert e.num_classes == 10
    assert e.model.num_classes == 10


def test_experiment_without_cuda_raises(dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    e = exp.TraditionalViTExperiment(**TINY, **dirs)  # device=None: the card
    with pytest.raises(RuntimeError, match="CUDA"):
        e.setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--experiment", "traditional"])


def test_cli_dispatch_writes_the_csv(dirs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cli.main([
        "--experiment", "traditional", "--device", "cpu",
        "--img_size", "16", "--patch_size", "4", "--embed_dim", "32",
        "--depth", "1", "--num_heads", "2", "--batch_size", "32",
        "--epochs", "1", "--subset_size", "64", "--no_detailed_metrics",
        "--data_dir", dirs["data_dir"], "--results_dir", dirs["results_dir"],
    ])
    path = os.path.join(dirs["results_dir"], "exp1_traditional.csv")
    assert list(pd.read_csv(path).columns) == E1_COLUMNS
    assert not os.path.exists(os.path.join(
        dirs["results_dir"], "exp1_traditional_confusion.npy"))
    assert "Experiment completed!" in capsys.readouterr().out


def test_traditional_main_runs(dirs, tmp_path, monkeypatch):
    from focused_attention_vit_tpu_torch.experiments import traditional

    monkeypatch.setattr(
        traditional.TraditionalViTExperiment, "run",
        lambda self: dirs.setdefault("seen", (self.img_size, self.patch_size,
                                              self.device)))
    traditional.main(["--img_size", "32", "--device", "cpu",
                      "--data_dir", dirs["data_dir"],
                      "--results_dir", dirs["results_dir"]])
    assert dirs["seen"] == (32, 16, "cpu")
