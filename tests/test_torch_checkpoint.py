"""Checkpoint, resume and preemption in the port, on the CPU: the
``CheckpointManager`` round trip bit for bit (sync and async), retention
and temporary directories, the async snapshot taken when ``save()`` is
called, a background failure raised at the next sync point, the
params-only sidecar, ``GracefulShutdown``, the CLI in a subprocess
(SIGTERM -> exit 143 -> resume -> CSV), E1 resumed from a checkpoint
against JAX's resumed E1 (dropout 0, augmentation off, shared weights), the
hand-written Flax msgpack reader against ``flax.serialization``, and
``serve --checkpoint_dir`` on a JAX run's directory against JAX's
``Predictor.from_checkpoint`` and on a port directory.

The JAX run (one E1 in two segments, the second resumed) is made once, in
a module fixture."""

import functools
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu import experiments as jexp
from focused_attention_vit_tpu import models as jmodels
from focused_attention_vit_tpu.data import native as jnative
from focused_attention_vit_tpu.experiments import base as jbase
from focused_attention_vit_tpu.infer import Predictor as JaxPredictor
from focused_attention_vit_tpu_torch import cli, serve, train
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch.convert.flax_msgpack import (
    ExtType,
    msgpack_restore,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_to_state_dict,
)
from focused_attention_vit_tpu_torch.data.pipeline import prepare_eval_batch
from focused_attention_vit_tpu_torch.experiments import base
from focused_attention_vit_tpu_torch.infer import Predictor
from focused_attention_vit_tpu_torch.models import VisionTransformer
from focused_attention_vit_tpu_torch.train import checkpoint as ckpt
from focused_attention_vit_tpu_torch.train.resilience import GracefulShutdown

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
GEOM = dict(img_size=16, patch_size=4, num_classes=10, embed_dim=32, depth=1,
            num_heads=2)
# E1 at the tiny size with every dropout off (the two packages' dropout
# streams differ); tests/test_experiments.py:16-26.
E1 = dict(GEOM, batch_size=32, subset_size=64, dropout=0.0,
          detailed_metrics=False)
LOSS_TOL = 1e-4
PROB_TOL = 1e-5


# --- the manager -----------------------------------------------------------------

def _state(seed=0):
    model = VisionTransformer(**GEOM,
                              generator=torch.Generator().manual_seed(seed))
    return train.create_train_state(
        model, train.make_adamw(train.make_lr_schedule(
            1e-3, "cosine", total_steps=20, warmup_steps=2)), device="cpu")


U8 = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8)
LABELS = np.random.default_rng(1).integers(0, 10, 8)
STEP = train.make_train_step(16)


def _snapshot(state):
    opt = state.tx.adamw.state_dict()["state"]
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {(i, n): t.clone() for i, s in opt.items()
             for n, t in s.items()}, state.step, state.tx.count)


def _assert_equal(a, b):
    (ma, oa, sa, ca), (mb, ob, sb, cb) = a, b
    assert (sa, ca) == (sb, cb)
    assert ma.keys() == mb.keys() and oa.keys() == ob.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_round_trip_is_bit_equal(tmp_path, async_save):
    """Parameters, AdamW moments, step and the schedule's count come back
    bit for bit, and one more step from each with the same key gives the
    same bits."""
    state, _ = STEP(_state(), U8, LABELS, 0)
    mngr = ckpt.CheckpointManager(str(tmp_path), async_save=async_save)
    mngr.save(1, state)
    fresh = _state(seed=9)
    assert mngr.restore(fresh) is fresh
    _assert_equal(_snapshot(state), _snapshot(fresh))
    a, _ = STEP(state, U8, LABELS, 5)
    b, _ = STEP(fresh, U8, LABELS, 5)
    _assert_equal(_snapshot(a), _snapshot(b))
    mngr.close()
    side = ckpt.load_params(mngr.params_path())
    assert mngr.params_path() == str(tmp_path / "params_latest.pt")
    restored = torch.load(tmp_path / "1" / ckpt.STATE_FILE,
                          weights_only=True)["model"]
    assert all(torch.equal(side[k], restored[k]) for k in restored)


def test_retention_keeps_three_and_ignores_temporaries(tmp_path):
    state = _state()
    mngr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
    assert mngr.latest_step() is None and mngr.restore(state) is None
    for step in range(1, 6):
        mngr.save(step, state)
    assert mngr.latest_step() == 5
    # A crash mid-save leaves a temporary directory: never a step.
    (tmp_path / "6.tmp-123").mkdir()
    (tmp_path / "6.tmp-123" / ckpt.STATE_FILE).write_bytes(b"partial")
    (tmp_path / "7").mkdir()  # renamed, but without its file
    assert mngr.all_steps() == [3, 4, 5] and mngr.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5", "6.tmp-123", "7",
                                            "params_latest.pt"]
    mngr.restore(state, step=3)
    assert state.step == 0


def test_async_snapshot_is_taken_when_save_is_called(tmp_path, monkeypatch):
    """The background writer is held until after the next in-place AdamW
    step: what it writes is the state at the ``save()`` call."""
    release = threading.Event()
    real = ckpt._pull_to_host

    def held(*a):
        assert release.wait(30)
        return real(*a)

    monkeypatch.setattr(ckpt, "_pull_to_host", held)
    state, _ = STEP(_state(), U8, LABELS, 0)
    before = _snapshot(state)
    mngr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
    t0 = time.perf_counter()
    mngr.save(1, state)
    assert time.perf_counter() - t0 < 5
    state, _ = STEP(state, U8, LABELS, 1)  # in place, while the save waits
    assert not torch.equal(state.model.head.weight, before[0]["head.weight"])
    release.set()
    fresh = _state(seed=3)
    mngr.restore(fresh)
    _assert_equal(before, _snapshot(fresh))
    assert mngr.stats["bytes"] > 0 and mngr.stats["write_s"] >= 0


@pytest.mark.parametrize("sync_point", ["save", "restore", "latest_step",
                                        "close"])
def test_background_failure_is_raised_at_the_next_sync_point(
        tmp_path, monkeypatch, sync_point):
    state = _state()
    mngr = ckpt.CheckpointManager(str(tmp_path), async_save=True)

    def fail(*a):
        raise OSError("disk full")

    with monkeypatch.context() as mp:
        mp.setattr(mngr, "_write", fail)
        mngr.save(1, state)  # returns: the failure is in the background
        mngr._pending.join(timeout=30)
        assert not mngr._pending.is_alive()
    calls = {"save": lambda: mngr.save(2, state),
             "restore": lambda: mngr.restore(state),
             "latest_step": mngr.latest_step, "close": mngr.close}
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as e:
        calls[sync_point]()
    assert isinstance(e.value.__cause__, OSError)
    mngr.save(3, state)  # the failure is reported once
    assert mngr.latest_step() == 3


def test_save_params_is_atomic(tmp_path, monkeypatch):
    path = tmp_path / "params.pt"
    ckpt.save_params(str(path), {"w": torch.ones(3)})

    def fail(obj, f):
        Path(f).write_bytes(b"half")
        raise OSError("crash mid-write")

    monkeypatch.setattr(ckpt.torch, "save", fail)
    with pytest.raises(OSError):
        ckpt.save_params(str(path), {"w": torch.zeros(3)})
    assert os.listdir(tmp_path) == ["params.pt"]
    assert torch.equal(ckpt.load_params(str(path))["w"], torch.ones(3))


# --- GracefulShutdown -------------------------------------------------------------

def _wait(stop):
    for _ in range(200):  # delivery is checked between bytecodes
        if stop.triggered:
            return
        time.sleep(0.01)


def test_graceful_shutdown_latches_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as stop:
        assert not stop.triggered and stop() is False
        os.kill(os.getpid(), signal.SIGTERM)
        _wait(stop)
        assert stop.triggered and stop() is True
    assert signal.getsignal(signal.SIGTERM) is before


def test_graceful_shutdown_second_signal_exits():
    with GracefulShutdown() as stop:
        os.kill(os.getpid(), signal.SIGTERM)
        _wait(stop)
        with pytest.raises(SystemExit) as e:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(200):
                time.sleep(0.01)
    assert e.value.code == 128 + signal.SIGTERM


def test_graceful_shutdown_installs_nothing_off_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def run():
        with GracefulShutdown() as stop:
            seen.append((signal.getsignal(signal.SIGTERM), stop._installed))

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [(before, False)]


# --- the CLI: SIGTERM -> 143 -> resume -> CSV ----------------------------------------

@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    """A tiny CIFAR-10 in the python format the loaders read (5 training
    batches of 16 images, 16 test images): both packages load it from disk
    at once, where the synthetic stand-in takes seconds to build."""
    import pickle

    d = tmp_path_factory.mktemp("cifar") / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(7)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 16))}, f)
    return str(d.parent)


CLI_ARGS = ["--experiment", "traditional", "--device", "cpu",
            "--img_size", "16", "--patch_size", "4", "--embed_dim", "32",
            "--depth", "1", "--num_heads", "2", "--batch_size", "32",
            "--subset_size", "64", "--no_detailed_metrics"]


def test_cli_sigterm_exits_143_and_the_rerun_resumes(tmp_path, monkeypatch,
                                                     cifar):
    """The CLI in a subprocess (signals reach the main thread only): SIGTERM
    after the first epoch's line stops it with code 143, after a committed
    checkpoint and before any CSV; the same command resumes it and writes
    the CSV. The child has a time limit of its own."""
    argv = CLI_ARGS + ["--epochs", "40", "--checkpoint_dir",
                       str(tmp_path / "ckpt"), "--results_dir",
                       str(tmp_path / "results"), "--data_dir", cifar]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    p = subprocess.Popen(
        [sys.executable, "-u", "-m", "focused_attention_vit_tpu_torch.cli",
         *argv], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(120, p.kill)
    timer.start()
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if line.startswith("Epoch 1/"):
                p.send_signal(signal.SIGTERM)
        rc = p.wait()
    finally:
        timer.cancel()
    out = "".join(lines)
    assert rc == 143, out
    assert "Preempted (SIGTERM): training stopped at epoch" in out
    assert "skipping evaluation/results" in out
    mngr = ckpt.CheckpointManager(str(tmp_path / "ckpt"))
    done = mngr.latest_step()
    assert done is not None and 1 <= done < 40
    assert not (tmp_path / "results" / "exp1_traditional.csv").exists()

    # The rerun, in process, to the end: resumed, then the CSV.
    argv[argv.index("40")] = str(done + 1)
    monkeypatch.chdir(tmp_path)
    e = cli.main(argv)
    assert not e.preempted
    assert len(e.metrics["training"]["train_losses"]) == 1
    assert (tmp_path / "results" / "exp1_traditional.csv").exists()
    assert mngr.latest_step() == done + 1


def test_checkpoint_at_epochs_reevaluates(tmp_path, capsys, cifar):
    """A rerun whose checkpoint already holds every epoch trains nothing
    and reports the restored model's validation loss."""
    kw = dict(E1, epochs=1, device="cpu", checkpoint_dir=str(tmp_path / "c"),
              results_dir=str(tmp_path / "r"), data_dir=cifar,
              sync_checkpoint=True)
    first = exp.TraditionalViTExperiment(**kw)
    first.run()
    again = exp.TraditionalViTExperiment(**kw)
    again.run()
    out = capsys.readouterr().out
    assert "Resumed from checkpoint epoch 1" in out
    assert "Checkpoint already at epoch 1 >= epochs=1" in out
    assert again.metrics["training"]["train_losses"] == []
    assert abs(again.metrics["training"]["final_val_loss"]
               - first.metrics["training"]["final_val_loss"]) < 1e-6


# --- E1 resumed, against JAX's resumed E1 ---------------------------------------------

@pytest.fixture(scope="module")
def same_batches():
    """Augmentation off in both packages' experiments and JAX's numpy batch
    iterator (not its C++ prefetcher, which shuffles with another RNG):
    with dropout 0 the two trajectories then see the same batches. JAX's
    memory probes, which only measure, are left out (each is a compile)."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jbase, base):
            mp.setattr(module, "make_train_step", functools.partial(
                module.make_train_step, augment=False))
        mp.setattr(jnative, "native_available", lambda: False)
        mp.setattr(jbase.ExperimentBase, "_memory_probe",
                   lambda self, backward: {"gpu_memory_peak_mb": 0.0})
        yield


def _two_segments(make, tmp, cifar, after_setup=lambda e: None):
    """E1 trained to epoch 1, then the same run to epoch 2 (resumed from the
    first's checkpoint); returns the two experiments."""
    runs = []
    for epochs in (1, 2):
        e = make(epochs=epochs, checkpoint_dir=str(tmp / "ckpt"),
                 data_dir=cifar, results_dir=str(tmp / "res"))
        e.setup()
        after_setup(e)
        e.train()
        runs.append(e)
    return runs


@pytest.fixture(scope="module")
def jax_resumed(same_batches, cifar, tmp_path_factory):
    """JAX's E1 at the tiny size in two segments, the second resumed: its
    initial params, its checkpoint directory and the resumed experiment."""
    tmp = tmp_path_factory.mktemp("jax_resume")
    init = {}
    _, second = _two_segments(
        functools.partial(jexp.TraditionalViTExperiment, **E1), tmp, cifar,
        lambda e: init.setdefault("params",
                                  jax.tree.map(np.asarray, e.state.params)))
    return init["params"], tmp / "ckpt", second


def test_resumed_e1_matches_jax(jax_resumed, cifar, tmp_path, monkeypatch):
    init, jdir, jsecond = jax_resumed
    monkeypatch.setattr(exp.TraditionalViTExperiment, "build_params",
                        lambda self, model: model.load_state_dict(
                            flax_vit_to_state_dict(init)))
    port = _two_segments(functools.partial(
        exp.TraditionalViTExperiment, **E1, device="cpu"), tmp_path, cifar)
    tr = port[1].metrics["training"]
    jtr = jsecond.metrics["training"]
    assert len(tr["train_losses"]) == len(jtr["train_losses"]) == 1
    np.testing.assert_allclose(tr["train_losses"], jtr["train_losses"],
                               atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(tr["val_losses"], jtr["val_losses"],
                               atol=LOSS_TOL, rtol=0)
    assert port[1].state.step == 4  # two epochs of two steps
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2",
                                                     "params_latest.pt"]


# --- the msgpack reader --------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(3)
    return {
        "f32": {"dense": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                          "bias": np.zeros(4, np.float32)}},
        "bf16": {"w": jnp.asarray(rng.normal(size=(2, 5)), jnp.bfloat16),
                 "s": jnp.asarray(1.5, jnp.bfloat16)},
        "ints": {"i8": np.arange(-3, 3, dtype=np.int8),
                 "u16": np.arange(5, dtype=np.uint16),
                 "i64": np.array([2**40, -2**40], np.int64),
                 "b": np.array([True, False])},
        "scalars": {"f": np.float32(0.25), "i": np.int32(-7),
                    "d": np.float64(3.5), "py": 7, "c": 1 + 2j, "none": None,
                    "t": (1, "a", 2.5)},
        "chunked": {"big": rng.normal(size=(300,)).astype(np.float32),
                    "big_bf16": jnp.asarray(rng.normal(size=(200,)),
                                            jnp.bfloat16),
                    "small": np.ones(3, np.float32)},
    }


def _equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(got, torch.Tensor):  # bf16: the same bits
        assert got.dtype == torch.bfloat16
        w = np.asarray(want)
        assert got.shape == w.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      w.view(np.int16))
    elif isinstance(want, np.ndarray) or isinstance(want, np.generic):
        assert type(got) is type(want)
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name", list(_trees()))
def test_msgpack_reader_matches_flax(name, monkeypatch):
    """On Flax's own bytes (with ``MAX_CHUNK_SIZE`` made small, so that the
    larger leaves are written as chunked dicts)."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 256)
    data = fser.to_bytes(_trees()[name])
    if name == "chunked":
        assert b"__msgpack_chunked_array__" in data
    _equal(msgpack_restore(data), fser.msgpack_restore(data))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.5, 1e300, True, False, None, "", "x" * 31, "y" * 32, "z" * 255,
    "w" * 256, "v" * 65536, "é∑", b"", b"b" * 255, b"c" * 256, b"d" * 65536,
    list(range(15)), list(range(16)), list(range(65536)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(65536)},
    msgpack.ExtType(5, b"a"), msgpack.ExtType(6, b"ab"),
    msgpack.ExtType(7, b"abcd"), msgpack.ExtType(8, b"a" * 8),
    msgpack.ExtType(9, b"a" * 16), msgpack.ExtType(10, b"a" * 3),
    msgpack.ExtType(11, b"a" * 256), msgpack.ExtType(12, b"a" * 65536),
], ids=lambda v: f"{type(v).__name__}-{len(v) if hasattr(v, '__len__') else v}"[:40])
def test_msgpack_reader_reads_every_width(value):
    data = msgpack.packb(value, use_bin_type=True)
    got = msgpack_restore(data)
    want = msgpack.unpackb(data, raw=False, strict_map_key=False)
    if isinstance(want, msgpack.ExtType):
        assert got == ExtType(want.code, want.data)
    elif isinstance(want, float):
        assert got == want
    else:
        assert got == want and type(got) is type(want)


def test_msgpack_reader_rejects_a_truncated_file():
    data = fser.to_bytes({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="after the object"):
        msgpack_restore(data + b"\x00")


# --- serve --checkpoint_dir ------------------------------------------------------

SERVE = ["--model", "vit", "--img_size", "16", "--patch_size", "4",
         "--embed_dim", "32", "--depth", "1", "--num_heads", "2",
         "--num_classes", "10", "--compute_dtype", "float32",
         "--batch_size", "4", "--device", "cpu"]
IMAGES = np.random.default_rng(5).integers(0, 256, (6, 16, 16, 3),
                                           dtype=np.uint8)


def test_serve_a_jax_checkpoint_dir_matches_jax(jax_resumed):
    """A JAX run's directory holds only ``params_latest.msgpack``: served
    through the reader and ``from_jax``, the probabilities equal JAX's
    ``Predictor.from_checkpoint``'s."""
    _, jdir, _ = jax_resumed
    assert not (jdir / ckpt.PARAMS_FILE).exists()
    jpred = JaxPredictor.from_checkpoint(
        jmodels.VisionTransformer(**GEOM), str(jdir),
        sample_input=jnp.zeros((1, 16, 16, 3)), img_size=16, batch_size=4,
        compute_dtype=jnp.float32)
    _, pred = serve.setup(["--checkpoint_dir", str(jdir), *SERVE])
    np.testing.assert_allclose(pred.predict_proba(IMAGES),
                               jpred.predict_proba(IMAGES), atol=PROB_TOL,
                               rtol=0)


def test_serve_a_port_checkpoint_dir(tmp_path):
    """The port's own sidecar, which wins over a JAX msgpack beside it."""
    state = _state(seed=4)
    mngr = ckpt.CheckpointManager(str(tmp_path))
    mngr.save(1, state)
    (tmp_path / "params_latest.msgpack").write_bytes(b"not read")
    _, pred = serve.setup(["--checkpoint_dir", str(tmp_path), *SERVE])
    model = state.model.eval()
    with torch.inference_mode():
        want = torch.softmax(model(prepare_eval_batch(
            torch.from_numpy(IMAGES), 16)), -1)
    np.testing.assert_allclose(pred.predict_proba(IMAGES), want.numpy(),
                               atol=1e-6, rtol=0)
    with pytest.raises(FileNotFoundError, match="no params sidecar"):
        Predictor.from_checkpoint(VisionTransformer(**GEOM),
                                  str(tmp_path / "empty"), img_size=16,
                                  device="cpu")
