"""The single-card training flags of the port against the JAX package:
``mu_dtype=bfloat16`` (the port's ``MuDtypeAdamW`` against
``optax.adamw(mu_dtype=jnp.bfloat16)``, and its checkpoint), ``remat`` and
``remat_policy`` (gradients and the dropout generators against the run
without remat, what ``band_weights`` saves, JAX's refusals),
``profile_dir`` and ``scan_layers`` through the CLI.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from focused_attention_vit_tpu_torch import cli, train
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch.models import (
    VisionTransformer,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.models.layers import (
    DropoutRNG,
    resolve_remat_policy,
)
from focused_attention_vit_tpu_torch.models.vit import SCAN_LAYERS_NOTE
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from focused_attention_vit_tpu_torch.train.state import MuDtypeAdamW
from focused_attention_vit_tpu_torch.utils import profiling

torch.set_num_threads(2)

LR, WD = 1e-3, 0.05
SHAPES = {"w": (24, 16), "b": (16,), "scale": (3, 5, 7)}
STEPS = 5


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


class _Leaves(nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, nn.Parameter(torch.from_numpy(v)))


@pytest.fixture(scope="module")
def optax_run():
    """The JAX package's ``make_adamw(mu_dtype=jnp.bfloat16)`` (optax's
    adamw) over STEPS updates: params and first moment after each."""
    from focused_attention_vit_tpu.train import state as jstate

    tx = jstate.make_adamw(LR, WD, mu_dtype=jnp.bfloat16)
    params = jax.tree.map(jnp.asarray, _params())
    opt = tx.init(params)
    out = []
    for step in range(STEPS):
        grads = jax.tree.map(jnp.asarray, _grads(step))
        updates, opt = tx.update(grads, opt, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        out.append(({k: np.asarray(v) for k, v in params.items()},
                    {k: np.asarray(v.astype(jnp.float32))
                     for k, v in opt[0].mu.items()},
                    {k: str(v.dtype) for k, v in opt[0].mu.items()}))
    return out


def _port_optimizer(params, mu_dtype=torch.bfloat16):
    model = _Leaves(params)
    return model, train.make_adamw(LR, WD, mu_dtype=mu_dtype).bind(model)


def _port_step(model, opt, step):
    for k, g in _grads(step).items():
        getattr(model, k).grad = torch.from_numpy(g)
    opt.step()


@pytest.mark.parametrize("steps", [1, STEPS])
def test_bf16_first_moment_matches_optax(optax_run, steps):
    """One and five updates: params within 1e-6 of optax's, the stored
    first moment bf16 and bit-equal to optax's after its bf16 cast."""
    model, opt = _port_optimizer(_params())
    assert isinstance(opt.adamw, MuDtypeAdamW)
    for step in range(steps):
        _port_step(model, opt, step)
    want_p, want_mu, mu_dtypes = optax_run[steps - 1]
    assert set(mu_dtypes.values()) == {"bfloat16"}
    for k in SHAPES:
        p = getattr(model, k)
        np.testing.assert_allclose(p.detach().numpy(), want_p[k], atol=1e-6,
                                   rtol=0)
        mu = opt.adamw.state[p]["exp_avg"]
        assert mu.dtype == torch.bfloat16
        np.testing.assert_array_equal(mu.float().numpy(), want_mu[k])
        assert opt.adamw.state[p]["exp_avg_sq"].dtype == torch.float32


def test_f32_first_moment_stays_torch_adamw():
    """The default (and ``mu_dtype=torch.float32``) keeps
    ``torch.optim.AdamW``, so the existing trajectories do not move; the
    grouped optimizer passes ``mu_dtype`` to every group."""
    for mu_dtype in (None, torch.float32, "float32"):
        _, opt = _port_optimizer(_params(), mu_dtype)
        assert type(opt.adamw) is torch.optim.AdamW
    spec = train.make_grouped_optimizer(
        lambda n: "head" if n == "b" else "body", {"head": LR, "body": LR},
        mu_dtype=torch.bfloat16)
    opt = spec.bind(_Leaves(_params()))
    assert isinstance(opt.adamw, MuDtypeAdamW)
    assert [g["label"] for g in opt.adamw.param_groups] == ["head", "body"]


def test_bf16_first_moment_checkpoint_resumes_bit_equal(tmp_path):
    """A bf16-mu state saved by ``CheckpointManager`` restores with its
    moments' dtypes and bits, and the next update from each is equal."""
    model, opt = _port_optimizer(_params())
    state = train.TrainState(model=model, tx=opt)
    for step in range(2):
        _port_step(model, opt, step)
        state.step += 1
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(2, state)
    mngr.close()
    model2, opt2 = _port_optimizer({k: np.zeros(s, np.float32)
                                    for k, s in SHAPES.items()})
    restored = CheckpointManager(str(tmp_path)).restore(
        train.TrainState(model=model2, tx=opt2))
    assert restored.tx.count == 2 and restored.step == 2
    for k in SHAPES:
        a, b = opt.adamw.state[getattr(model, k)], opt2.adamw.state[
            getattr(model2, k)]
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert a[name].dtype == b[name].dtype and torch.equal(
                a[name], b[name]), (k, name)
    _port_step(model, opt, 2)
    _port_step(model2, opt2, 2)
    for k in SHAPES:
        assert torch.equal(getattr(model, k), getattr(model2, k))


# --- remat ------------------------------------------------------------------

GEOM = dict(num_classes=10, embed_dim=32, depth=2, num_heads=2,
            dropout=0.1, attn_dropout=0.1)
# (model, image size): S = 65 (the MHLA dense band, dense attention's
# materialised softmax) and S = 577 (> 512: the band op's plain version,
# the query-chunked dense dropout).
REMAT_CASES = [("vit_mhla", 32), ("vit_mhla", 96), ("vit", 32), ("vit", 96)]


def _remat_run(name, img, **kw):
    cls = VisionTransformerMHLA if name == "vit_mhla" else VisionTransformer
    model = cls(img_size=img, patch_size=4, **GEOM, **kw,
                generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, img, img, 3, generator=torch.Generator().manual_seed(1))
    rng = DropoutRNG(5)
    out = model(x, rng)
    out.square().sum().backward()
    return (out.detach(), {n: p.grad for n, p in model.named_parameters()},
            rng.host.get_state(), rng.device.get_state())


@pytest.mark.parametrize("name,img", REMAT_CASES,
                         ids=[f"{n}-{i}" for n, i in REMAT_CASES])
def test_remat_gradients_and_generators_match(name, img):
    """With dropout 0.1 everywhere: the outputs, the gradients (within
    1e-6, f32) and the dropout generators' states after the step with
    remat (and with ``band_weights`` on the MHLA model) equal those without
    remat."""
    ref = _remat_run(name, img)
    variants = [dict(remat=True)]
    if name == "vit_mhla":
        variants += [dict(remat=True, remat_policy="band_weights"),
                     dict(remat=True, remat_policy="full")]
    for kw in variants:
        got = _remat_run(name, img, **kw)
        assert torch.equal(got[0], ref[0]), kw
        for n, g in ref[1].items():
            torch.testing.assert_close(got[1][n], g, atol=1e-6, rtol=0)
        assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])


class _CountOp(TorchDispatchMode):
    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is self.op
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("img,op", [
    (96, "favit::band_fwd_train"), (32, "aten::_softmax")],
    ids=["band_op", "dense_band"])
@pytest.mark.parametrize("policy,per_block", [
    (None, 1), ("full", 2), ("band_weights", 1)])
def test_band_weights_are_saved_not_recomputed(img, op, policy, per_block):
    """The op that makes the band's weights runs once a block a step
    without remat, twice under full remat (the recompute) and once under
    ``band_weights``, whose policy saves its outputs: K1's training form
    (``favit::band_fwd_train``) at S=577, the dense band's softmax at
    S=65."""
    ns, name = op.split("::")
    target = getattr(getattr(torch.ops, ns), name).default
    kw = {} if policy is None else dict(remat=True, remat_policy=policy)
    with _CountOp(target) as count:
        _remat_run("vit_mhla", img, **kw)
    assert count.n == GEOM["depth"] * per_block


def test_resolve_remat_policy_matches_jax():
    from focused_attention_vit_tpu.models.layers import (
        resolve_remat_policy as jax_resolve,
    )

    assert resolve_remat_policy(None) is None
    assert resolve_remat_policy("full") is None
    assert callable(resolve_remat_policy("band_weights"))
    with pytest.raises(ValueError) as got:
        resolve_remat_policy("everything")
    with pytest.raises(ValueError) as want:
        jax_resolve("everything")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        VisionTransformerMHLA(img_size=16, patch_size=4, **GEOM,
                              remat=True, remat_policy="x")


TINY = dict(img_size=16, patch_size=4, num_classes=10, embed_dim=32,
            depth=1, num_heads=2, batch_size=32, epochs=1, subset_size=64,
            device="cpu")


@pytest.mark.parametrize("cls,kw,match", [
    (exp.TraditionalViTExperiment, dict(remat=True,
                                        remat_policy="band_weights"),
     "--remat_policy is not supported by VisionTransformer"),
    (exp.SPPPExperiment, dict(remat=True),
     "--remat is not supported by SPPPViT"),
    (exp.SPPPExperiment, dict(scan_layers=True),
     "--scan_layers is not supported by SPPPViT"),
], ids=["vit_band_weights", "sppp_remat", "sppp_scan_layers"])
def test_experiment_refuses_the_flags_as_jax(cls, kw, match, tmp_path):
    """JAX's rules in ``setup``: a flag on a model without the option is a
    ValueError naming both."""
    e = cls(**TINY, data_dir=str(tmp_path), results_dir=str(tmp_path), **kw)
    e.torch_device = torch.device("cpu")
    e.model = e.build_model()
    with pytest.raises(ValueError, match=match):
        e._check_remat_flags()


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    """A tiny CIFAR-10 in the python format: 5 batches of 16 and a test
    batch of 16."""
    d = tmp_path_factory.mktemp("cifar") / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(7)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 16))}, f)
    return str(d.parent)


def test_cli_runs_the_train_flags(cifar, tmp_path, monkeypatch, capsys):
    """``--profile_dir`` writes one trace file, ``--scan_layers`` runs and
    says on stderr that it is a no-op, ``--remat`` and ``--mu_dtype
    bfloat16`` reach the model and the optimizer; the CSV is written."""
    monkeypatch.chdir(tmp_path)
    prof = tmp_path / "prof"
    e = cli.main(["--experiment", "traditional", "--device", "cpu",
                  "--img_size", "16", "--patch_size", "4", "--embed_dim",
                  "32", "--depth", "1", "--num_heads", "2", "--batch_size",
                  "32", "--subset_size", "64", "--epochs", "1",
                  "--no_detailed_metrics", "--data_dir", cifar,
                  "--results_dir", str(tmp_path / "results"),
                  "--profile_dir", str(prof), "--scan_layers", "--remat",
                  "--mu_dtype", "bfloat16"])
    assert SCAN_LAYERS_NOTE in capsys.readouterr().err
    assert os.listdir(prof) == [profiling.TRACE_FILE]
    assert '"traceEvents"' in (prof / profiling.TRACE_FILE).read_text()
    assert e.model.remat and e.model.scan_layers
    assert isinstance(e.state.tx.adamw, MuDtypeAdamW)
    assert all(s["exp_avg"].dtype == torch.bfloat16
               for s in e.state.tx.adamw.state.values())
    assert os.path.exists(tmp_path / "results" / "exp1_traditional.csv")


def test_profiling_helpers(tmp_path):
    """``trace(None)`` is a no-op; ``annotate`` names a range in a trace;
    ``wallclock`` stores the elapsed seconds."""
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("favit_region"):
            torch.ones(4).sum()
    assert "favit_region" in (tmp_path / profiling.TRACE_FILE).read_text()
    sink = {}
    with profiling.wallclock(sink, "t", result=torch.ones(2)):
        pass
    assert sink["t"] >= 0.0


def test_the_band_op_counts_launches_only_on_the_card():
    """On the CPU the band op runs its plain version: no launch counted,
    with or without remat (the card's counts are in test_torch_gpu.py)."""
    band.reset_launch_count()
    _remat_run("vit_mhla", 96, remat=True)
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [0, 0, 0]
