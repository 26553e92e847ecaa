"""The port's parallel layer (``focused_attention_vit_tpu_torch.parallel``)
against JAX's ``make_sharded_train_step`` on the conftest's 8-device CPU
mesh and against the port's single process, on the CPU over gloo.

The port's ranks run in spawned processes (``parallel.launch.run_ranks``,
a ``file://`` rendezvous under ``tmp_path``, one thread each, a time limit
that kills them) from ``tests/torch_parallel_jobs.py``, which imports no
JAX. One 4-rank job trains DP, DP×TP and FSDP×TP, saves a checkpoint and
checks dropout at dp=2, tp=2; one 2-rank job trains DP, TP and FSDP and
restores the 4-rank checkpoint under TP×FSDP. A 2-block MHLA model, dropout
off: three steps must give JAX's losses within 1e-4 and its parameters
within 1e-5. The JAX references run once, in a module fixture.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from focused_attention_vit_tpu import models as fmodels
from focused_attention_vit_tpu.parallel import make_mesh as jax_make_mesh
from focused_attention_vit_tpu.parallel import (
    make_sharded_train_step as jax_make_sharded_train_step,
)
from focused_attention_vit_tpu.parallel import shard_params as jax_shard_params
from focused_attention_vit_tpu.train import state as jstate
from focused_attention_vit_tpu_torch import cli, train
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
)
from focused_attention_vit_tpu_torch.parallel import (
    global_batch_from_host_data,
    host_batch_slice,
    launch,
    make_mesh,
)
from focused_attention_vit_tpu_torch.train.checkpoint import CheckpointManager

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_jobs as jobs  # noqa: E402

torch.set_num_threads(2)

MODEL = dict(img_size=16, patch_size=4, num_classes=5, embed_dim=32,
             depth=2, num_heads=4, window_size=7)
LR = 1e-3
BATCH, STEPS = 8, 3
LOSS_TOL, PARAM_TOL = 1e-4, 1e-5
JOB_TIMEOUT = 240
RUNS = {4: [("dp4", 1, False), ("dp2tp2", 2, False), ("fsdp2tp2", 2, True)],
        2: [("dp2", 1, False), ("tp2", 2, False), ("fsdp2", 1, True)]}
NAMES = [r[0] for w in (4, 2) for r in RUNS[w]]
WORLD = {r[0]: w for w in (4, 2) for r in RUNS[w]}


def _without_k_bias(sd):
    """The qkv biases' K rows carry no gradient (a softmax is invariant to
    them), so after the first step f32 noise alone moves them, by up to
    the learning rate under Adam: left out of the comparison."""
    d = MODEL["embed_dim"]
    out = dict(sd)
    for k in [k for k in sd if k.endswith("attn.qkv.bias")]:
        v = np.asarray(sd[k])
        out[k] = np.concatenate([v[:d], v[2 * d:]])
    return out


def _jax_run(jmodel, params, data, n, tp, fsdp):
    mesh = jax_make_mesh(n, tp=tp)
    tx = jstate.make_adamw(LR)
    params = jax_shard_params(jax.tree.map(jnp.array, params), mesh,
                              fsdp=fsdp)
    opt_state = tx.init(params)
    step = jax_make_sharded_train_step(jmodel, tx, mesh, MODEL["img_size"],
                                       augment=False)
    losses = []
    for i, (x, y) in enumerate(data):
        x = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
        y = jax.device_put(jnp.asarray(y, jnp.int32),
                           NamedSharding(mesh, P("data")))
        params, opt_state, m = step(params, opt_state, x, y,
                                    jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    sd = flax_vit_mhla_to_state_dict(jax.tree.map(np.asarray, params))
    return losses, {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The initial weights (JAX's init), JAX's sharded runs at 2 and 4
    devices, the port's single process, and the two rank jobs."""
    tmp = tmp_path_factory.mktemp("parallel")
    jmodel = fmodels.VisionTransformerMHLA(use_mhla=True, **MODEL)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)))
    params = jax.tree.map(np.asarray, params["params"])
    init = tmp / "init.pt"
    torch.save(flax_vit_mhla_to_state_dict(params), init)
    cfg = dict(model=MODEL, init=str(init), batch=BATCH, steps=STEPS, lr=LR,
               data_seed=0)
    data = jobs.batches(cfg)
    ref = {"jax": {2: _jax_run(jmodel, params, data, 2, 1, False),
                   4: _jax_run(jmodel, params, data, 4, 2, True)}}

    state = train.create_train_state(jobs.build_model(cfg),
                                     train.make_adamw(LR), device="cpu")
    step = train.make_train_step(MODEL["img_size"], augment=False)
    losses = []
    for i, (x, y) in enumerate(data):
        state, m = step(state, x, y, i)
        losses.append(float(m["loss_sum"] / m["count"]))
    ref["single"] = (losses, {k: v.numpy()
                              for k, v in state.model.state_dict().items()})

    ckpt = tmp / "ckpt"
    for world, extra in (
            (4, dict(checkpoint_run="dp2tp2", checkpoint=str(ckpt),
                     dropout_tp=2)),
            (2, dict(restore=str(ckpt), restore_layout=(2, True)))):
        out = tmp / f"world{world}"
        out.mkdir()
        launch.run_ranks(jobs.job, world, dict(cfg, runs=RUNS[world], **extra),
                         str(out), timeout=JOB_TIMEOUT, threads=1,
                         rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))
    ref["tmp"], ref["ckpt"], ref["cfg"] = tmp, ckpt, cfg
    return ref


def _result(runs, name):
    return torch.load(runs["tmp"] / f"world{WORLD[name]}" / f"{name}.pt",
                      weights_only=True)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_jax_and_the_single_process(runs, name):
    got = _result(runs, name)
    jlosses, jparams = runs["jax"][WORLD[name]]
    slosses, sparams = runs["single"]
    np.testing.assert_allclose(got["losses"], jlosses, atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(got["losses"], slosses, atol=LOSS_TOL, rtol=0)
    model = _without_k_bias({k: v.numpy() for k, v in got["model"].items()})
    assert sorted(model) == sorted(sparams)
    for want in (_without_k_bias(jparams), _without_k_bias(sparams)):
        for k in want:
            np.testing.assert_allclose(model[k], want[k], atol=PARAM_TOL,
                                       rtol=0, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["tp2", "dp2tp2", "fsdp2tp2", "fsdp2"])
def test_placements_name_the_model_and_data_dimensions(runs, name):
    """The rules read off the plain model and off the sharded state agree,
    and follow JAX's ``_rule_for`` in torch's ``[out, in]`` layout: qkv
    (per head) and fc1 (with its bias) on their output rows, proj and fc2
    on their input columns, the rest replicated; FSDP adds ``data`` on
    dimension 0 of every parameter."""
    got = _result(runs, name)
    rules, fsdp = got["rules"], name.startswith("fsdp")
    assert rules == got["state_rules"]
    tp = "tp" in name
    m = "model" if tp else None

    def want(spec):
        if fsdp:
            spec = (("data",) if spec[0] is None else ((spec[0], "data"),)
                    ) + spec[1:]
        return spec

    b = "blocks.0."
    assert rules[b + "attn.qkv.weight"] == want((m, None))
    assert rules[b + "attn.qkv.bias"] == want((m,))
    assert rules[b + "attn.proj.weight"] == want((None, m))
    assert rules[b + "attn.proj.bias"] == want((None,))
    assert rules[b + "attn.latent_proj.weight"] == want((None, None))
    assert rules[b + "mlp.fc1.weight"] == want((m, None))
    assert rules[b + "mlp.fc1.bias"] == want((m,))
    assert rules[b + "mlp.fc2.weight"] == want((None, m))
    assert rules["head.weight"] == want((None, None))


@pytest.mark.parametrize("name", ["fsdp2", "fsdp2tp2"])
def test_fsdp_ranks_hold_one_data_shard_of_each_parameter(runs, name):
    """Each rank holds its ``torch.chunk`` piece of dimension 0 of every
    (tensor-parallel) parameter: about 1/dp of it, and the data ranks'
    pieces add up to the parameter."""
    world = WORLD[name]
    tp = 2 if "tp" in name else 1
    dp = world // tp
    full = runs["single"][1]
    numel = [torch.load(runs["tmp"] / f"world{world}" / f"{name}.numel{r}.pt")
             for r in range(world)]
    rules = _result(runs, name)["rules"]
    for k, v in full.items():
        shape = list(v.shape)
        if "model" in str(rules[k][0]):
            shape[0] //= tp
        elif "model" in str(rules[k][1:]):
            shape[1] //= tp
        pieces = [p.numel() for p in torch.empty(shape).chunk(dp, 0)]
        pieces += [0] * (dp - len(pieces))  # chunk gives fewer than dp
        for r in range(world):
            assert numel[r][k] == pieces[r // tp], (k, r)
        assert sum(pieces) == int(np.prod(shape))
        if shape[0] % dp == 0:
            assert pieces[0] * dp == int(np.prod(shape))


def test_checkpoint_saved_at_dp2_tp2_restores_at_world_size_one(runs):
    """The dp=2, tp=2 run's checkpoint is the single-device format: it
    restores into a plain world-1 state equal to the gathered state (and
    to the single process), and a step runs from it."""
    cfg = runs["cfg"]
    state = train.create_train_state(jobs.build_model(cfg),
                                     train.make_adamw(LR), device="cpu")
    mngr = CheckpointManager(str(runs["ckpt"]))
    assert mngr.latest_step() == STEPS
    mngr.restore(state)
    assert state.step == STEPS and state.tx.count == STEPS
    got = _result(runs, "dp2tp2")
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, got["model"][k], atol=0, rtol=0)
        np.testing.assert_allclose(
            _without_k_bias({k: v.numpy()})[k],
            _without_k_bias(runs["single"][1])[k], atol=PARAM_TOL, rtol=0)
    moments = state.tx.adamw.state_dict()["state"]
    assert len(moments) == len(list(state.model.parameters()))
    for i, entry in got["optimizer"]["state"].items():
        torch.testing.assert_close(moments[i]["exp_avg"], entry["exp_avg"])
    x, y = jobs.batches(cfg)[0]
    state, m = train.make_train_step(16, augment=False)(state, x, y, 9)
    assert np.isfinite(float(m["loss_sum"]))


def test_checkpoint_restores_across_topologies(runs):
    """The 4-rank checkpoint restored by 2 ranks under TP and FSDP and
    gathered back equals what was saved (JAX's
    ``test_elastic_restore_across_topologies``)."""
    saved = torch.load(runs["ckpt"] / str(STEPS) / "state.pt",
                       weights_only=True)
    back = torch.load(runs["tmp"] / "world2" / "restored.pt",
                      weights_only=True)
    assert back["step"] == saved["step"] == STEPS
    for k, v in saved["model"].items():
        torch.testing.assert_close(back["model"][k], v, atol=0, rtol=0)
    for i, entry in saved["optimizer"]["state"].items():
        for key, v in entry.items():
            torch.testing.assert_close(back["optimizer"]["state"][i][key], v,
                                       atol=0, rtol=0)


def test_dropout_under_dp_and_tp(runs):
    """dp=2, tp=2, dropout 0.25: the masks keep 3/4; the shared stream's
    masks are equal across a model group and differ across data ranks; the
    local streams differ across a model group; a train-mode forward's
    replicated values (block 0's MLP output, the logits) are equal across
    a model group; after a train step with dropout and augmentation the
    replicated parameters are equal on every rank of a model group."""
    d = [torch.load(runs["tmp"] / "world4" / f"dropout{r}.pt")
         for r in range(4)]
    by = {(x["data_rank"], x["model_rank"]): x for x in d}
    for x in d:
        for key in ("shared", "local"):
            assert abs(x[key].float().mean().item() - 0.75) < 0.05
    for dr in (0, 1):
        a, b = by[(dr, 0)], by[(dr, 1)]
        assert torch.equal(a["shared"], b["shared"])
        assert not torch.equal(a["local"], b["local"])
        assert torch.equal(a["mlp_out_zero"], b["mlp_out_zero"])
        torch.testing.assert_close(a["logits"], b["logits"])
        for k, v in a["replicated"].items():
            torch.testing.assert_close(v, b["replicated"][k], atol=0, rtol=0)
    assert not torch.equal(by[(0, 0)]["shared"], by[(1, 0)]["shared"])
    assert not torch.equal(by[(0, 0)]["mlp_out_zero"],
                           by[(1, 0)]["mlp_out_zero"])
    zero = by[(0, 0)]["mlp_out_zero"].float().mean().item()
    assert 0.15 < zero < 0.35


def test_cli_trains_on_two_ranks_with_tp_and_fsdp(tmp_path, monkeypatch,
                                                  capfd):
    """``--num_devices 2 --tp 2 --fsdp`` through ``cli.main`` on the CPU:
    the CLI starts two gloo ranks, rank 0 alone prints and writes the CSV
    and the checkpoints, which hold the single-device state."""
    import pickle

    data = tmp_path / "data" / "cifar-10-batches-py"
    data.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(data / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 16))}, f)
    monkeypatch.chdir(tmp_path)
    argv = ["--experiment", "traditional", "--device", "cpu", "--img_size",
            "16", "--patch_size", "4", "--embed_dim", "32", "--depth", "1",
            "--num_heads", "2", "--batch_size", "32", "--subset_size", "64",
            "--epochs", "1", "--num_devices", "2", "--tp", "2", "--fsdp",
            "--checkpoint_dir", "ckpt", "--sync_checkpoint",
            "--data_dir", str(tmp_path / "data")]
    assert cli.main(argv) is None  # the ranks ran it
    out = capfd.readouterr().out
    assert out.count("Epoch 1/1 |") == 1
    assert "Training on a {'data': 1, 'model': 2} device mesh" in out
    assert "train batch pipeline: native C++ prefetcher" in out
    assert os.path.exists(tmp_path / "results" / "exp1_traditional.csv")
    saved = torch.load(tmp_path / "ckpt" / "1" / "state.pt",
                       weights_only=True)
    assert saved["model"]["blocks.0.attn.qkv.weight"].shape == (96, 32)
    assert saved["model"]["blocks.0.mlp.fc1.weight"].shape == (128, 32)


def test_mesh_batch_and_microbatch_rules():
    """Without ranks: ``--sp``/``--pp`` meshes (ported since; their ranks
    run in tests/test_torch_sequence_pipeline.py), like any mesh, need the
    process group; the host slice is the whole batch and the global batch
    is the rank's own; under a mesh an explicit microbatch must be a
    multiple of the data size and the auto microbatch is off, as in JAX."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(4, sp=2)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(4, pp=2)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)
    assert host_batch_slice(8) == (0, 8)
    x = np.zeros(3)
    assert global_batch_from_host_data(x) is x

    class TwoDataRanks:  # the one call _effective_microbatch makes
        def size(self, dim):
            return 2

    e = exp.TraditionalViTExperiment(batch_size=32, microbatch=3,
                                     device="cpu")
    e.mesh = TwoDataRanks()
    with pytest.raises(ValueError, match="multiple of the data-parallel"):
        e._effective_microbatch()
    e.microbatch = 8
    assert e._effective_microbatch() == 8
    e.microbatch, e.auto_microbatch = None, 16
    assert e._effective_microbatch() is None
