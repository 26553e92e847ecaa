"""Sequence parallelism, pipeline parallelism and mesh serving of the port
(``parallel/sequence.py``, ``parallel/pipeline.py``, ``infer.Predictor``
with a mesh, serve ``--num_devices``/``--tp``) against the JAX package, on
the CPU.

In process: the SP band over virtual shards against JAX's
``sp_windowed_attention`` on the conftest's 8 CPU devices and against
``_shift_banded_attention`` (forward and gradients), JAX's shard errors,
the scan-form params of a JAX ``--scan_layers`` model through
``convert/from_jax.py``, and the refusals of the experiments and the
pipeline. One 4-rank gloo job (``tests/torch_parallel_jobs.py``, which
imports no JAX; killed after 240 s) trains SP, TP×SP, PP, TP×PP, SP×PP,
FSDP×SP, FSDP×PP and SP with dense blocks from JAX's initial weights,
dropout off: two steps
give JAX's single-device losses within 1e-4 and its parameters within
1e-5, and the port's single process's likewise. The same job counts the
band softmax under PP remat, draws SP dropout masks, runs
``PretrainedViTWithMHLA`` under SP and saves a PP×FSDP checkpoint. One
``serve --num_devices 2 --tp 2`` command answers HTTP requests with JAX's
``Predictor`` probabilities and stops on Ctrl-C. The JAX references run
once, in a module fixture.
"""

import io
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from focused_attention_vit_tpu import models as fmodels
from focused_attention_vit_tpu.infer import Predictor as JaxPredictor
from focused_attention_vit_tpu.models.layers import stack_block_params
from focused_attention_vit_tpu.models.mhla_models import (
    PretrainedViTWithMHLA as JaxPretrainedViTWithMHLA,
)
from focused_attention_vit_tpu.ops.window import (
    _shift_banded_attention as jax_shift_band,
)
from focused_attention_vit_tpu.parallel import make_mesh as jax_make_mesh
from focused_attention_vit_tpu.parallel import (
    make_sharded_train_step as jax_make_sharded_train_step,
)
from focused_attention_vit_tpu.parallel.pipeline import (
    spmd_pipeline as jax_spmd_pipeline,
)
from focused_attention_vit_tpu.parallel.sequence import (
    sp_windowed_attention as jax_sp_windowed_attention,
)
from focused_attention_vit_tpu.train import state as jstate
from focused_attention_vit_tpu_torch import experiments as exp
from focused_attention_vit_tpu_torch import train
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flatten_params,
    flax_pretrained_mhla_to_state_dict,
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
    unstack_block_params,
)
from focused_attention_vit_tpu_torch.models import (
    PretrainedViTWithMHLA,
    VisionTransformer,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.parallel import launch, pipeline
from focused_attention_vit_tpu_torch.parallel.collectives import Axis
from focused_attention_vit_tpu_torch.parallel.sequence import (
    check_shards,
    virtual_sp_windowed_attention,
)
from focused_attention_vit_tpu_torch.train.checkpoint import CheckpointManager

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_jobs as jobs  # noqa: E402

torch.set_num_threads(2)

MODELS = {
    "sp": dict(img_size=56, patch_size=4, num_classes=5, embed_dim=32,
               depth=2, num_heads=4, window_size=7),
    "pp": dict(img_size=32, patch_size=4, num_classes=5, embed_dim=32,
               depth=4, num_heads=4, window_size=7),
    # Dense blocks under SP: JAX's GSPMD gathers the tokens, the port
    # gathers q, k and v over seq.
    "dense": dict(img_size=56, patch_size=4, num_classes=5, embed_dim=32,
                  depth=2, num_heads=4, window_size=7, use_mhla=False),
}
LR = 1e-3
BATCH, STEPS = 8, 2
LOSS_TOL, PARAM_TOL = 1e-4, 1e-5
JOB_TIMEOUT = 240
# name, model, tp, sp, pp, fsdp: the 4-rank job's runs (dp = 4/(tp·sp·pp)).
RUNS = [("sp4", "sp", 1, 4, 1, False), ("tp2sp2", "sp", 2, 2, 1, False),
        ("pp4", "pp", 1, 1, 4, False), ("tp2pp2", "pp", 2, 1, 2, False),
        ("sp2pp2", "sp", 1, 2, 2, False), ("fsdp2sp2", "sp", 1, 2, 1, True),
        ("fsdp2pp2", "pp", 1, 1, 2, True), ("dense_sp4", "dense", 1, 4, 1,
                                            False)]
PRETRAINED = dict(img_size=56, patch_size=4, num_classes=10, embed_dim=32,
                  depth=2, num_heads=4, window_size=7)


def _without_k_bias(sd, d=32):
    """The qkv biases' K rows carry no gradient (a softmax is invariant to
    them), so f32 noise alone moves them under Adam: left out, as in
    tests/test_torch_parallel.py."""
    out = dict(sd)
    for k in [k for k in sd if k.endswith(("attn.qkv.bias",
                                           "attn.in_proj_bias"))]:
        v = np.asarray(sd[k])
        out[k] = np.concatenate([v[:d], v[2 * d:]])
    return out


def _jax_run(model_kw, params, data):
    """JAX's single-device trajectory (``make_sharded_train_step`` on a
    one-device mesh, as JAX's own SP and PP tests take it)."""
    jmodel = fmodels.VisionTransformerMHLA(**{"use_mhla": True, **model_kw})
    mesh = jax_make_mesh(1)
    tx = jstate.make_adamw(LR)
    params = jax.tree.map(jnp.array, params)
    opt_state = tx.init(params)
    step = jax_make_sharded_train_step(jmodel, tx, mesh,
                                       model_kw["img_size"], augment=False)
    losses = []
    for i, (x, y) in enumerate(data):
        params, opt_state, m = step(params, opt_state, jnp.asarray(x),
                                    jnp.asarray(y, jnp.int32),
                                    jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    sd = flax_vit_mhla_to_state_dict(jax.tree.map(np.asarray, params))
    return losses, {k: v.numpy() for k, v in sd.items()}


def _single_run(model_kw, init, data):
    model = VisionTransformerMHLA(**model_kw)
    model.load_state_dict(torch.load(init, weights_only=True))
    state = train.create_train_state(model, train.make_adamw(LR),
                                     device="cpu")
    step = train.make_train_step(model_kw["img_size"], augment=False)
    losses = []
    for i, (x, y) in enumerate(data):
        state, m = step(state, x, y, i)
        losses.append(float(m["loss_sum"] / m["count"]))
    return losses, {k: v.numpy() for k, v in state.model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's initial weights and single-device trajectories, the port's
    single process, JAX's PretrainedViTWithMHLA logits, and the 4-rank
    job."""
    tmp = tmp_path_factory.mktemp("seqpipe")
    cfg = dict(batch=BATCH, steps=STEPS, lr=LR, data_seed=0,
               checkpoint_run="fsdp2pp2", checkpoint=str(tmp / "ckpt"))
    ref = {}
    for key, kw in MODELS.items():
        jmodel = fmodels.VisionTransformerMHLA(**{"use_mhla": True, **kw})
        hw = kw["img_size"]
        params = jax.tree.map(np.asarray, jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((2, hw, hw, 3)))["params"])
        init = tmp / f"init_{key}.pt"
        torch.save(flax_vit_mhla_to_state_dict(params), init)
        cfg[key] = dict(model=kw, init=str(init))
        data = jobs.batches(dict(cfg, model=kw))
        ref[key] = {"jax": _jax_run(kw, params, data),
                    "single": _single_run(kw, init, data)}

    jp = JaxPretrainedViTWithMHLA(**PRETRAINED)
    x = np.random.default_rng(0).normal(size=(4, 56, 56, 3)).astype(
        np.float32)
    pvars = jp.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    ref["pretrained"] = np.asarray(jp.apply(pvars, jnp.asarray(x)))
    init = tmp / "init_pretrained.pt"
    torch.save(flax_pretrained_mhla_to_state_dict(
        jax.tree.map(np.asarray, pvars["params"])), init)
    torch.save(torch.from_numpy(x), tmp / "x.pt")
    cfg["pretrained"] = dict(model=PRETRAINED, init=str(init),
                             x=str(tmp / "x.pt"))

    out = tmp / "world4"
    out.mkdir()
    launch.run_ranks(jobs.sequence_pipeline_job, 4, dict(cfg, runs=RUNS),
                     str(out), timeout=JOB_TIMEOUT, threads=1,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))
    ref["out"], ref["cfg"] = out, cfg
    return ref


def _result(runs, name):
    return torch.load(runs["out"] / f"{name}.pt", weights_only=True)


# --- the SP band in one process ---------------------------------------------


@pytest.mark.parametrize("n,s", [(2, 64), (4, 65), (8, 197)])
def test_virtual_shards_match_jax_sp_and_the_shift_band(n, s):
    """n virtual shards stitched together equal JAX's halo-exchange
    ``sp_windowed_attention`` over n CPU devices and JAX's single-device
    shift band, in the forward and in the gradients of q, k and v (the
    rows next to shard boundaries and rows 0 and S-1, which every edge
    window reads, included), within 1e-5 in f32."""
    rng = np.random.default_rng(0)
    b, h, d, w = 2, 3, 8, 7
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))

    def jloss(fn):
        return lambda q, k, v: (fn(q, k, v) ** 2).sum()

    jsp = jax.jit(lambda q, k, v: jax_sp_windowed_attention(q, k, v, w,
                                                            mesh))
    want = np.asarray(jsp(q, k, v))
    g_sp = jax.jit(jax.grad(jloss(
        lambda q, k, v: jax_sp_windowed_attention(q, k, v, w, mesh)),
        argnums=(0, 1, 2)))(q, k, v)
    g_band = jax.jit(jax.grad(jloss(
        lambda q, k, v: jax_shift_band(q, k, v, w)),
        argnums=(0, 1, 2)))(q, k, v)

    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    got = virtual_sp_windowed_attention(tq, tk, tv, w, n)
    grads = torch.autograd.grad((got ** 2).sum(), (tq, tk, tv))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax_shift_band(q, k, v, w)),
                               atol=1e-5)
    for g, a, c in zip(grads, g_sp, g_band):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(c), atol=1e-5)


@pytest.mark.parametrize("s,n,w", [(10, 4, 7), (9, 4, 2)],
                         ids=["shard_below_window", "pad_spans_shard"])
def test_shard_errors_are_jaxs(s, n, w):
    """A shard shorter than the window, and a pad that reaches past the
    last shard, raise JAX's ``ValueError``, word for word."""
    q = np.zeros((1, 1, s, 8), np.float32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    with pytest.raises(ValueError) as want:
        jax_sp_windowed_attention(q, q, q, w, mesh)
    with pytest.raises(ValueError) as got:
        check_shards(s, n, w)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        virtual_sp_windowed_attention(*(torch.from_numpy(q),) * 3, w, n)


# --- scan-form parameters ---------------------------------------------------


@pytest.mark.parametrize("name", ["vit", "vit_mhla"])
def test_scan_form_params_load_through_from_jax(name):
    """A JAX ``--scan_layers`` model's params (``blocks/block`` with a
    leading depth axis, the form every JAX ``--pp`` run has) convert into
    the port's model, whose logits equal JAX's; the port's
    ``unstack_block_params`` inverts JAX's ``stack_block_params``."""
    kw = dict(MODELS["pp"])
    w = kw.pop("window_size")
    if name == "vit":
        jmodel = fmodels.VisionTransformer(**kw, scan_layers=True)
        model, to_sd = VisionTransformer(**kw), flax_vit_to_state_dict
    else:
        jmodel = fmodels.VisionTransformerMHLA(**kw, window_size=w,
                                               use_mhla=True,
                                               scan_layers=True)
        model = VisionTransformerMHLA(**kw, window_size=w)
        to_sd = flax_vit_mhla_to_state_dict
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    assert params["blocks"]["block"]["norm1"]["scale"].shape == (4, 32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model.load_state_dict(to_sd(params))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    loop = unstack_block_params(params)
    restacked = stack_block_params(loop, 4)
    flat, again = flatten_params(params), flatten_params(
        jax.tree.map(np.asarray, restacked))
    assert flat.keys() == again.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], again[k])


# --- the refusals -----------------------------------------------------------


def _jax_pipeline_error(depth, n, batch, microbatches):
    mesh = Mesh(np.array(jax.devices()[:n]), ("stage",))
    stacked = {"w": jnp.zeros((depth, 2))}
    with pytest.raises(ValueError) as e:
        jax_spmd_pipeline(lambda p, x, k: x, stacked,
                          jnp.zeros((batch, 3, 2)), mesh,
                          microbatches=microbatches)
    return str(e.value)


@pytest.mark.parametrize("case", ["depth", "batch"])
def test_pipeline_errors_are_jaxs(case):
    """Depth not divisible by the stages and a batch not divisible by the
    microbatches raise JAX's errors, before any hand-off."""
    depth, batch, m = (4, 4, None) if case == "depth" else (4, 4, 3)
    n = 3 if case == "depth" else 2
    want = _jax_pipeline_error(depth, n, batch, m)
    axis = Axis(group=None, n=n, index=0, ranks=tuple(range(n)))
    blocks = torch.nn.ModuleList(torch.nn.Identity() for _ in range(depth))
    with pytest.raises(ValueError, match=re.escape(want)):
        pipeline.spmd_pipeline(lambda b, x, r: x, blocks,
                               torch.zeros(batch, 3, 2), axis,
                               microbatches=m)


@pytest.mark.parametrize("dims,model,match", [
    (("seq",), "vit", "--sp requires an MHLA-family model; "
     "VisionTransformer has no sequence-parallel support"),
    (("stage",), "pretrained", "--pp not supported by PretrainedViTWithMHLA"),
    (("stage",), "vit_mhla", "--pp requires the scan-form block stack: pass "
     "--scan_layers"),
], ids=["sp_dense_vit", "pp_pretrained_mhla", "pp_without_scan_layers"])
def test_experiment_parallel_refusals_are_jaxs(dims, model, match):
    """The experiment gives the model the mesh's seq and stage dimensions
    only where JAX does, with JAX's ``ValueError`` otherwise; and a model
    built with ``pp_mesh`` but without ``scan_layers`` raises JAX's
    error."""
    e = exp.TraditionalViTExperiment(device="cpu")
    e.mesh = types.SimpleNamespace(mesh_dim_names=("data", "model") + dims)
    kw = dict(img_size=16, patch_size=4, embed_dim=32, depth=2, num_heads=2)
    e.model = {"vit": lambda: VisionTransformer(**kw),
               "pretrained": lambda: PretrainedViTWithMHLA(**kw),
               "vit_mhla": lambda: VisionTransformerMHLA(**kw)}[model]()
    with pytest.raises(ValueError, match=re.escape(match)):
        e._parallel_model()
    if model == "vit_mhla":
        with pytest.raises(ValueError, match="pp_mesh .* requires "
                                             "scan_layers=True"):
            VisionTransformerMHLA(**kw, pp_mesh=object())


# --- the 4-rank job ---------------------------------------------------------


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_runs_match_jax_and_the_single_process(runs, name):
    """Two steps on the job's mesh: the losses within 1e-4 and the gathered
    parameters within 1e-5 of JAX's single-device trajectory and of the
    port's single process (dense blocks against JAX: 2e-5)."""
    key = next(r[1] for r in RUNS if r[0] == name)
    got = _result(runs, name)
    params = _without_k_bias({k: v.numpy() for k, v in got["model"].items()})
    for label in ("jax", "single"):
        losses, want = runs[key][label]
        np.testing.assert_allclose(got["losses"], losses, atol=LOSS_TOL,
                                   err_msg=label)
        want = _without_k_bias(want)
        assert params.keys() == want.keys()
        # Dense blocks against JAX: JAX's own SP trajectory bound (JAX
        # tests/test_parallel.py:513). One element of the dense qkv weight
        # parts from JAX by 7.9e-6 in the port's single process and by
        # 1.1e-5 under SP, which is 3.3e-6 from the single process.
        tol = 2e-5 if (key, label) == ("dense", "jax") else PARAM_TOL
        for k in want:
            np.testing.assert_allclose(params[k], want[k], atol=tol,
                                       err_msg=f"{label}: {k}")


def test_pipeline_remat_band_weights_saves_the_band(runs):
    """One step of the 4-stage pipeline (one block a stage, 4
    microbatches): the dense band's softmax runs once a microbatch without
    remat, twice under full remat (the recompute) and once under
    ``band_weights``, whose policy saves it; the loss is the same."""
    counts = torch.load(runs["out"] / "remat.pt", weights_only=True)
    assert {k: n for k, (n, _) in counts.items()} == {
        "None": 4, "full": 8, "band_weights": 4}
    losses = [loss for _, loss in counts.values()]
    np.testing.assert_allclose(losses, losses[0], atol=1e-6)
    np.testing.assert_allclose(losses[0], runs["pp"]["jax"][0][0],
                               atol=LOSS_TOL)


def test_sp_dropout_rate_independence_and_determinism(runs):
    """The SP band's weights dropout at rate 0.25 over 4 seq ranks: about a
    quarter of the slots dropped on each rank, masks that differ between
    ranks and seeds, and the same mask again from the same seed."""
    masks = [torch.load(runs["out"] / f"spdrop{r}.pt", weights_only=True)
             for r in range(4)]
    assert sorted(m["rank"] for m in masks) == [0, 1, 2, 3]
    for m in masks:
        assert m["a"].shape == (2, 3, 7, 50)
        assert abs(1.0 - m["a"].float().mean().item() - 0.25) < 0.05
        assert torch.equal(m["a"], m["again"])
        assert (m["a"] == m["b"]).float().mean() < 0.8
    assert (masks[0]["a"] == masks[1]["a"]).float().mean() < 0.8


def test_pretrained_mhla_under_sp_matches_jax(runs):
    """``PretrainedViTWithMHLA`` on a (data 2, seq 2) mesh: the logits of
    JAX's unsharded forward within 1e-4 (JAX's own SP test's bound)."""
    got = torch.load(runs["out"] / "pretrained.pt", weights_only=True)
    np.testing.assert_allclose(got.numpy(), runs["pretrained"], atol=1e-4)


def test_pp_fsdp_checkpoint_restores_bit_for_bit(runs):
    """The PP×FSDP run's checkpoint holds the single-device state: it
    restores into a plain model bit for bit, serves through
    ``Predictor.from_checkpoint``, and resumes on the same mesh to the very
    state it saved (parameters and AdamW moments)."""
    from focused_attention_vit_tpu_torch.infer import Predictor

    got = _result(runs, "fsdp2pp2")
    ckpt = runs["cfg"]["checkpoint"]
    plain = train.create_train_state(VisionTransformerMHLA(**MODELS["pp"]),
                                     train.make_adamw(LR), device="cpu")
    CheckpointManager(ckpt).restore(plain)
    for n, p in plain.model.named_parameters():
        assert torch.equal(p.detach(), got["model"][n]), n
    assert plain.step == STEPS and plain.tx.count == STEPS
    res = got["resumed"]
    for n, t in got["model"].items():
        assert torch.equal(res["model"][n], t), n
    assert res["optimizer"]["state"].keys() == got["optimizer"][
        "state"].keys()
    for i, entry in got["optimizer"]["state"].items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(res["optimizer"]["state"][i][
                k]), torch.as_tensor(v)), (i, k)
    pred = Predictor.from_checkpoint(
        VisionTransformerMHLA(**MODELS["pp"]), ckpt, img_size=32,
        device="cpu", batch_size=4, compute_dtype=torch.float32)
    imgs = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3),
                                             dtype=np.uint8)
    assert np.isfinite(pred.predict_proba(imgs)).all()


# --- mesh serving -----------------------------------------------------------


def _lines(proc, q):
    for line in proc.stdout:
        q.put(line)
    q.put(None)


def test_serve_on_two_ranks_matches_jax_predictor(tmp_path):
    """``serve --num_devices 2 --tp 2 --device cpu`` starts two gloo ranks
    (rank 0 serves HTTP, rank 1 follows), answers two requests with JAX's
    ``Predictor`` probabilities within 1e-5, and stops cleanly on Ctrl-C
    (SIGINT to every process of the command)."""
    kw = dict(img_size=16, patch_size=4, num_classes=5, embed_dim=32,
              depth=2, num_heads=4, window_size=7)
    jmodel = fmodels.VisionTransformerMHLA(use_mhla=True, **kw)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 16, 16, 3)))["params"]
    np.savez(tmp_path / "w.npz",
             **flatten_params(jax.tree.map(np.asarray, params)))
    jpred = JaxPredictor(jmodel, params, img_size=16, batch_size=8,
                         compute_dtype=jnp.float32)
    argv = [sys.executable, "-m", "focused_attention_vit_tpu_torch.serve",
            "--weights", str(tmp_path / "w.npz"), "--device", "cpu",
            "--compute_dtype", "float32", "--batch_size", "8",
            "--num_devices", "2", "--tp", "2", "--port", "0"] + [
        f"--{k}={v}" for k, v in kw.items()]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_lines, args=(proc, lines), daemon=True).start()
    seen = []
    try:
        while True:
            line = lines.get(timeout=120)
            assert line is not None, "".join(seen)
            seen.append(line)
            m = re.search(r"serving on http://([\d.]+):(\d+)", line)
            if m:
                break
        assert "{'data': 1, 'model': 2} mesh" in line
        url = f"http://{m.group(1)}:{m.group(2)}/predict"
        rng = np.random.default_rng(5)
        for n in (3, 8):
            imgs = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
            buf = io.BytesIO()
            np.save(buf, imgs)
            req = urllib.request.Request(url, data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got = np.load(io.BytesIO(r.read()))
            np.testing.assert_allclose(got, jpred.predict_proba(imgs),
                                       atol=1e-5)
        os.killpg(proc.pid, signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    while (line := lines.get(timeout=10)) is not None:
        seen.append(line)
    assert "shutting down" in "".join(seen)


def test_cli_trains_with_sp_and_pp_on_four_ranks(tmp_path, monkeypatch,
                                                 capfd):
    """``--num_devices 4 --sp 2 --pp 2 --scan_layers`` through
    ``cli.main`` on the CPU: E5 ``mhla_pretrained`` (its
    ``VisionTransformerMHLA`` takes both) trains on a (data 1, model 1,
    seq 2, stage 2) mesh of four gloo ranks and rank 0 writes the CSV."""
    import pickle

    from focused_attention_vit_tpu_torch import cli

    data = tmp_path / "data" / "cifar-10-batches-py"
    data.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(data / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 16))}, f)
    monkeypatch.chdir(tmp_path)
    argv = ["--experiment", "mhla_pretrained", "--device", "cpu",
            "--img_size", "56", "--patch_size", "4", "--embed_dim", "32",
            "--depth", "2", "--num_heads", "4", "--batch_size", "8",
            "--subset_size", "32", "--epochs", "1", "--num_devices", "4",
            "--sp", "2", "--pp", "2", "--scan_layers",
            "--data_dir", str(tmp_path / "data")]
    assert cli.main(argv) is None  # the ranks ran it
    out = capfd.readouterr().out
    assert out.count("Epoch 1/1 |") == 1
    assert ("Training on a {'data': 1, 'model': 1, 'seq': 2, 'stage': 2} "
            "device mesh") in out
    assert os.path.exists(tmp_path / "results" / "exp4_pretrained_mhla.csv")
