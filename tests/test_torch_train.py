"""The port's training slice against the JAX package, on the CPU, in f32:
augmentation, datasets and batching, the optimizer, clipping and schedules,
the gradients of the model, the train and eval steps and the loop, and the
quality metrics. Shared weights go from JAX to the port through
``convert/from_jax.py``; gradients and parameters come back to Flax layout
through the JAX package's own ``reference_vit_mhla_to_flax``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from focused_attention_vit_tpu.convert.torch_to_jax import (
    reference_vit_mhla_to_flax,
)
from focused_attention_vit_tpu.data import datasets as jdatasets
from focused_attention_vit_tpu.data import pipeline as jpipe
from focused_attention_vit_tpu.models import (
    VisionTransformerMHLA as JaxVisionTransformerMHLA,
)
from focused_attention_vit_tpu.train import metrics as jmetrics
from focused_attention_vit_tpu.train import state as jstate
from focused_attention_vit_tpu.train import steps as jsteps
from focused_attention_vit_tpu_torch import train
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
)
from focused_attention_vit_tpu_torch.data import datasets, pipeline
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
from focused_attention_vit_tpu_torch.models.layers import DropoutRNG
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.train import state as tstate

torch.set_num_threads(2)

# S = 577 through img 96 and patch 4: the long-S branch (the band op).
GEOM = dict(img_size=96, patch_size=4, num_classes=10, embed_dim=32,
            depth=2, num_heads=2, window_size=7)
LOGIT_TOL = 1e-4   # eval logits, f32 (ROADMAP's parity rule)
GRAD_TOL = 1e-5    # per-leaf gradients, f32 (ROADMAP's parity rule)
LR = 1e-3


def _batch(seed, b=4, hw=32):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, size=(b, hw, hw, 3), dtype=np.uint8)
    return u8, rng.integers(0, 10, size=b).astype(np.int32)


def _pair(seed=0, **kw):
    """A JAX model and its params, and the port's model with the same
    weights (converted before any JAX step donates the params)."""
    geom = dict(GEOM, **kw)
    jmodel = JaxVisionTransformerMHLA(use_mhla=True, **geom)
    size = geom["img_size"]
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, size, size, 3)))["params"]
    tmodel = VisionTransformerMHLA(**geom)
    tmodel.load_state_dict(flax_vit_mhla_to_state_dict(params))
    return jmodel, params, tmodel


def _to_flax(tree_of_tensors, depth=2):
    return reference_vit_mhla_to_flax(
        {k: v.detach() for k, v in tree_of_tensors.items()}, depth, True,
        num_heads=GEOM["num_heads"])


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize("img_size", [32, 64])
def test_augment_train_batch_matches_jax_with_its_draw(img_size):
    u8, _ = _batch(1, b=6)
    key = jax.random.PRNGKey(3)
    want = jpipe.augment_train_batch(jnp.asarray(u8), key, img_size)
    # The JAX transform's own draw, handed to the port.
    k_crop, k_flip = jax.random.split(key)
    offsets = np.array(jax.random.randint(k_crop, (6, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(k_flip, 0.5, (6,)))
    assert 0 < flips.sum() < 6
    got = pipeline.augment_train_batch(
        torch.from_numpy(u8), None, img_size,
        offsets=torch.from_numpy(offsets), flips=torch.from_numpy(flips))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_augment_draw_is_seeded_and_in_range():
    u8 = torch.from_numpy(_batch(2, b=64)[0])
    a = pipeline.augment_train_batch(
        u8, torch.Generator().manual_seed(5), 32)
    b = pipeline.augment_train_batch(
        u8, torch.Generator().manual_seed(5), 32)
    assert torch.equal(a, b)
    offsets, flips = pipeline.draw_augment_params(
        1000, torch.Generator().manual_seed(1))
    assert offsets.min() == 0 and offsets.max() == 8
    assert 0.4 < flips.float().mean() < 0.6


def test_synthetic_dataset_equals_jax(tmp_path):
    kw = dict(data_dir=str(tmp_path), subset_size=60,
              synthetic_sizes=(200, 50))
    got = datasets.load_dataset("cifar10", **kw)
    want = jdatasets.load_dataset("cifar10", **kw)
    assert got["synthetic"] and want["synthetic"]
    assert got["num_classes"] == 10
    for name in ("train_images", "train_labels", "test_images",
                 "test_labels"):
        np.testing.assert_array_equal(got[name], want[name])


def test_batch_iterators_equal_jax():
    u8, y = _batch(4, b=23)
    got = list(pipeline.batch_iterator(u8, y, 5, shuffle=True,
                                       rng=np.random.default_rng(1)))
    want = list(jpipe.batch_iterator(u8, y, 5, shuffle=True,
                                     rng=np.random.default_rng(1)))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for x, z in zip(a, b):
            np.testing.assert_array_equal(x, z)
    for a, b in zip(pipeline.padded_eval_batches(u8, y, 10),
                    jpipe.padded_eval_batches(u8, y, 10)):
        for x, z in zip(a, b):
            np.testing.assert_array_equal(x, z)


# --- optimizer --------------------------------------------------------------


class _Three(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            setattr(self, name, nn.Linear(1, 1, bias=False))
            getattr(self, name).weight = nn.Parameter(torch.from_numpy(a))


def _grad_sequence(shapes, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-6, 1)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(n)]


def _run_port(spec, p0, grads):
    module = _Three({k: v.copy() for k, v in p0.items()})
    opt = spec.bind(module)
    for g in grads:
        for k, v in g.items():
            getattr(module, k).weight.grad = torch.from_numpy(v.copy())
        opt.step()
    return {k: getattr(module, k).weight.detach().numpy() for k in p0}


def _run_optax(tx, p0, grads):
    params = {k: {"weight": jnp.asarray(v)} for k, v in p0.items()}
    st = tx.init(params)
    for g in grads:
        upd, st = tx.update({k: {"weight": jnp.asarray(v)}
                             for k, v in g.items()}, st, params)
        params = optax.apply_updates(params, upd)
    return {k: np.asarray(v["weight"]) for k, v in params.items()}


@pytest.mark.parametrize("schedule,clip", [
    (dict(kind="constant"), None),
    (dict(kind="constant", warmup_steps=3), 0.5),
    (dict(kind="cosine", warmup_steps=2, total_steps=6), 3.0),
])
def test_adamw_clip_and_schedule_match_optax(schedule, clip):
    shapes = {"a": (5, 3), "b": (7,)}
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = _grad_sequence(shapes)
    got = _run_port(train.make_adamw(train.make_lr_schedule(LR, **schedule),
                                     0.05, clip), p0, grads)
    want = _run_optax(jstate.make_adamw(
        jstate.make_lr_schedule(LR, **schedule), 0.05, clip), p0, grads)
    for k in p0:
        np.testing.assert_allclose(got[k], want[k], atol=5e-6, err_msg=k)


def test_grouped_optimizer_with_frozen_and_clip_matches_optax():
    shapes = {"body": (6, 4), "latent": (4, 4), "head": (3,), "frozen": (5,)}
    rng = np.random.default_rng(1)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = _grad_sequence(shapes, seed=4)
    lrs = {"body": LR, "latent": 5 * LR,
           "head": train.make_lr_schedule(10 * LR, "constant",
                                          warmup_steps=2)}
    got = _run_port(train.make_grouped_optimizer(
        lambda name: name.split(".")[0], lrs, 0.05, grad_clip_norm=1.0),
        p0, grads)
    jlrs = dict(lrs, head=jstate.make_lr_schedule(10 * LR, "constant",
                                                  warmup_steps=2))
    params = {k: {"weight": jnp.asarray(v)} for k, v in p0.items()}
    tx = jstate.make_grouped_optimizer(
        params, lambda path: path.split("/")[0], jlrs, 0.05,
        grad_clip_norm=1.0)
    want = _run_optax(tx, p0, grads)
    np.testing.assert_array_equal(got["frozen"], p0["frozen"])
    for k in p0:
        np.testing.assert_allclose(got[k], want[k], atol=5e-6, err_msg=k)


def test_clip_follows_optax_rule():
    g = [torch.tensor([6.0, 0.0]), torch.tensor([8.0])]  # norm 10
    norm = tstate.clip_by_global_norm_(g, 10.0)  # at the bound: scaled
    assert float(norm) == 10.0
    want = optax.clip_by_global_norm(10.0).update(
        [jnp.asarray([6.0, 0.0]), jnp.asarray([8.0])], None)[0]
    for a, b in zip(g, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    small = [torch.full((3,), 1e-3)]
    tstate.clip_by_global_norm_(small, 1.0)  # below: untouched, no epsilon
    assert torch.equal(small[0], torch.full((3,), 1e-3))


@pytest.mark.parametrize("kw", [
    dict(kind="constant"), dict(kind="constant", warmup_steps=5),
    dict(kind="cosine", total_steps=20),
    dict(kind="cosine", warmup_steps=4, total_steps=20),
])
def test_lr_schedules_match_optax(kw):
    got = train.make_lr_schedule(3e-4, **kw)
    want = jstate.make_lr_schedule(3e-4, **kw)
    for step in range(25):
        g = got(step) if callable(got) else got
        w = float(want(step)) if callable(want) else want
        assert abs(g - w) <= 1e-6 * 3e-4, (step, g, w)


def test_optimizer_refusals():
    # A bf16 first moment is ported (tests/test_torch_train_flags.py); a
    # dtype optax's rule is not written for is refused.
    with pytest.raises(ValueError, match="mu_dtype"):
        train.make_adamw(LR, mu_dtype=torch.float16)
    with pytest.raises(ValueError):
        train.make_adamw(LR, grad_clip_norm=0.0)
    with pytest.raises(ValueError):
        train.make_lr_schedule(LR, "cosine", total_steps=3, warmup_steps=3)


# --- model gradients and steps ----------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "roll"])
def test_ce_gradients_match_jax_per_leaf(impl, monkeypatch):
    """Gradients of the CE mean on shared weights: JAX's long-S branch is
    its shift band (auto) or its lane-roll kernel's custom VJP (roll); the
    port's is the band op's autograd Function."""
    monkeypatch.setenv("FAVIT_MHLA_IMPL", impl)
    jmodel, params, tmodel = _pair(1)
    u8, y = _batch(5)
    x = pipeline.prepare_eval_batch(torch.from_numpy(u8), 96)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x.numpy()))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    loss_t = nn.functional.cross_entropy(tmodel(x),
                                         torch.from_numpy(y).long())
    loss_t.backward()
    loss_t = loss_t.detach()
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    got = _leaves(_to_flax({k: p.grad for k, p in tmodel.named_parameters()}))
    want = _leaves(grads_j)
    assert got.keys() == want.keys() and len(got) > 10
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL, err_msg=k)
    # The attention projections do receive the band's gradient.
    assert np.abs(got["['blocks_0']['attn']['latent_proj']['kernel']"]).max() > 0


def _k_bias_free(leaves):
    """Leave out the K rows of the qkv biases: their gradient is zero by
    analysis (softmax is shift-invariant per query), so both sides hold
    only rounding residue there, which Adam's g / (|g| + eps) turns into
    steps of up to the learning rate in either direction."""
    out = dict(leaves)
    for k, v in leaves.items():
        if re.search(r"\['attn'\]\['qkv'\]\['bias'\]", k):
            out[k] = np.concatenate([v[0:1], v[2:3]])  # [3, h, d]: q, v
    return out


def test_train_steps_match_jax_trajectory():
    """One step and a 3-step trajectory of ``make_train_step`` (augment off,
    dropout 0, AdamW lr 1e-3) against JAX's on the same weights and
    batches: loss, accuracy count and parameters within 2e-6 after each
    step (measured 4.1e-7 at every step, on every coordinate). Steps 2-3
    leave out the qkv biases' K rows (see ``_k_bias_free``), which f32
    noise could move by up to the learning rate."""
    jmodel, params, tmodel = _pair(2)
    batches = [_batch(10 + i) for i in range(3)]
    jstate_ = jstate.create_train_state(
        jmodel, None, None, jstate.make_adamw(LR), params)
    jstep = jsteps.make_train_step(96, augment=False)
    tstate_ = train.create_train_state(tmodel, train.make_adamw(LR),
                                       device="cpu")
    tstep = train.make_train_step(96, augment=False)
    for i, (u8, y) in enumerate(batches):
        jstate_, jm = jstep(jstate_, jnp.asarray(u8), jnp.asarray(y),
                            jax.random.PRNGKey(i))
        tstate_, tm = tstep(tstate_, u8, y, i)
        assert abs(float(tm["loss_sum"]) - float(jm["loss_sum"])) < 1e-5
        assert int(tm["correct"]) == int(jm["correct"])
        assert int(tm["count"]) == int(jm["count"]) == 4
        got = _leaves(_to_flax(tstate_.model.state_dict()))
        want = _leaves(jstate_.params)
        if i > 0:
            got, want = _k_bias_free(got), _k_bias_free(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=2e-6,
                                       err_msg=f"step {i + 1} {k}")
    assert tstate_.step == 3 and tstate_.tx.count == 3


def test_microbatch_accumulation_equals_monolithic_step():
    _, _, model_a = _pair(3)
    _, _, model_b = _pair(3)
    u8, y = _batch(6, b=8)
    sa = train.create_train_state(model_a, train.make_adamw(LR),
                                  device="cpu")
    sb = train.create_train_state(model_b, train.make_adamw(LR),
                                  device="cpu")
    sa, ma = train.make_train_step(96, augment=False)(sa, u8, y, 0)
    sb, mb = train.make_train_step(96, augment=False, microbatch=2)(
        sb, u8, y, 0)
    assert abs(float(ma["loss_sum"]) - float(mb["loss_sum"])) < 1e-5
    assert int(ma["correct"]) == int(mb["correct"])
    for (name, pa), pb in zip(model_a.named_parameters(),
                              model_b.parameters()):
        # The mean of the four chunk gradients is the batch gradient.
        torch.testing.assert_close(pa.grad, pb.grad, atol=1e-6, rtol=1e-5,
                                   msg=name)


def test_eval_step_with_mask_matches_jax():
    jmodel, params, tmodel = _pair(4)
    u8, y = _batch(7, b=5)
    jstate_ = jstate.create_train_state(
        jmodel, None, None, jstate.make_adamw(LR), params)
    tstate_ = train.create_train_state(tmodel, train.make_adamw(LR),
                                       device="cpu")
    got_all, want_all = [], []
    for xb, yb, mask in pipeline.padded_eval_batches(u8, y, 4):
        got_all.append(train.make_eval_step(96, return_logits=True)(
            tstate_, xb, yb, mask))
        want_all.append(jsteps.make_eval_step(96, return_logits=True)(
            jstate_, jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(mask)))
    assert float(got_all[-1]["count"]) == 1.0
    for got, want in zip(got_all, want_all):
        np.testing.assert_allclose(got["logits"].numpy(),
                                   np.asarray(want["logits"]),
                                   atol=LOGIT_TOL)
        for k in ("loss_sum", "correct", "count"):
            assert abs(float(got[k]) - float(want[k])) < 1e-4, k


def test_dropout_train_mode_is_seeded_and_eval_mode_unchanged():
    _, params, tmodel = _pair(5)
    drop = VisionTransformerMHLA(**GEOM, dropout=0.1, attn_dropout=0.1,
                                 embed_dropout=0.1)
    drop.load_state_dict(tmodel.state_dict())
    x = pipeline.prepare_eval_batch(torch.from_numpy(_batch(8)[0]), 96)
    with torch.no_grad():
        eval_ref = tmodel.eval()(x)
        drop.train()
        a = drop(x, DropoutRNG(1, "cpu"))
        b = drop(x, DropoutRNG(1, "cpu"))
        c = drop(x, DropoutRNG(2, "cpu"))
        drop.eval()
        d = drop(x)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 1e-4 and (a - eval_ref).abs().max() > 1e-4
    torch.testing.assert_close(d, eval_ref, atol=0, rtol=0)
    jmodel = JaxVisionTransformerMHLA(use_mhla=True, dropout=0.1,
                                      attn_dropout=0.1, **GEOM)
    want = jmodel.apply({"params": params}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(d.numpy(), np.asarray(want), atol=LOGIT_TOL)


@pytest.mark.parametrize("img_size", [12, 32, 96])
def test_attention_dropout_branches_train(img_size):
    """Each train branch of the MHLA layer (gather, dense band, band op)
    drops window weights and still carries gradients to qkv and the latent
    projection; the train step with augmentation and dropout is seeded."""
    geom = dict(GEOM, img_size=img_size)
    model_a = VisionTransformerMHLA(**geom, dropout=0.1, attn_dropout=0.2,
                                    generator=torch.Generator().manual_seed(0))
    model_b = VisionTransformerMHLA(**geom, dropout=0.1, attn_dropout=0.2,
                                    generator=torch.Generator().manual_seed(0))
    u8, y = _batch(9)
    step = train.make_train_step(img_size)
    sa, ma = step(train.create_train_state(model_a, train.make_adamw(LR),
                                           device="cpu"), u8, y, 4)
    sb, mb = step(train.create_train_state(model_b, train.make_adamw(LR),
                                           device="cpu"), u8, y, 4)
    assert torch.equal(ma["loss_sum"], mb["loss_sum"])
    for name, p in model_a.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    attn = model_a.blocks[0].attn
    assert attn.qkv.weight.grad.abs().max() > 0
    assert attn.latent_proj.weight.grad.abs().max() > 0
    for pa, pb in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(pa, pb)


def test_train_and_evaluate_runs_the_reference_protocol():
    data = datasets.load_dataset("cifar10", data_dir="/nonexistent",
                                 subset_size=24, synthetic_sizes=(64, 32))
    model = VisionTransformerMHLA(**dict(GEOM, img_size=32, depth=1),
                                  dropout=0.1, attn_dropout=0.1)
    state = train.create_train_state(model, train.make_adamw(LR), device="cpu")
    lines = []
    band.reset_launch_count()
    out = train.train_and_evaluate(
        state, train.make_train_step(32, microbatch=4),
        train.make_eval_step(32), data, epochs=2, batch_size=8, seed=3,
        log_fn=lines.append)
    assert len(lines) == 2 and re.fullmatch(
        r"Epoch 2/2 \| Train Loss: \d+\.\d{4} \| Train Acc: \d+\.\d{2}% \| "
        r"Val Loss: \d+\.\d{4} \| Val Acc: \d+\.\d{2}% \| Time: \d+\.\d{2}s",
        lines[1])
    assert not out["interrupted"] and out["state"].step == 6
    assert np.isfinite(out["train_losses"]).all()
    assert sum(band.launch_count(k) for k in band.LAUNCH_KINDS) == 0
    detailed = train.evaluate_detailed(out["state"], data["test_images"],
                                       data["test_labels"], 8, 32, 10)
    assert detailed["confusion_matrix"].sum() == len(data["test_labels"])
    assert 0.0 <= detailed["auc_macro_ovr"] <= 1.0
    stopped = train.train_and_evaluate(
        state, train.make_train_step(32), train.make_eval_step(32), data,
        epochs=2, batch_size=8, should_stop=lambda: True, log_fn=lines.append)
    assert stopped["interrupted"] and not stopped["train_losses"]


# --- metrics -----------------------------------------------------------------


def test_metrics_with_ties_match_jax():
    rng = np.random.default_rng(11)
    n, c = 60, 5
    scores = np.round(rng.random((n, c)), 1).astype(np.float32)  # many ties
    labels = rng.integers(0, c - 1, size=n).astype(np.int32)  # class 4 absent
    logits = rng.normal(size=(n, c)).astype(np.float32)
    got_auc = train.auc_ovr(torch.from_numpy(scores),
                            torch.from_numpy(labels), c)
    want_auc = jmetrics.auc_ovr(jnp.asarray(scores), jnp.asarray(labels), c)
    assert abs(float(got_auc) - float(want_auc)) < 1e-6
    preds = scores.argmax(-1)
    np.testing.assert_array_equal(
        train.confusion_matrix(torch.from_numpy(preds),
                               torch.from_numpy(labels), c).numpy(),
        np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds),
                                             jnp.asarray(labels), c)))
    assert abs(float(train.accuracy_from_logits(
        torch.from_numpy(logits), torch.from_numpy(labels)))
        - float(jmetrics.accuracy_from_logits(
            jnp.asarray(logits), jnp.asarray(labels)))) < 1e-7
