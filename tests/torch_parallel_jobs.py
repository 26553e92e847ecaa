"""Rank jobs for tests/test_torch_parallel.py and
tests/test_torch_sequence_pipeline.py, run in spawned processes by
``focused_attention_vit_tpu_torch.parallel.launch.run_ranks``.

This module imports no JAX and not the test module, so that each child
starts in a few seconds. :func:`job` and :func:`sequence_pipeline_job`
take ``(rank, world_size, cfg, out)``: ``cfg`` a dict of plain values,
``out`` a directory for results.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from focused_attention_vit_tpu_torch import train
from focused_attention_vit_tpu_torch.models import (
    PretrainedViTWithMHLA,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.models.layers import inverted_dropout
from focused_attention_vit_tpu_torch.parallel import (
    make_mesh,
    make_sharded_train_step,
    param_sharding_rules,
    shard_state,
    state_shardings,
)
from focused_attention_vit_tpu_torch.parallel import sharding
from focused_attention_vit_tpu_torch.train.checkpoint import CheckpointManager

CPU = torch.device("cpu")


def batches(cfg):
    """The global batches of a run, the same on every rank."""
    rng = np.random.default_rng(cfg["data_seed"])
    hw, b = cfg["model"]["img_size"], cfg["batch"]
    return [(rng.integers(0, 256, size=(b, hw, hw, 3), dtype=np.uint8),
             rng.integers(0, cfg["model"]["num_classes"], size=b))
            for _ in range(cfg["steps"])]


def build_model(cfg, **over):
    model = VisionTransformerMHLA(**{**cfg["model"], **over})
    model.load_state_dict(torch.load(cfg["init"], weights_only=True))
    return model


def _sharded(cfg, tp, fsdp, **over):
    mesh = make_mesh(dist.get_world_size(), tp=tp)
    state = train.create_train_state(build_model(cfg, **over),
                                     train.make_adamw(cfg["lr"]), device=CPU)
    return mesh, state, shard_state(state, mesh, fsdp=fsdp)


def _train_run(rank, cfg, out, name, tp, fsdp):
    """``cfg["steps"]`` steps of ``make_sharded_train_step`` on a
    ``(world / tp, tp)`` mesh from the saved initial weights: rank 0 saves
    the losses, the gathered final state and the placement rules; every
    rank the numel of its pieces."""
    plain = build_model(cfg)
    mesh, _, state = _sharded(cfg, tp, fsdp)
    rules = param_sharding_rules(plain, mesh, fsdp=fsdp)
    step = make_sharded_train_step(plain, state.tx.spec, mesh,
                                   cfg["model"]["img_size"], augment=False)
    losses = []
    for i, (x, y) in enumerate(batches(cfg)):
        _, _, m = step(state.model, state.tx, x, y, i)
        losses.append(float(m["loss"]))
    state.step = len(losses)  # JAX's step signature carries no counter
    full = state.layout.full_state(state)
    torch.save({n: sharding._local(p).numel()
                for n, p in state.layout.params.items()},
               os.path.join(out, f"{name}.numel{rank}.pt"))
    if name == cfg.get("checkpoint_run"):
        CheckpointManager(cfg["checkpoint"]).save(cfg["steps"], state)
    if rank == 0:
        torch.save({"losses": losses, "model": full["model"],
                    "optimizer": full["optimizer"], "rules": rules,
                    "state_rules": state_shardings(state)},
                   os.path.join(out, f"{name}.pt"))


def _restore_run(rank, cfg, out, tp, fsdp):
    """A full checkpoint restored into a ``tp``/``fsdp`` layout, gathered
    back: rank 0 saves the gathered state."""
    _, _, state = _sharded(cfg, tp, fsdp)
    CheckpointManager(cfg["restore"]).restore(state)
    full = state.layout.full_state(state)
    if rank == 0:
        torch.save(full, os.path.join(out, "restored.pt"))


def _dropout_run(rank, cfg, out):
    """Dropout on, at the job's ``(dp, tp)``: keep masks drawn from this
    rank's shared and local streams, block 0's MLP-output zeros and the
    logits of one train-mode forward of the same input on every rank, and
    after one train step (augmentation on) the replicated parameters."""
    over = dict(dropout=0.25, attn_dropout=0.25)
    mesh, _, state = _sharded(cfg, cfg["dropout_tp"], False, **over)
    rng = sharding.dropout_rng(7, CPU, mesh)
    shared = inverted_dropout(torch.ones(64, 64), 0.25, rng) > 0
    local = inverted_dropout(torch.ones(64, 64), 0.25, rng.local) > 0
    model = state.layout.module
    seen = {}
    model.blocks[0].mlp.register_forward_hook(
        lambda m, a, o: seen.setdefault("mlp_out_zero", (o == 0).clone()))
    model.train()
    hw = cfg["model"]["img_size"]
    x = torch.randn(4, hw, hw, 3, generator=torch.Generator().manual_seed(0))
    logits = model(x, sharding.dropout_rng(11, CPU, mesh)).detach()
    step = train.make_train_step(hw, mesh=mesh)
    (xb, yb), = batches(dict(cfg, steps=1))
    step(state, xb, yb, 5)
    torch.save({"shared": shared, "local": local,
                "mlp_out_zero": seen["mlp_out_zero"], "logits": logits,
                "replicated": {n: sharding._local(p).detach().clone()
                               for n, p in state.layout.params.items()
                               if n not in state.layout.sliced},
                "data_rank": mesh.get_local_rank("data"),
                "model_rank": mesh.get_local_rank("model")},
               os.path.join(out, f"dropout{rank}.pt"))


def job(rank, world_size, cfg, out):
    for name, tp, fsdp in cfg["runs"]:
        _train_run(rank, cfg, out, name, tp, fsdp)
    if cfg.get("restore"):
        _restore_run(rank, cfg, out, *cfg["restore_layout"])
    if cfg.get("dropout_tp"):
        _dropout_run(rank, cfg, out)


# --- sequence and pipeline parallelism (tests/test_torch_sequence_pipeline.py)


class _CountOp(TorchDispatchMode):
    """Counts the calls of one aten op (forward and backward)."""

    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is self.op
        return func(*args, **(kwargs or {}))


def _sp_pp_state(cfg, key, world, tp=1, sp=1, pp=1, fsdp=False, **over):
    """A ``(dp, tp, sp, pp)`` state of the saved initial weights of model
    ``key``: the model takes the mesh's seq and stage dimensions (the
    pipeline under scan_layers, as in JAX)."""
    mesh = make_mesh(world, tp=tp, sp=sp, pp=pp)
    kw = {**cfg[key]["model"], **over}
    model = VisionTransformerMHLA(
        **kw, scan_layers=pp > 1, sp_mesh=mesh if sp > 1 else None,
        pp_mesh=mesh if pp > 1 else None)
    model.load_state_dict(torch.load(cfg[key]["init"], weights_only=True))
    state = train.create_train_state(model, train.make_adamw(cfg["lr"]),
                                     device=CPU)
    return mesh, shard_state(state, mesh, fsdp=fsdp)


def _sp_pp_steps(cfg, key, mesh, state):
    step = train.make_train_step(cfg[key]["model"]["img_size"],
                                 augment=False, mesh=mesh)
    losses = []
    for i, (x, y) in enumerate(batches(dict(cfg, **cfg[key]))):
        state, m = step(state, x, y, i)
        losses.append(float(m["loss_sum"] / m["count"]))
    return losses


def _sp_pp_run(rank, world, cfg, out, name, key, tp, sp, pp, fsdp):
    """``cfg["steps"]`` train steps from the saved weights; rank 0 saves
    the losses and the gathered state. The ``checkpoint_run`` also saves a
    checkpoint and resumes it into a fresh state on the same mesh."""
    mesh, state = _sp_pp_state(cfg, key, world, tp, sp, pp, fsdp)
    losses = _sp_pp_steps(cfg, key, mesh, state)
    state.step = len(losses)
    full = state.layout.full_state(state)
    resumed = None
    if name == cfg.get("checkpoint_run"):
        CheckpointManager(cfg["checkpoint"]).save(state.step, state)
        _, fresh = _sp_pp_state(cfg, key, world, tp, sp, pp, fsdp)
        CheckpointManager(cfg["checkpoint"]).restore(fresh)
        resumed = fresh.layout.full_state(fresh)
    if rank == 0:
        torch.save({"losses": losses, "model": full["model"],
                    "optimizer": full["optimizer"], "resumed": resumed},
                   os.path.join(out, f"{name}.pt"))


def _pp_remat_counts(rank, world, cfg, out):
    """The dense band's softmax calls in one train step of the 4-stage
    pipeline (one block a stage, 4 microbatches): without remat, under full
    remat and under ``band_weights``."""
    counts = {}
    for policy in (None, "full", "band_weights"):
        kw = {} if policy is None else dict(remat=True, remat_policy=policy)
        mesh, state = _sp_pp_state(cfg, "pp", world, pp=world, **kw)
        with _CountOp(torch.ops.aten._softmax.default) as count:
            losses = _sp_pp_steps(dict(cfg, steps=1), "pp", mesh, state)
        counts[str(policy)] = (count.n, losses[0])
    if rank == 0:
        torch.save(counts, os.path.join(out, "remat.pt"))


def _sp_dropout(rank, world, cfg, out):
    """The SP band's weights dropout at rate 0.25 over a 4-rank seq group:
    each rank's keep mask from one seed, twice, and from another seed."""
    from focused_attention_vit_tpu_torch.parallel import sequence

    mesh = make_mesh(world, sp=world)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 197, 8, generator=g) for _ in range(3))
    shards = sequence.SeqShards.of(mesh, "seq", 197)
    q, k, v = (sequence.local_rows(t, shards, 2) for t in (q, k, v))

    def keep(seed):
        rng = sharding.dropout_rng(seed, CPU, mesh)
        seen = {}

        def drop(w):
            out = inverted_dropout(w, 0.25, rng)
            seen["keep"] = out != 0
            return out

        sequence.sp_windowed_attention(q, k, v, 7, shards, drop)
        return seen["keep"]

    torch.save({"a": keep(3), "again": keep(3), "b": keep(4),
                "rank": mesh.get_local_rank("seq")},
               os.path.join(out, f"spdrop{rank}.pt"))


def _pretrained_sp(rank, world, cfg, out):
    """``PretrainedViTWithMHLA`` on a (data 2, seq 2) mesh: the logits of
    the global batch, each data rank's rows gathered."""
    mesh = make_mesh(world, sp=2)
    c = cfg["pretrained"]
    model = PretrainedViTWithMHLA(**c["model"], sp_mesh=mesh).eval()
    model.load_state_dict(torch.load(c["init"], weights_only=True))
    x = torch.load(c["x"], weights_only=True)
    with torch.no_grad():
        logits = sharding.gather_rows(
            model(x[sharding.data_rows(len(x), mesh)]), mesh)
    if rank == 0:
        torch.save(logits, os.path.join(out, "pretrained.pt"))


def sequence_pipeline_job(rank, world_size, cfg, out):
    for name, key, tp, sp, pp, fsdp in cfg["runs"]:
        _sp_pp_run(rank, world_size, cfg, out, name, key, tp, sp, pp, fsdp)
    _pp_remat_counts(rank, world_size, cfg, out)
    _sp_dropout(rank, world_size, cfg, out)
    _pretrained_sp(rank, world_size, cfg, out)
