"""Rank jobs for tests/test_torch_parallel.py, run in spawned processes by
``focused_attention_vit_tpu_torch.parallel.launch.run_ranks``.

This module imports no JAX and not the test module, so that each child
starts in a few seconds. :func:`job` takes ``(rank, world_size, cfg,
out)``: ``cfg`` a dict of plain values, ``out`` a directory for results.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from focused_attention_vit_tpu_torch import train
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
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
