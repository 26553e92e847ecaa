"""Train and eval step factories (port of
``focused_attention_vit_tpu/train/steps.py``).

``train_step(state, images_u8, labels, key)`` runs augmentation, the
forward (under ``torch.autocast`` when bf16 compute is asked for), the
cross-entropy, the backward and the AdamW update on the model's device, and
returns device-scalar metrics ``{loss_sum, correct, count}`` that the loop
reads once per epoch. PyTorch runs eagerly, so there is no jit: the step
queues its kernels and returns without waiting for the card.

Random streams derive from an int ``key`` by :func:`fold_in`, as the JAX
step derives its ``jax.random`` keys: microbatch i uses ``fold_in(key, i)``,
its augmentation draws from a generator seeded with that key and its
dropout from ``fold_in(that key, 1)``. The streams are torch's, not JAX's.

Where bf16 autocast keeps f32 (LayerNorm, softmax, the loss) and where the
JAX ``compute_dtype`` differs is recorded in PERF.md.

With ``mesh`` (a ``(data, model)`` mesh of :mod:`..parallel`, the state
sharded by ``parallel.shard_state``), both steps take the global batch on
every rank and run this rank's ``data`` rows: the augmentation is drawn for
the global batch (or microbatch) and sliced, the dropout key gets the data
rank folded in (:func:`~..parallel.sharding.dropout_rng`), and the metric
sums are summed over the ``data`` group, so every rank returns the global
batch's. JAX shards the batch over ``'data'`` with ``in_shardings``. Under
sequence and pipeline parallelism every rank of a ``seq`` and ``stage``
group computes the same loss and backpropagates its
:func:`~..parallel.sharding.loss_share` of it, so that the summed
gradients are those of one loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

import numpy as np

from focused_attention_vit_tpu_torch.data.pipeline import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    augment_train_batch,
    draw_augment_params,
    prepare_eval_batch,
)

_MASK64 = 2**64 - 1


def fold_in(key: int, data: int) -> int:
    """A new 63-bit seed from ``(key, data)`` (splitmix64's finaliser), the
    counterpart of ``jax.random.fold_in``."""
    x = (key * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def _device(model: torch.nn.Module) -> torch.device:
    p = next(model.parameters())
    return p.to_local().device if hasattr(p, "to_local") else p.device


def _local_rows(batch: int, n: int, mesh):
    """Row indices, in chunk order, of this rank's rows of each of the
    ``n`` chunks of a global batch, and the slice of one chunk that they
    are."""
    from focused_attention_vit_tpu_torch.parallel import sharding

    chunk = batch // n
    rows = sharding.data_rows(chunk, mesh)
    idx = np.concatenate([np.arange(i * chunk, (i + 1) * chunk)[rows]
                          for i in range(n)])
    return idx, rows


def _sum_over_data(metrics: dict, mesh) -> dict:
    from focused_attention_vit_tpu_torch.parallel import sharding

    keys = list(metrics)
    total = sharding.sum_over_data(
        torch.stack([torch.as_tensor(metrics[k]).double() for k in keys]),
        mesh)
    return dict(zip(keys, total.unbind()))


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    """bf16 (or f16) compute over the parameters' dtype; a no-op for f32
    and f64."""
    return torch.autocast(
        device.type, dtype=compute_dtype,
        enabled=compute_dtype in (torch.bfloat16, torch.float16),
    )


def _image_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    # Pixels are prepared in f32 under autocast (the first Linear casts
    # them), in f64 for an f64 run.
    return torch.promote_types(compute_dtype, torch.float32)


def make_train_step(
    img_size: int,
    *,
    augment: bool = True,
    mean=CIFAR10_MEAN,
    std=CIFAR10_STD,
    compute_dtype: torch.dtype = torch.float32,
    microbatch: Optional[int] = None,
    mesh=None,
) -> Callable:
    """Build ``train_step(state, images_u8, labels, key) -> (state,
    metrics)``. ``images_u8`` is uint8 NHWC and ``labels`` int, as numpy
    arrays or tensors; ``key`` is an int.

    With ``microbatch`` dividing the batch, the batch runs as chunks whose
    gradients add up in the parameters' f32 ``.grad`` and are divided by
    the chunk count: the mean of the chunk gradients, as JAX's scan. The
    live activations are one chunk's. Under ``mesh`` the microbatch must
    be a multiple of the data size: each chunk is itself split over the
    data ranks."""
    from focused_attention_vit_tpu_torch.parallel import sharding

    image_dtype = _image_dtype(compute_dtype)
    if mesh is not None and microbatch:
        dp = sharding.mesh_size(mesh, sharding.DATA)
        if microbatch % dp:
            raise ValueError(
                f"microbatch={microbatch} must be a multiple of the "
                f"data-parallel axis size {dp} (each accumulation chunk is "
                f"itself batch-sharded over 'data')")

    def fwd_bwd(model, images_u8, labels, key: int, chunk: int, rows):
        """One chunk: ``images_u8`` and ``labels`` are this rank's
        ``rows`` of a global chunk of ``chunk`` examples."""
        device = labels.device
        if augment:
            gen = torch.Generator(device=device).manual_seed(key)
            offsets, flips = draw_augment_params(chunk, gen)
            images = augment_train_batch(
                images_u8, None, img_size, mean=mean, std=std,
                dtype=image_dtype, offsets=offsets[rows], flips=flips[rows])
        else:
            images = prepare_eval_batch(images_u8, img_size, mean=mean,
                                        std=std, dtype=image_dtype)
        rng = sharding.dropout_rng(fold_in(key, 1), device, mesh)
        with _autocast(device, compute_dtype):
            logits = model(images, rng)
        # Promote-only: bf16 logits go to f32 for the loss; f64 stays f64.
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        loss = F.cross_entropy(logits, labels)
        (loss * sharding.loss_share(mesh)).backward()
        correct = (logits.detach().argmax(-1) == labels).sum()
        return loss.detach() * labels.shape[0], correct

    def train_step(state, images_u8, labels, key: int):
        model = state.model
        model.train()
        device = _device(model)
        b = len(labels)
        n = (b // microbatch
             if microbatch and b > microbatch and b % microbatch == 0 else 1)
        rows = slice(None)
        if mesh is not None:
            idx, rows = _local_rows(b, n, mesh)
            images_u8, labels = images_u8[idx], labels[idx]
        images_u8 = torch.as_tensor(images_u8).to(device, non_blocking=True)
        labels = torch.as_tensor(labels).to(device, torch.long,
                                            non_blocking=True)
        model.zero_grad(set_to_none=True)
        if n > 1:
            c = labels.shape[0] // n  # this rank's rows of a chunk
            loss_sum = correct = 0
            for i in range(n):
                chunk = slice(i * c, (i + 1) * c)
                ls, co = fwd_bwd(model, images_u8[chunk], labels[chunk],
                                 fold_in(key, i), microbatch, rows)
                loss_sum, correct = loss_sum + ls, correct + co
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(n)
        else:
            loss_sum, correct = fwd_bwd(model, images_u8, labels, key, b,
                                        rows)
        if state.layout is not None:
            state.layout.finish_grads()
        state.tx.step()
        state.step += 1
        metrics = {
            "loss_sum": loss_sum,
            "correct": correct,
            "count": torch.tensor(labels.shape[0], device=device),
        }
        if mesh is not None:
            metrics = _sum_over_data(metrics, mesh)
        return state, metrics

    return train_step


def make_eval_step(
    img_size: int,
    *,
    mean=CIFAR10_MEAN,
    std=CIFAR10_STD,
    compute_dtype: torch.dtype = torch.float32,
    return_logits: bool = False,
    mesh=None,
) -> Callable:
    """Build ``eval_step(state, images_u8, labels, mask) -> metrics``:
    the model in eval mode under ``inference_mode``, and the padded
    examples (``mask`` 0, see ``data.pipeline.padded_eval_batches``) zeroed
    out of the sums. The per-example CE is clamped at 0, as in JAX. Under
    ``mesh`` each rank runs its data rows and the sums are summed over the
    data group (``logits`` are this rank's rows)."""
    image_dtype = _image_dtype(compute_dtype)

    def eval_step(state, images_u8, labels, mask):
        model = state.model
        model.eval()
        device = _device(model)
        if mesh is not None:
            from focused_attention_vit_tpu_torch.parallel import sharding

            rows = sharding.data_rows(len(labels), mesh)
            images_u8, labels, mask = images_u8[rows], labels[rows], mask[rows]
        with torch.inference_mode():
            images_u8 = torch.as_tensor(images_u8).to(device,
                                                      non_blocking=True)
            labels = torch.as_tensor(labels).to(device, torch.long)
            mask = torch.as_tensor(mask).to(device, torch.float32)
            images = prepare_eval_batch(images_u8, img_size, mean=mean,
                                        std=std, dtype=image_dtype)
            with _autocast(device, compute_dtype):
                logits = model(images)
            logits = logits.float()
            losses = F.cross_entropy(logits, labels,
                                     reduction="none").clamp_min(0.0)
            correct = (logits.argmax(-1) == labels).float()
            metrics = {
                "loss_sum": (losses * mask).sum(),
                "correct": (correct * mask).sum(),
                "count": mask.sum(),
            }
            if mesh is not None:
                metrics = {k: v.float() for k, v in
                           _sum_over_data(metrics, mesh).items()}
            if return_logits:
                metrics["logits"] = logits
        return metrics

    return eval_step
