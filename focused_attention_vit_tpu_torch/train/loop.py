"""Epoch-level training and eval loops (port of
``focused_attention_vit_tpu/train/loop.py``).

The progress line is the reference's ('Epoch {e}/{E} | Train Loss: … |
Train Acc: …% | Val Loss: … | Val Acc: …% | Time: …s'). The train pass reads
its metrics from the card once per epoch. Training batches come from the
native C++ prefetcher (:mod:`..data.native`, shuffled by
``std::mt19937_64``, as JAX's default run draws them) whenever the train set
holds a batch, else from the numpy iterator of ``data/pipeline.py``; a
failed g++ build raises instead of falling back.

Under a device mesh (:mod:`..parallel`) every rank runs the same loop on the
same global batches; the steps slice their rank's rows and sum the metrics
over the ``data`` group, and :func:`evaluate_detailed` gathers the
probabilities in batch order.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from focused_attention_vit_tpu_torch.data.pipeline import (
    batch_iterator,
    padded_eval_batches,
    prepare_eval_batch,
)
from focused_attention_vit_tpu_torch.train.metrics import (
    auc_ovr,
    confusion_matrix,
)
from focused_attention_vit_tpu_torch.train.steps import fold_in

logger = logging.getLogger(__name__)


def _epoch_pass(train_step, state, images, labels, batch_size, key: int,
                np_rng, prefetcher=None, should_stop=None):
    if prefetcher is not None:
        batches = prefetcher.epoch_batches()
    else:
        batches = batch_iterator(images, labels, batch_size, shuffle=True,
                                 rng=np_rng, drop_last=True)
    sums = []
    completed = True
    for bi, (xb, yb) in enumerate(batches):
        # Preemption poll: stop at a batch boundary, where the state is
        # consistent for the caller to checkpoint.
        if should_stop is not None and should_stop():
            completed = False
            break
        state, m = train_step(state, xb, yb, fold_in(key, bi))
        sums.append(torch.stack([m["loss_sum"].double(),
                                 m["correct"].double(),
                                 m["count"].double()]))
    # One host sync per epoch.
    loss_sum, correct, count = (
        torch.stack(sums).sum(0).tolist() if sums else (0.0, 0.0, 0.0))
    return (
        state,
        loss_sum / max(count, 1),
        100.0 * correct / max(count, 1),
        completed,
    )


def evaluate(eval_step, state, images: np.ndarray, labels: np.ndarray,
             batch_size: int) -> Dict[str, float]:
    """Full-dataset eval: loss and accuracy, and per-batch wall times (the
    reference times each eval batch; each batch waits for its result)."""
    loss_sum = correct = count = 0.0
    batch_times = []
    for xb, yb, mask in padded_eval_batches(images, labels, batch_size):
        t0 = time.time()
        m = eval_step(state, xb, yb, mask)
        m = {k: float(m[k]) for k in ("loss_sum", "correct", "count")}
        batch_times.append(time.time() - t0)
        loss_sum += m["loss_sum"]
        correct += m["correct"]
        count += m["count"]
    return {
        "loss": loss_sum / max(count, 1),
        "acc": 100.0 * correct / max(count, 1),
        "avg_batch_time": float(np.mean(batch_times)),
        # Divided by the real images, not the padded slots.
        "avg_image_time": float(np.sum(batch_times)) / max(count, 1),
        "count": count,
    }


def evaluate_detailed(state, images: np.ndarray, labels: np.ndarray,
                      batch_size: int, img_size: int, num_classes: int,
                      mesh=None) -> Dict[str, Any]:
    """Full eval with the macro one-vs-rest AUC and the confusion matrix,
    in f32. JAX's version also takes the model; here it is
    ``state.model``. With ``mesh`` each rank runs its rows of every batch
    and the probabilities are gathered over the ``data`` group in batch
    order (JAX constrains the batch to ``P('data')``)."""
    model = state.model
    model.eval()
    device = next(model.parameters()).device
    rows = slice(None)
    if mesh is not None:
        from focused_attention_vit_tpu_torch.parallel import sharding

        rows = sharding.data_rows(batch_size, mesh)
    all_probs = []
    with torch.inference_mode():
        for xb, _, mask in padded_eval_batches(images, labels, batch_size):
            x = prepare_eval_batch(torch.as_tensor(xb[rows]).to(device),
                                   img_size)
            probs = torch.softmax(model(x).float(), dim=-1)
            if mesh is not None:
                probs = sharding.gather_rows(probs, mesh)
            all_probs.append(probs[torch.as_tensor(mask, device=device) > 0])
        probs = torch.cat(all_probs)[:len(labels)]
        labels_t = torch.as_tensor(np.asarray(labels), device=device).long()
        preds = probs.argmax(-1)
        return {
            "accuracy": float((preds == labels_t).float().mean()),
            "auc_macro_ovr": float(auc_ovr(probs, labels_t, num_classes)),
            "confusion_matrix": confusion_matrix(
                preds, labels_t, num_classes).cpu().numpy(),
        }


def train_and_evaluate(
    state,
    train_step: Callable,
    eval_step: Callable,
    data: Dict[str, Any],
    *,
    epochs: int,
    batch_size: int,
    seed: int = 42,
    epoch_offset: int = 0,
    log_fn: Callable[[str], None] = print,
    epoch_callback: Optional[Callable[[int, Any], None]] = None,
    should_stop: Optional[Callable[[], bool]] = None,
) -> Dict[str, Any]:
    """The reference protocol: per epoch a train pass and a val pass.

    ``epoch_offset`` counts epochs trained before this call (a resume):
    epoch keys derive from the global epoch index, and the shuffle stream
    is seeded per segment. ``should_stop`` is polled at batch boundaries;
    when it returns True the loop stops, skips the partial epoch's metrics
    and val pass, and returns ``interrupted=True``. Returns the reference's
    training-metrics keys plus ``state``."""
    train_losses, train_accs, val_losses, val_accs, epoch_times = (
        [], [], [], [], [])
    np_rng = np.random.default_rng([seed, epoch_offset])

    # The native prefetcher whenever the train set holds a batch, seeded
    # per segment as in JAX; its build failing raises (no numpy fallback).
    prefetcher = None
    if len(data["train_images"]) >= batch_size:
        from focused_attention_vit_tpu_torch.data.native import (
            NativePrefetcher,
        )

        prefetcher = NativePrefetcher(
            data["train_images"], data["train_labels"], batch_size,
            seed=seed + 1_000_003 * epoch_offset)
    logger.info("train batch pipeline: %s",
                "native C++ prefetcher" if prefetcher is not None
                else "numpy iterator")

    total_start = time.time()
    interrupted = False
    interrupted_mid_epoch = False
    try:
        for epoch in range(epochs):
            if should_stop is not None and should_stop():
                interrupted = True  # between epochs: at a boundary
                break
            t0 = time.time()
            epoch_key = fold_in(seed, epoch_offset + epoch)
            state, tr_loss, tr_acc, completed = _epoch_pass(
                train_step, state, data["train_images"],
                data["train_labels"], batch_size, epoch_key, np_rng,
                prefetcher=prefetcher, should_stop=should_stop,
            )
            if not completed:
                interrupted = True
                interrupted_mid_epoch = True
                break
            val = evaluate(eval_step, state, data["test_images"],
                           data["test_labels"], batch_size)
            epoch_time = time.time() - t0

            train_losses.append(tr_loss)
            train_accs.append(tr_acc)
            val_losses.append(val["loss"])
            val_accs.append(val["acc"])
            epoch_times.append(epoch_time)

            log_fn(
                f"Epoch {epoch + 1}/{epochs} | "
                f"Train Loss: {tr_loss:.4f} | Train Acc: {tr_acc:.2f}% | "
                f"Val Loss: {val['loss']:.4f} | Val Acc: {val['acc']:.2f}% | "
                f"Time: {epoch_time:.2f}s"
            )
            if epoch_callback is not None:
                epoch_callback(epoch, state)
    finally:
        # Also on an exception: the worker thread and the copies of the
        # train set go now, not at some later collection.
        if prefetcher is not None:
            prefetcher.close()

    total_training_time = time.time() - total_start
    return {
        "interrupted": interrupted,
        "interrupted_mid_epoch": interrupted_mid_epoch,
        "state": state,
        "train_losses": train_losses,
        "train_accs": train_accs,
        "val_losses": val_losses,
        "val_accs": val_accs,
        "epoch_times": epoch_times,
        "avg_epoch_time": float(np.mean(epoch_times)) if epoch_times else 0.0,
        "total_training_time": total_training_time,
        "final_val_acc": val_accs[-1] if val_accs else 0.0,
        "final_val_loss": val_losses[-1] if val_losses else 0.0,
    }
