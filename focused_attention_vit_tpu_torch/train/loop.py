"""Epoch-level training and eval loops (port of
``focused_attention_vit_tpu/train/loop.py``).

The progress line is the reference's ('Epoch {e}/{E} | Train Loss: … |
Train Acc: …% | Val Loss: … | Val Acc: …% | Time: …s'). The train pass reads
its metrics from the card once per epoch. Batches come from the numpy
iterator of ``data/pipeline.py``; the JAX package's native C++ prefetcher is
not ported yet.
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


def _epoch_pass(train_step, state, images, labels, batch_size, key: int,
                np_rng, should_stop=None):
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
                      batch_size: int, img_size: int, num_classes: int
                      ) -> Dict[str, Any]:
    """Full eval with the macro one-vs-rest AUC and the confusion matrix,
    in f32. JAX's version also takes the model; here it is
    ``state.model``."""
    model = state.model
    model.eval()
    device = next(model.parameters()).device
    all_probs = []
    with torch.inference_mode():
        for xb, _, mask in padded_eval_batches(images, labels, batch_size):
            x = prepare_eval_batch(torch.as_tensor(xb).to(device), img_size)
            probs = torch.softmax(model(x).float(), dim=-1)
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
    logging.getLogger(__name__).info("train batch pipeline: numpy iterator")

    total_start = time.time()
    interrupted = False
    interrupted_mid_epoch = False
    for epoch in range(epochs):
        if should_stop is not None and should_stop():
            interrupted = True  # between epochs: state is at a boundary
            break
        t0 = time.time()
        epoch_key = fold_in(seed, epoch_offset + epoch)
        state, tr_loss, tr_acc, completed = _epoch_pass(
            train_step, state, data["train_images"], data["train_labels"],
            batch_size, epoch_key, np_rng, should_stop=should_stop,
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
