"""Quality metrics on the device: accuracy, confusion matrix, AUC (port of
``focused_attention_vit_tpu/train/metrics.py``)."""

from __future__ import annotations

import torch


def accuracy_from_logits(logits: torch.Tensor, labels: torch.Tensor
                         ) -> torch.Tensor:
    """Top-1 accuracy in [0, 1]."""
    return (logits.argmax(-1) == labels).float().mean()


def confusion_matrix(predictions: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """``[C, C]`` int32 counts, rows = true class, cols = predicted class."""
    flat = labels.long() * num_classes + predictions.long()
    counts = torch.bincount(flat, minlength=num_classes * num_classes)
    return counts.view(num_classes, num_classes).to(torch.int32)


def auc_ovr(scores: torch.Tensor, labels: torch.Tensor, num_classes: int
            ) -> torch.Tensor:
    """Macro-averaged one-vs-rest ROC AUC from ``[N, C]`` class scores.

    AUC for class c is the Mann-Whitney U statistic of the class-c scores
    of positives against negatives, with average ranks for ties; classes
    absent from ``labels`` (or present in all of them) are left out of the
    average. Ranks are counted in float64, exactly; the result is f32."""
    n = scores.shape[0]
    cols = scores.t().contiguous()  # [C, N]
    ordered, _ = torch.sort(cols, dim=1)
    below = torch.searchsorted(ordered, cols, right=False)  # count < s
    upto = torch.searchsorted(ordered, cols, right=True)    # count <= s
    avg_rank = (below + 1 + upto).double() / 2.0  # mean of ranks below+1..upto
    pos = (labels.long()[None, :] == torch.arange(
        num_classes, device=scores.device)[:, None]).double()  # [C, N]
    n_pos = pos.sum(1)
    n_neg = n - n_pos
    u = (avg_rank * pos).sum(1) - n_pos * (n_pos + 1) / 2.0
    auc = u / torch.clamp(n_pos * n_neg, min=1.0)
    valid = (n_pos > 0) & (n_neg > 0)
    total = torch.where(valid, auc, 0.0).sum()
    return (total / torch.clamp(valid.double().sum(), min=1.0)).float()
