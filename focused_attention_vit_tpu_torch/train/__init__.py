"""Training: train state and optimizers, the train and eval steps, the
epoch loops and the quality metrics (the JAX package's ``train`` names that
the port has)."""

from focused_attention_vit_tpu_torch.train.loop import (
    evaluate,
    evaluate_detailed,
    train_and_evaluate,
)
from focused_attention_vit_tpu_torch.train.metrics import (
    accuracy_from_logits,
    auc_ovr,
    confusion_matrix,
)
from focused_attention_vit_tpu_torch.train.state import (
    OptimizerSpec,
    TrainState,
    create_train_state,
    make_adamw,
    make_grouped_optimizer,
    make_lr_schedule,
)
from focused_attention_vit_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
)

__all__ = [
    "OptimizerSpec",
    "TrainState",
    "create_train_state",
    "make_adamw",
    "make_grouped_optimizer",
    "make_lr_schedule",
    "make_train_step",
    "make_eval_step",
    "train_and_evaluate",
    "evaluate",
    "evaluate_detailed",
    "accuracy_from_logits",
    "confusion_matrix",
    "auc_ovr",
]
