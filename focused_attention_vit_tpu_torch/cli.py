"""CLI entry point (port of ``focused_attention_vit_tpu/cli.py``),
flag-compatible with the JAX package's:

    python -m focused_attention_vit_tpu_torch.cli --experiment traditional ...

The port runs the eight experiments, E1 ``traditional``, E2 ``sppp``, E3
``traditional_pretrained``, E4 ``sppp_pretrained``, E5 ``mhla_pretrained``,
E6 ``sppp_mhla_pretrained`` and the cross-attention suites E7
``cross_attention`` and E8 ``multihead_cross_attention`` (4A-4D, 5A-5D), on
one CUDA device (``--device cpu`` for the CPU). The pretrained runs load
``./pretrained_weights/<variant>_weights.pth`` or ``<variant>_flax.msgpack``
(python -m focused_attention_vit_tpu_torch.data.pretrained writes the seeded
stand-in there). ``--checkpoint_dir`` saves, resumes and handles SIGTERM as
in JAX: a preempted run exits with code 143 after its checkpoint is
committed, and the same command resumes it (E7 and E8 run four experiments
each and take no checkpoint directory). Every other flag of the JAX surface
is parsed; those the port does not act on yet raise an error that names the
flag, before anything runs. None is silently ignored. Set
``FAVIT_FUSED_MHA=1`` to take the fused short-sequence attention kernels
(``ops/mha_kernel.py``), and ``FAVIT_MHLA_IMPL=shiftband
FAVIT_USE_PALLAS_MHLA=1`` to take E5's and E6's MHLA through the tile band
(``ops/mhla_kernel_v4.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from focused_attention_vit_tpu_torch.experiments.base import (
    NOT_PORTED_DEFAULTS,
    not_ported,
)

CROSS_SUITES = ("cross_attention", "multihead_cross_attention")
EXPERIMENTS = [
    "traditional", "traditional_pretrained",
    "sppp", "sppp_pretrained",
    "cross_attention", "multihead_cross_attention",
    "mhla_pretrained", "sppp_mhla_pretrained",
]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Vision Transformer Experiments")

    # General settings
    parser.add_argument("--experiment", type=str, required=True,
                        choices=EXPERIMENTS)
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--results_dir", type=str, default="./results")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default=None,
                        help="default: the CUDA device; 'cpu' for the CPU")

    # Dataset settings
    parser.add_argument("--dataset", type=str, default="cifar10",
                        choices=["cifar10", "cifar100", "imagenet"])
    parser.add_argument("--img_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--subset_size", type=int, default=None)

    # Model settings
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--embed_dim", type=int, default=768)
    parser.add_argument("--depth", type=int, default=12)
    parser.add_argument("--num_heads", type=int, default=12)
    parser.add_argument("--mlp_ratio", type=float, default=4.0)
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--attn_dropout", type=float, default=0.0)
    parser.add_argument("--embed_dropout", type=float, default=0.0)

    # SPPP settings
    parser.add_argument("--num_superpixels", type=int, default=16)
    parser.add_argument("--compactness", type=float, default=0.1)
    parser.add_argument("--pooling_type", type=str, default="mean",
                        choices=["mean", "max", "attention"])
    parser.add_argument("--slic_iters", type=int, default=10)
    parser.add_argument("--slic_connectivity", type=str, default="auto",
                        choices=["auto", "on", "off", "host"])

    # MHLA settings
    parser.add_argument("--window_size", type=int, default=7)

    # Training settings
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--lr_schedule", type=str, default="constant",
                        choices=["constant", "cosine"],
                        help="LR schedule (extension; reference = constant)")
    parser.add_argument("--warmup_epochs", type=float, default=0.0,
                        help="Linear LR warmup, in (fractional) epochs")
    parser.add_argument("--grad_clip_norm", type=float, default=None,
                        help="Global-norm gradient clipping (extension)")
    parser.add_argument("--mu_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="AdamW first-moment dtype; bfloat16 is not "
                             "ported yet")

    # Pretrained settings
    parser.add_argument("--pretrained_model_variant", type=str, default="vit_b_16")
    parser.add_argument("--pretrained_source", type=str, default="torchvision",
                        choices=["torchvision", "huggingface"])
    parser.add_argument("--freeze_layers", action="store_true")
    parser.add_argument("--head_learning_rate", type=float, default=1e-3)

    # Visualization settings (not ported yet)
    parser.add_argument("--visualize", action="store_true")

    # Extensions of the JAX package
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="Save the train state every epoch and resume "
                             "from the latest checkpoint here")
    parser.add_argument("--sync_checkpoint", action="store_true",
                        help="Block on each checkpoint save (default: the "
                             "save runs in the background)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="not ported yet")
    parser.add_argument("--no_detailed_metrics", action="store_true",
                        help="Skip AUC/confusion-matrix computation")
    parser.add_argument("--remat", action="store_true", help="not ported yet")
    parser.add_argument("--remat_policy", type=str, default=None,
                        choices=["full", "band_weights"],
                        help="not ported yet")
    parser.add_argument("--scan_layers", action="store_true",
                        help="not ported yet")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Compute dtype (bfloat16: autocast over "
                             "float32 parameters)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="not ported yet")
    parser.add_argument("--tp", type=int, default=1, help="not ported yet")
    parser.add_argument("--sp", type=int, default=1, help="not ported yet")
    parser.add_argument("--fsdp", action="store_true", help="not ported yet")
    parser.add_argument("--pp", type=int, default=1, help="not ported yet")
    parser.add_argument("--microbatch", type=int, default=None,
                        help="Gradient-accumulation chunk of the train step "
                             "(identical batch math; smaller live "
                             "activation set); must be a proper divisor of "
                             "--batch_size. Default: auto (off); 0 disables")

    return parser.parse_args(argv)


def reject_not_ported(args) -> None:
    """Raise for every flag and choice the port parses but does not act on
    yet, naming it; nothing is silently ignored."""
    if args.dataset == "imagenet":
        raise not_ported("dataset", args.dataset)
    if args.visualize:
        raise not_ported("visualize", True)
    if args.mu_dtype == "bfloat16":
        raise not_ported("mu_dtype", args.mu_dtype)
    for flag, off in NOT_PORTED_DEFAULTS.items():
        if getattr(args, flag) != off:
            raise not_ported(flag, getattr(args, flag))
    if args.checkpoint_dir and args.experiment in CROSS_SUITES:
        # JAX's suites drop the flag; four runs would resume from one
        # directory.
        raise ValueError(
            f"--checkpoint_dir: --experiment {args.experiment} runs four "
            f"experiments and takes no checkpoint directory")


def _common_kwargs(args):
    return dict(
        img_size=args.img_size,
        patch_size=args.patch_size,
        in_channels=3,
        num_classes=10 if args.dataset == "cifar10" else 100,
        embed_dim=args.embed_dim,
        depth=args.depth,
        num_heads=args.num_heads,
        mlp_ratio=args.mlp_ratio,
        dropout=args.dropout,
        attn_dropout=args.attn_dropout,
        embed_dropout=args.embed_dropout,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        lr_schedule=args.lr_schedule,
        warmup_epochs=args.warmup_epochs,
        grad_clip_norm=args.grad_clip_norm,
        mu_dtype=args.mu_dtype,
        epochs=args.epochs,
        device=args.device,
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        subset_size=args.subset_size,
        dataset=args.dataset,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        sync_checkpoint=args.sync_checkpoint,
        profile_dir=args.profile_dir,
        detailed_metrics=not args.no_detailed_metrics,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
        remat_policy=args.remat_policy,
        scan_layers=args.scan_layers,
        num_devices=args.num_devices,
        fsdp=args.fsdp,
        tp=args.tp,
        sp=args.sp,
        pp=args.pp,
        microbatch=args.microbatch,
    )


def _pretrained_kwargs(args):
    return dict(
        pretrained_model_variant=args.pretrained_model_variant,
        pretrained_source=args.pretrained_source,
        freeze_layers=args.freeze_layers,
        head_learning_rate=args.head_learning_rate,
    )


def _sppp_kwargs(args):
    return dict(
        num_superpixels=args.num_superpixels,
        compactness=args.compactness,
        pooling_type=args.pooling_type,
        slic_connectivity=args.slic_connectivity,
        slic_iters=args.slic_iters,
    )


def _backend(device) -> str:
    """What the ``Backend:`` log line names: the CUDA device, or the CPU
    when the caller asked for it. Without CUDA and without ``--device
    cpu`` this raises; the run does not move to the CPU by itself."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return f"{device.type} (torch {torch.__version__})"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the CPU"
        )
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return (f"cuda ({torch.cuda.get_device_name(index)}, torch "
            f"{torch.__version__}, CUDA {torch.version.cuda})")


def main(argv=None):
    args = parse_args(argv)
    reject_not_ported(args)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=[
            logging.FileHandler("vit_experiments.log"),
            logging.StreamHandler(sys.stdout),
        ],
    )
    logger = logging.getLogger("focused_attention_vit_tpu_torch")

    os.makedirs(args.data_dir, exist_ok=True)
    os.makedirs(args.results_dir, exist_ok=True)

    logger.info("Experiment: %s", args.experiment)
    logger.info("Dataset: %s", args.dataset)
    logger.info("Backend: %s", _backend(args.device))
    logger.info("Batch size: %d", args.batch_size)
    logger.info("Epochs: %d", args.epochs)
    logger.info("Fused short-sequence attention (FAVIT_FUSED_MHA): %s",
                "on" if os.environ.get("FAVIT_FUSED_MHA", "0") == "1"
                else "off")

    from focused_attention_vit_tpu_torch import experiments as exp

    name = args.experiment
    instance = None
    if name == "traditional":
        instance = exp.TraditionalViTExperiment(**_common_kwargs(args))
    elif name == "sppp":
        instance = exp.SPPPExperiment(**_common_kwargs(args),
                                      **_sppp_kwargs(args))
    elif name == "traditional_pretrained":
        instance = exp.PretrainedTraditionalViTExperiment(
            **_common_kwargs(args), **_pretrained_kwargs(args))
    elif name == "sppp_pretrained":
        instance = exp.PretrainedSPPPExperiment(
            **_common_kwargs(args), **_pretrained_kwargs(args),
            **_sppp_kwargs(args))
    elif name == "mhla_pretrained":
        instance = exp.PretrainedMHLAViTExperiment(
            **_common_kwargs(args), **_pretrained_kwargs(args),
            window_size=args.window_size)
    elif name == "sppp_mhla_pretrained":
        instance = exp.PretrainedSPPPMHLAExperiment(
            **_common_kwargs(args), **_pretrained_kwargs(args),
            **_sppp_kwargs(args), window_size=args.window_size)
    elif name == "cross_attention":
        exp.run_cross_attention_experiments(args)
    else:  # multihead_cross_attention
        exp.run_multihead_cross_attention_experiments(args)
    if instance is not None:
        instance.run()
        if instance.preempted:
            # 128 + SIGTERM: a supervisor sees a termination, restarts the
            # command, and --checkpoint_dir resumes it.
            raise SystemExit(143)
    return instance


if __name__ == "__main__":
    main()
