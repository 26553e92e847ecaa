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
each and take no checkpoint directory). ``--dataset imagenet`` reads an
ImageFolder tree under ``<data_dir>/imagenet`` (Pillow decodes it), and
``--visualize`` writes ``sample_images.png`` and ``sample_patches.png`` into
``--results_dir`` (matplotlib draws them). ``--num_devices N`` (-1: every
card) with ``--tp``, ``--sp``, ``--pp`` and ``--fsdp`` trains over a
``(data, model[, seq][, stage])`` mesh: with no ``RANK`` in the environment
the CLI starts N ranks itself (rank r on ``cuda:r`` over NCCL, or on the
CPU over gloo with ``--device cpu``), and under ``torchrun`` it joins the
ranks there; rank 0 alone prints and writes. ``--sp`` splits the tokens of
an MHLA-family model (the band exchanges halos), ``--pp`` runs the blocks
as a GPipe pipeline and, as in JAX, needs ``--scan_layers``. Every flag of
the JAX surface is acted on; none is silently ignored: ``--scan_layers``,
which means nothing to an eager loop, says so on stderr. Set
``FAVIT_FUSED_MHA=1`` to take the fused short-sequence attention kernels
(``ops/mha_kernel.py``), and ``FAVIT_MHLA_IMPL=shiftband
FAVIT_USE_PALLAS_MHLA=1`` to take E5's and E6's MHLA through the tile band
(``ops/mhla_kernel_v4.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

import torch


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
                        help="AdamW first-moment dtype (bfloat16 saves 2 "
                             "bytes a parameter; optax's rule)")

    # Pretrained settings
    parser.add_argument("--pretrained_model_variant", type=str, default="vit_b_16")
    parser.add_argument("--pretrained_source", type=str, default="torchvision",
                        choices=["torchvision", "huggingface"])
    parser.add_argument("--freeze_layers", action="store_true")
    parser.add_argument("--head_learning_rate", type=float, default=1e-3)

    # Visualization settings
    parser.add_argument("--visualize", action="store_true")

    # Extensions of the JAX package
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="Save the train state every epoch and resume "
                             "from the latest checkpoint here")
    parser.add_argument("--sync_checkpoint", action="store_true",
                        help="Block on each checkpoint save (default: the "
                             "save runs in the background)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler trace of the training "
                             "loop to DIR/trace.json (Perfetto)")
    parser.add_argument("--no_detailed_metrics", action="store_true",
                        help="Skip AUC/confusion-matrix computation")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute each block's activations in the "
                             "backward (less memory, more time)")
    parser.add_argument("--remat_policy", type=str, default=None,
                        choices=["full", "band_weights"],
                        help="What --remat saves (MHLA models): 'full' "
                             "nothing; 'band_weights' keeps the MHLA band "
                             "weights across the backward")
    parser.add_argument("--scan_layers", action="store_true",
                        help="Accepted for the JAX surface and a no-op here: "
                             "the blocks run in an eager loop (JAX rolls them "
                             "into one lax.scan); says so on stderr")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Compute dtype (bfloat16: autocast over "
                             "float32 parameters)")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Train on a mesh of N ranks (-1: every card); "
                             "the CLI starts them unless RANK is set")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel size (the mesh's model "
                             "dimension)")
    parser.add_argument("--sp", type=int, default=1,
                        help="Sequence-parallel size (the mesh's seq "
                             "dimension): each rank holds its share of the "
                             "tokens and windowed MHLA attention exchanges "
                             "a W//2-row halo with its neighbours "
                             "(parallel/sequence.py). MHLA models only")
    parser.add_argument("--fsdp", action="store_true",
                        help="Shard parameters and optimizer state over the "
                             "mesh's data dimension (FSDP2)")
    parser.add_argument("--pp", type=int, default=1,
                        help="Pipeline-parallel size (the mesh's stage "
                             "dimension); must divide the depth. GPipe "
                             "fill-drain over the blocks "
                             "(parallel/pipeline.py); requires "
                             "--scan_layers. Composes with --sp: each "
                             "stage's blocks exchange their halos")
    parser.add_argument("--microbatch", type=int, default=None,
                        help="Gradient-accumulation chunk of the train step "
                             "(identical batch math; smaller live "
                             "activation set); must be a proper divisor of "
                             "--batch_size. Default: auto (off); 0 disables")

    return parser.parse_args(argv)


def reject_unsupported(args) -> None:
    """Raise, before anything runs, for a flag combination the port does
    not run: ``--checkpoint_dir`` with E7/E8, whose four runs would share
    it."""
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


def _save_visualizations(args) -> None:
    """``--visualize``: a grid of 16 sample images and one image's patch
    grid, as ``sample_images.png`` and ``sample_patches.png`` in
    ``results_dir`` (JAX ``cli.py`` ``_save_visualizations``; the reference
    parses the flag and does nothing with it)."""
    import numpy as np

    from focused_attention_vit_tpu_torch.data.datasets import load_dataset
    from focused_attention_vit_tpu_torch.utils.viz import (
        CIFAR10_MEAN,
        CIFAR10_STD,
        visualize_images,
        visualize_patches,
    )

    data = load_dataset(
        args.dataset if args.dataset != "imagenet" else "cifar10",
        data_dir=args.data_dir,
        subset_size=max(16, args.subset_size or 16),
        seed=args.seed,
    )
    imgs = data["train_images"][:16].astype(np.float32) / 255.0
    # The plots denormalise; give them normalised values.
    normed = (imgs - np.array(CIFAR10_MEAN)) / np.array(CIFAR10_STD)
    visualize_images(normed, labels=data["train_labels"][:16],
                     class_names=data["class_names"],
                     save_path=os.path.join(args.results_dir,
                                            "sample_images.png"))
    visualize_patches(normed[0], patch_size=min(args.patch_size,
                                                imgs.shape[1]),
                      save_path=os.path.join(args.results_dir,
                                             "sample_patches.png"))
    print(f"Visualizations saved to {args.results_dir}")


def _world_size(args) -> int:
    """The ranks that ``--num_devices`` asks for: every card for -1, or
    for ``--tp``, ``--sp`` or ``--pp`` without ``--num_devices``, as JAX
    takes every device; one device on the CPU."""
    n = args.num_devices
    split = args.tp > 1 or args.sp > 1 or args.pp > 1
    if (n is None and split) or (n is not None and n <= 0):
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        n = 1 if cpu else torch.cuda.device_count()
    return n or 1


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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    reject_unsupported(args)

    import torch.distributed as dist

    from focused_attention_vit_tpu_torch.parallel import launch, multihost

    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    world = _world_size(args)
    if world % (args.tp * args.sp * args.pp):
        # JAX's make_mesh error, before anything runs or is written.
        raise ValueError(f"tp={args.tp} * sp={args.sp} * pp={args.pp} must "
                         f"divide device count {world}")
    if world > 1 and "RANK" not in os.environ:
        # The ranks run this same command; this process only waits.
        launch.launch_cli(argv, world, "gloo" if cpu else "nccl")
        return None
    own_group = "RANK" in os.environ and not dist.is_initialized()
    if own_group:  # torchrun
        multihost.initialize(backend="gloo" if cpu else "nccl")
    try:
        if dist.is_initialized() and dist.get_rank() != 0:
            # Rank 0 alone prints; the others' errors still reach stderr.
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                return _run(args)
        return _run(args)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args):
    from focused_attention_vit_tpu_torch.experiments.base import is_rank_zero

    rank_zero = is_rank_zero()
    logging.basicConfig(
        level=logging.INFO if rank_zero else logging.WARNING,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=[
            logging.FileHandler("vit_experiments.log"),
            logging.StreamHandler(sys.stdout),
        ] if rank_zero else [logging.StreamHandler(sys.stderr)],
    )
    logger = logging.getLogger("focused_attention_vit_tpu_torch")

    os.makedirs(args.data_dir, exist_ok=True)
    os.makedirs(args.results_dir, exist_ok=True)

    if args.visualize and rank_zero:
        _save_visualizations(args)

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
