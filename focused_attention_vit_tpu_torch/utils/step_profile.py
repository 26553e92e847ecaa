"""Where the card's time goes in one serving forward or one train step.

Runs the port's model at ViT-B width (D=768, 12 heads, 224x224 images in
patches of ``--patch_size``: 4 gives S=3137, 16 gives S=197; 10 classes,
seeded random weights) on an NVIDIA GPU under
``torch.profiler`` and prints the device time per step by kind of kernel
(matrix products, the hand-written attention kernels, copies, LayerNorm,
dropout, other elementwise, reductions, the optimizer), the busiest kernels
by name, the wall time per step and the device's idle share, then the same
as one JSON line. From the repository root::

    python -m focused_attention_vit_tpu_torch.utils.step_profile \\
        --model vit --mode train --batch_size 32

MHLA through the tile band (K6/K7) instead of the S-minor band (K1/K2)::

    FAVIT_MHLA_IMPL=shiftband FAVIT_USE_PALLAS_MHLA=1 python -m \\
        focused_attention_vit_tpu_torch.utils.step_profile \\
        --model vit_mhla --mode serve --batch_size 32

The E1 step at ViT-B/16, with and without the fused short-S attention::

    FAVIT_FUSED_MHA=1 python -m \\
        focused_attention_vit_tpu_torch.utils.step_profile --model vit \\
        --mode train --patch_size 16 --batch_size 128 --attn_dropout 0.1

It needs CUDA and raises without it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

DROPOUT = 0.1  # the train mode's MLP dropout, as chip_smoke.py's
TOP = 25       # kernels listed by name
SLIC_RANGE = "slic"  # ops/slic.py's profiler range

# First match wins; names are those of PyTorch's, cuBLAS's and this
# package's kernels as the profiler reports them.
CATEGORIES = (
    ("fused attention kernels", r"fused_(fwd|bwd|keep)"),
    ("flash kernels", r"flash_(fwd|bwd|delta)"),
    ("tile band kernels", r"tile_band_(fwd|bwd)"),
    ("band kernels", r"band_(fwd|bwd)"),
    ("GEMMs", r"gemm|cutlass|cublas|xmma|nvjet|gemv"),
    ("optimizer",
     r"multi_tensor|[Aa]dam|Optimizer|foreach|lerp|addcdiv|addcmul"),
    ("LayerNorm", r"layer_norm|LayerNorm|GammaBeta"),
    ("dropout masks and where", r"bernoulli|philox|where"),
    ("GELU", r"gelu|Gelu"),
    ("copies and casts", r"copy|Memcpy|Memset|CatArray|cast"),
    ("reductions", r"reduce|[Ss]oft[Mm]ax|sum|nll_loss"),
    ("other elementwise", r"elementwise|vectorized|index|fill"),
)


def categorize(name: str) -> str:
    for label, pattern in CATEGORIES:
        if re.search(pattern, name):
            return label
    return "other"


def _build(args, device):
    from focused_attention_vit_tpu_torch import models

    kw = dict(img_size=224, patch_size=args.patch_size, num_classes=10,
              depth=args.depth, device=device,
              generator=torch.Generator().manual_seed(0))
    if args.mode == "train":
        kw.update(dropout=DROPOUT, attn_dropout=args.attn_dropout)
    if args.model == "vit":
        return models.VisionTransformer(**kw)
    if args.model == "sppp":
        return models.SPPPViT(**kw)
    if args.model == "sppp_mhla":
        return models.SPPPViTMHLA(use_mhla=True, **kw)
    if args.model == "pretrained_sppp_mhla":
        return models.PretrainedSPPPViTWithMHLA(**kw)
    return models.VisionTransformerMHLA(**kw)


def _step_fn(args, model):
    """A callable that runs one serving forward or one train step."""
    from focused_attention_vit_tpu_torch import train
    from focused_attention_vit_tpu_torch.infer import Predictor

    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(args.batch_size, 32, 32, 3),
                      dtype=np.uint8)
    if args.mode == "serve":
        predictor = Predictor(model, img_size=224, device="cuda",
                              batch_size=args.batch_size,
                              compute_dtype=torch.bfloat16)
        return lambda i: predictor.predict_proba(u8)
    y = rng.integers(0, 10, size=args.batch_size)
    holder = [train.create_train_state(model, train.make_adamw(1e-4))]
    step = train.make_train_step(224, compute_dtype=torch.bfloat16,
                                 microbatch=args.microbatch)

    def run(i):
        holder[0], _ = step(holder[0], u8, y, i)

    return run


def profile(run, steps: int) -> dict:
    """``run(i)`` for ``steps`` steps under ``torch.profiler``, each ending
    in a device sync: the wall ms a step, the kernels' ms a step (in all,
    by kind, and as ``(name, ms, launches)``), and the ``slic`` range's host
    and device ms a step (0 where no SLIC ran)."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    averages = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps,
                e.count / steps)
               for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != SLIC_RANGE]  # the range's own device span
    total = sum(ms for _, ms, _ in kernels)
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_kind: dict = {}
    for name, ms, _ in kernels:
        kind = categorize(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    slic = [e for e in averages if e.key == SLIC_RANGE
            and e.device_type == torch.autograd.DeviceType.CPU]
    return {"wall_ms": wall_ms, "kernel_ms": total, "by_kind_ms": by_kind,
            "kernels": kernels,
            "slic_host_ms": sum(e.cpu_time_total for e in slic) / 1e3 / steps,
            "slic_device_ms": sum(e.device_time_total for e in slic) / 1e3
            / steps}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=["vit", "vit_mhla", "sppp", "sppp_mhla",
                                       "pretrained_sppp_mhla"],
                   default="vit")
    p.add_argument("--mode", choices=["serve", "train"], default="train")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--microbatch", type=int, default=None)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--attn_dropout", type=float, default=0.0)
    p.add_argument("--patch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile runs only on a CUDA device")

    run = _step_fn(args, _build(args, "cuda"))
    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile(lambda i: run(2 + i), args.steps)
    wall_ms, total = prof["wall_ms"], prof["kernel_ms"]
    kernels, by_kind = prof["kernels"], prof["by_kind_ms"]
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    print(f"{args.model} {args.mode}, batch {args.batch_size}, microbatch "
          f"{args.microbatch}, depth {args.depth}, patch {args.patch_size}, "
          f"fused switch {os.environ.get('FAVIT_FUSED_MHA', '0')}, MHLA "
          f"impl {os.environ.get('FAVIT_MHLA_IMPL', 'auto')} with tile-band "
          f"opt-in {os.environ.get('FAVIT_USE_PALLAS_MHLA', '0')}, dropout "
          f"{DROPOUT}, attn_dropout {args.attn_dropout}: "
          f"{wall_ms:.2f} ms wall per step (host clock, under the profiler), "
          f"{total:.2f} ms of kernels, device idle share "
          f"{max(0.0, 1 - total / wall_ms):.3f}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if prof["slic_host_ms"]:
        print(f"SLIC (the {SLIC_RANGE!r} range): {prof['slic_host_ms']:.2f} "
              f"ms of host time a step, {prof['slic_host_ms'] / wall_ms:.1%} "
              f"of the wall; {prof['slic_device_ms']:.2f} ms of kernels "
              f"launched in it")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {ms / total:6.1%}  {kind}")
    print(f"busiest {TOP} kernels (ms per step, launches per step):")
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:TOP]:
        print(f"  {ms:9.3f}  {count:7.1f}  [{categorize(name)}] {name[:110]}")
    summary = {"card": smi, "model": args.model, "mode": args.mode,
               "batch_size": args.batch_size, "wall_ms": wall_ms,
               "kernel_ms": total, "by_kind_ms": by_kind,
               "slic_host_ms": prof["slic_host_ms"],
               "slic_device_ms": prof["slic_device_ms"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
