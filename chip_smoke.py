#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Drives the serving path and the training path of
``focused_attention_vit_tpu_torch`` at MHLA-B/4 and at dense ViT-B/4 (D=768,
12 blocks, 12 heads of d=64, W=7 for MHLA, patch 4 on 224x224, S=3137, 10
classes, seeded random weights), then experiment E1 ``traditional`` at
ViT-B/16 (patch 16, S=197) through the CLI, then MHLA-B/4 again through the
tile band (``FAVIT_MHLA_IMPL=shiftband FAVIT_USE_PALLAS_MHLA=1``), then the
pretrained fine-tunes E3 ``traditional_pretrained`` and E5
``mhla_pretrained`` at ViT-B/16 from a seeded vit_b_16 checkpoint and
``PretrainedViTWithMHLA`` (W=4, S=3137), then the SPPP family (SLIC,
``SPPPViT``, E2 ``sppp``, E4 ``sppp_pretrained``, E6
``sppp_mhla_pretrained`` and ``PretrainedSPPPViTWithMHLA``, whose blocks
see R+1 = 17 tokens), and last the cross-attention suites E7 and E8, E1
preempted by SIGTERM and resumed from its checkpoint, serving from that
checkpoint directory and the MHLA-B/4 train state's checkpoint round trip,
and checks every CUDA kernel on them.
Phases, one or more lines each; any failure raises and exits non-zero:

1. device: requires CUDA and compute capability 9.0; prints the card's name
   and ``nvidia-smi`` name and power limit;
2. build: compiles the eight kernel sources from ``csrc/`` with nvcc, and
   ``native/connectivity.cpp`` with g++, in parallel, and prints ptxas's registers, spills and shared memory of the
   main path's wgmma kernels and of every instantiation of the band
   forward (K1) and backward (K2) and of the tile band's forward (K6, K8)
   and backward (K7);
3. kernel: the eval band kernel against its plain PyTorch version on the
   card (f32 within 1e-5 abs, bf16 within 2 bf16 ulps) over a grid of
   shapes and at the serving shape, with CUDA-event timings of both, the
   kernel's GB/s and its device time under the profiler;
4. kernel-train: the training forward (output, saved weights, dropout mask
   bit for bit) and the backward kernel against their plain versions over a
   grid of shapes and at the training shape, at dropout 0 and 0.1, with
   CUDA-event timings; the forward's GB/s and device time; the backward run
   twice gives the same bits, and the profiler splits its time between its
   two passes;
5. model: MHLA-B/4 in f32 on the card against the same weights on the CPU;
6. serve: the ``serve`` module's set-up, ``BatchingServer`` and
   ``HTTPFrontend`` answer concurrent requests in bf16; the eval launch
   counter must equal 12 x the forward passes run;
7. train-parity: one train step of MHLA-B/4 cut to 2 blocks, f32 with TF32
   off, on the card and on the CPU from the same weights and batch: loss
   and per-leaf gradients agree, and the card launched 2 training forwards
   and 2 backwards;
8. train: MHLA-B/4 trains through ``train.train_and_evaluate`` in bf16
   autocast at batch 32 with dropout 0.1 on synthetic CIFAR (one epoch and
   its val pass), then a short run with attention dropout 0.1 and
   microbatch 16; losses finite, every parameter moved, the launch counts
   equal 12 x the passes run; ms per step, images/s and peak memory.

9. kernel-flash: the flash-attention forward (eval and training, with its
   log-sum-exp) and backward kernels (wgmma products, TMA tiles in an
   mbarrier ring) against their plain versions over a grid of head dims and
   shapes and at the serving shape, f32 and bf16; the backward run twice
   gives the same bits; CUDA-event timings of the kernels, the plain
   versions and PyTorch's fused attention (timed here as the yardstick,
   used nowhere in the port), and for each bf16 kernel its TFLOP/s, its
   share of ``bound_ms`` and its ratio to the library call;
10. vit-model: dense ViT-B/4 in f32 on the card against the same weights on
    the CPU;
11. vit-serve: ``serve.setup(["--model", "vit", ...])``, concurrent requests
    and one ``POST /predict`` in bf16; flash launches equal 12 x the forward
    passes run;
12. vit-train-parity: one train step of dense ViT-B/4 cut to 2 blocks, f32,
    card against CPU;
13. vit-train: dense ViT-B/4 trains through ``train.train_and_evaluate`` in
    bf16 autocast at batch 32 with dropout 0.1, then a short run with
    attention dropout 0.1, which takes the query-chunked plain path and
    must launch no flash training kernel.

14. kernel-fused: the fused short-S attention's eval forward, training
    forward (in-kernel dropout, log-sum-exp) and backward against their plain
    versions over S in 1..1024 and at the E1 shape (B*h=1536, S=197, d=64),
    f32 and bf16, at dropout 0 and 0.1; the dropout words bit for bit against
    the plain generator; the backward run twice gives the same bits;
    CUDA-event timings of the kernels (the whole-row wgmma kernels at E1's
    S), the plain versions and PyTorch's fused attention, and of the tiled
    kernels at S=577 beside the library call;
15. e1: ``cli.main(["--experiment", "traditional", ...])`` at ViT-B/16, bf16
    autocast, batch 128, attention dropout 0.1, two epochs on synthetic
    CIFAR with ``FAVIT_FUSED_MHA=1``: the one-row CSV has the reference's 19
    columns, ``parameters`` and ``flops`` equal the complexity formula's,
    the confusion matrix sums to the test count, and the fused launch counts
    equal 12 x the passes run (training passes, the mid-run memory probe's
    backward, eval passes); ms per step, images/s and peak memory, also at
    microbatch 64, 32 and 16; then one epoch with the switch off, which must
    launch nothing;
16. e1-train-parity: one f32 train step of ViT-B/16 cut to 2 blocks with
    attention dropout 0.1 and the switch on, card against CPU.

17. kernel-tileband: the tile band's forward (K6), backward (K7, which
    folds the clamped positions' mass into rows 0 and S-1 as JAX's edge
    fold does) and window-tile forward (K8) against their plain versions
    over d in 16..128, W in 3..33 and S from 2W+1 to 3137,
    f32 and bf16, and at the serving shape; the backward run twice gives the
    same bits; the composite (K6 plus the exact edge rows) equals K1 at
    W=7; CUDA-event timings of the kernels, the plain versions, PyTorch's
    fused attention on K8's window tiles with the band as a mask, and one
    band call of the composite against K1 (eval) and K1 + K2 (training);
    K6's and K8's device time under the profiler and their GB/s;
18. tile-model: MHLA-B/4 in f32 through the tile band on the card against
    the CPU (which runs the plain shift band);
19. tile-serve: MHLA-B/4 as phase 6, then MHLA-B/16 (S=197) for one burst;
    K6 launches equal 12 x the forward passes and K1 launches nothing;
20. tile-train-parity: one f32 train step at 2 blocks, card against CPU;
21. tile-train: MHLA-B/4 trains as phase 8 (the attention-dropout run takes
    the plain shift band); K6 and K7 launches equal 12 x the passes run.

22. pretrained-fixture: the seeded vit_b_16 checkpoint fixture, written by
    the port's writer into a temporary ``pretrained_weights/``;
23. e3: ``cli.main(["--experiment", "traditional_pretrained", ...])`` at
    ViT-B/16, batch 128, bf16, one epoch on synthetic CIFAR with
    ``FAVIT_FUSED_MHA=1``, run from that directory: the checkpoint loaded
    (every tensor but the 10-class head merged, the first qkv equal to the
    fixture's upcast tensor), the CSV's 24 columns in JAX's order and its
    parameter counts equal to the model's, K3/K4 launches equal 12 x the
    passes run; ms per step, images/s, peak memory;
24. e5: ``--experiment mhla_pretrained`` the same way, three times: by
    default (the dense band at S=197: no kernel launches), under the
    tile-band opt-in (K6/K7 launches equal 12 x the passes) and with
    ``--freeze_layers`` (only the head and the latent projections move, over
    the run and over one more step); every ``latent_proj`` is the identity
    at load; step time at microbatch 0, 64, 32 and 16 on both paths;
25. pretrained-mhla: ``PretrainedViTWithMHLA`` at its defaults (patch 4,
    S=3137, W=4) in f32 against the CPU, then the bf16 forward at batch 32
    (timed; K1 launches equal 12 x the passes), then one 2-block f32 train
    step against the CPU (K1's training form and K2 through the model).

26. slic: SLIC on the card on the committed goldens: at 32^2 the share of
    pixels where the connectivity-off core equals the numpy oracle
    (``tools/slic_numpy.py``), and the device pass's patch-dominant
    agreement with the golden (>= 0.72 mean, >= 0.60 min); at 224^2 the
    host pass (>= 0.97 mean, image 0 pixel-equal on >= 0.98); then ms a
    batch of 128 ImageNet-standardised 224^2 images under bf16 autocast
    with connectivity off and host, and on at batch 8 (CUDA events), with
    the host pass's copies and C++ timed apart;
27. sppp-model: ``SPPPViT`` at ViT-B/16 in f32, card against CPU: the
    dominant-superpixel ids equal, then the logits;
28. e2, e4, e6: ``cli.main`` with ``sppp``, ``sppp_pretrained`` and
    ``sppp_mhla_pretrained`` at ViT-B/16 (R=16, ``auto`` connectivity: the
    host pass), batch 128, bf16, one epoch, E4 and E6 from the fixture:
    JAX's CSV columns, the load, no kernel launched; E6 again under the
    tile-band opt-in after K6/K7 are held against their plain versions at
    (1536, 17, 64), W=7, its K6/K7 launches 12 x the passes; ms per step,
    images/s, peak memory and SLIC's share of the step
    (``utils/step_profile.profile``);
29. pretrained-sppp-mhla: K1 against its plain version at (32, 12, 64,
    17), W=4, then ``PretrainedSPPPViTWithMHLA`` at its defaults, bf16,
    batch 32, against the f32 CPU model, by default (the dense band, no
    kernel) and under ``FAVIT_MHLA_IMPL=roll`` (K1 12 x the passes), timed.

30. e7-e8: ``cli.main`` with ``cross_attention`` and
    ``multihead_cross_attention`` at ViT-B/16, batch 128, bf16, one epoch
    of each of 4A-4D and 5A-5D (C and D from the fixture): the eight CSVs
    under JAX's names and columns, the pretrained merge, no kernel
    launched; ms a step, peak memory and SLIC's share of the SPPP rows (host
    clock, a device sync around SLIC; these last phases use no profiler);
31. preempt: E1 at ViT-B/16, batch 128, ``FAVIT_FUSED_MHA=1``,
    ``--checkpoint_dir``, in a child process sent SIGTERM after its
    ``Epoch 1/`` line: exit code 143, the ``Preempted`` line, a committed
    checkpoint, no CSV; then the command again in this process to one
    epoch past the checkpoint: ``Resumed from checkpoint epoch``, the CSV,
    K3/K4 12 x the passes;
32. serve-checkpoint: ``serve.setup(["--checkpoint_dir", ...])`` on that
    directory in f32 against the resumed run's model; the time to load;
33. checkpoint: the MHLA-B/4 ``TrainState`` at batch 32 after one bf16 step
    through K1 and K2, saved asynchronously and restored into a fresh
    state bit for bit, one more step from each bit-equal; the training
    thread's hold, the on-device snapshot, the background pull and write,
    the bytes and the extra peak memory.

Every launch count is set to 0 just before its path is driven and read just
after. The line before the last is a JSON summary of the twelve kernels, each
with its time, its plain version's, the least time the card could take
(``bound_ms``, from this run's shapes) and the library call's where PyTorch
has one; the last line is ``{"ok": true, "device": {...}}``. Run from the
repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import statistics
import subprocess
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from focused_attention_vit_tpu_torch import serve, train
from focused_attention_vit_tpu_torch.data.datasets import load_dataset
from focused_attention_vit_tpu_torch.data.pipeline import prepare_eval_batch
from focused_attention_vit_tpu_torch.models import (
    PretrainedSPPPViTWithMHLA,
    PretrainedViTWithMHLA,
    SPPPViT,
    SPPPViTMHLA,
    VisionTransformer,
    VisionTransformerMHLA,
)
from focused_attention_vit_tpu_torch.ops import flash_attention as flash
from focused_attention_vit_tpu_torch.ops import mha_kernel as fused
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile
from focused_attention_vit_tpu_torch.ops import native_connectivity
from focused_attention_vit_tpu_torch.ops import philox
from focused_attention_vit_tpu_torch.ops import segment_pool
from focused_attention_vit_tpu_torch.ops import slic
from focused_attention_vit_tpu_torch.ops import window
from focused_attention_vit_tpu_torch.utils import kernel_build

REPO = Path(__file__).resolve().parent

DEPTH = 12
F32_TOL = 1e-5
BF16_ULPS = 2
# bf16 ulps are counted at max(|plain|, 2^-10): below that the f32 results
# of the two sides (which differ by ~1e-6 in summation order) would be
# compared at a spacing finer than their own agreement.
BF16_ULP_FLOOR = 2.0 ** -10
SERVE_SHAPE = (32, 12, 64, 3137)  # B, h, d, S of the band at MHLA-B/4 b32
SERVE_W = 7
# The band of the train phase's main run (batch 32, no microbatch: measured
# 46 GB peak on the card, PERF.md) is the serving shape.
TRAIN_SHAPE = SERVE_SHAPE
TRAIN_BATCH = 32
TRAIN_DROPOUT = 0.1
# f32 backward: sums of up to W^2 terms and the softmax backward, in other
# orders than the plain version's (measured <= 2.3e-6, PERF.md).
F32_BWD_TOL = 1e-4
# train-parity, f32 with TF32 off on both sides: the loss within 1e-4 abs;
# each gradient leaf within 1e-3 of its largest entry plus 1e-6 abs (reduc-
# tions over 6274 tokens and 768 channels run in other orders; the abs term
# covers leaves that are zero by analysis, such as the qkv bias's K rows).
PARITY_LOSS_TOL = 1e-4
PARITY_GRAD_REL = 1e-3
PARITY_GRAD_ABS = 1e-6
LIBRARIES = ("mhla_band_fwd", "mhla_band_bwd", "flash_attention_fwd",
             "flash_attention_bwd", "fused_mha_fwd", "fused_mha_bwd",
             "mhla_tile_band_fwd", "mhla_tile_band_bwd")
# B, h, S, d of the tile band at MHLA-B/4 b32, token-major.
TILE_SHAPE = (32, 12, 3137, 64)
# B*h, S, d of E5's tile band (ViT-B/16, batch 128, under the opt-in): its
# rows spread over K6's and K7's persistent grids so that blocks start
# mid-row and on the short last step, which the small grid never does.
E5_TILE_SHAPE = (128 * 12, 197, 64)
# PretrainedViTWithMHLA's default window: K1 and K2 at an even W.
PMHLA_W = 4
FLASH_SHAPE = (32, 12, 3137, 64)  # B, h, S, d of the flash op at ViT-B/4 b32
# B, h, S, d of the fused short-S attention at ViT-B/16, batch 128.
FUSED_SHAPE = (128, 12, 197, 64)
# A row longer than the whole-row kernels take (S = 577 is ViT-B/16 at 384
# pixels), B*h = 384: the tiled kernels' shape.
FUSED_TILED_SHAPE = (32, 12, 577, 64)
# The bf16 flash kernels round the softmax weights (and ds in the backward)
# to bf16 for the tensor cores where the plain versions keep f32: a sum of S
# independent roundings of relative size 2^-9, far below one ulp of a typical
# entry. So the bound is BF16_ULPS ulps counted at max(|plain|, a quarter of
# the tensor's largest |plain|) (entries far below the tensor's scale carry
# the rounding noise of the large terms that cancelled in them), and the
# error's rms within 2^-8 of the plain result's rms.
FLASH_ULP_FLOOR_SHARE = 0.25
FLASH_RMS_REL = 2.0 ** -8
# The fused short-S kernels are held by the same rule, BF16_ULPS included,
# at the training shape and over the grid. The grid is 168 tensors of short
# sequences, where one weight can be a large share of a sum and its bf16
# rounding is not averaged away: the one (S, d) case listed here, whose
# worst entry lies in that tail (dv at rate 0: 2.25 ulps; every other
# reading of the grid is at most 1.98), gets FUSED_LOOSE_ULPS instead, and
# the phase prints its readings. The rms bound, which a fault would break
# first, is the flash kernels' everywhere.
FUSED_LOOSE_ULPS = 3
FUSED_LOOSE_CASES = frozenset({(256, 16)})
# The tile band's bf16 kernels and plain versions both round the weights
# (and ds) to bf16, as JAX does, so an f32 difference of 1e-7 in a logit can
# round one weight the other way on one side. The band sums only 2*hw + 1
# terms and one weight can be near 1, so that moves an entry by a bf16 ulp of
# the weight (2^-8) times an input of up to about 4.5 here: up to 4.5 ulps of
# a quarter of the tensor's largest entry, plus 1 for the final rounding.
# So the flash rule with TILE_BF16_ULPS; its rms bound, which a fault breaks
# first, is unchanged (measured at most 2.3e-4 of the plain rms, against
# 2^-8).
TILE_BF16_ULPS = 6
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory and
# dense bf16 tensor-core rate. bound_ms is computed against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor,
              floor: float = BF16_ULP_FLOOR) -> float:
    ref = ref.float()
    mag = ref.abs().clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # 8-bit significand
    return float(((got.float() - ref).abs() / ulp).max())


def cuda_median_ms(fn, repeats: int = 30, warmup: int = 3,
                   batch: int = 1) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``batch`` calls,
    divided by ``batch``. A batch of back-to-back calls keeps the host's
    launch work (tensor maps, ctypes, autograd) off the device's clock
    where a call takes about as long on the host as on the card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def least_time(nbytes: float, flops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the bf16
    tensor-core peak, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on an NVIDIA Hopper GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 "
                         f"(Hopper), got {cap}")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log("device", f"{name}, capability {cap}, {torch.cuda.device_count()} "
                  f"visible; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}; nvidia-smi name, power limit:")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    # The host connectivity library (g++) builds beside the eight nvcc
    # processes.
    with ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(kernel_build.build_native, "connectivity")
        libs = kernel_build.build_many(LIBRARIES)
        libs.append(native.result())
    for name in LIBRARIES:
        kernel_build.load(name)
    native_connectivity.get_lib()
    log("build", f"{', '.join(str(p.relative_to(REPO)) for p in libs)} "
                 f"ready in {time.perf_counter() - t0:.1f} s")
    libs.pop()  # ptxas reports below are the CUDA libraries'.
    for lib in libs:
        text = (lib.parent / "build.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log("build", f"ptxas {lib.name}: {len(regs)} kernels, registers "
                     f"{min(regs)}-{max(regs)}, spill stores up to "
                     f"{max(spills, default=0)} bytes")
        # The bf16 flash kernels at d = 64, the main path's, and the fused
        # whole-row kernels at E1's d = 64, S = 197: registers, spills and
        # the dynamic shared memory they are launched with.
        if lib.name.startswith("libflash_attention_"):
            _flash_ptxas(lib, text)
        if lib.name.startswith("libfused_mha_"):
            _fused_ptxas(lib, text)
        if lib.name == "libmhla_band_fwd.so":
            _band_fwd_ptxas(lib, text)
        if lib.name == "libmhla_band_bwd.so":
            _band_bwd_ptxas(lib, text)
        if lib.name in ("libmhla_tile_band_fwd.so",
                        "libmhla_tile_band_bwd.so"):
            _tile_ptxas(lib, text)


def _flash_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's report of each d = 64 bf16 flash kernel in ``lib``; raise
    if one spills or is missing."""
    lib_name = lib.name[3:-3]
    so = kernel_build.load(lib_name)
    if lib_name == "flash_attention_fwd":
        smem = {"flash_fwd_wgmma": so.flash_attention_fwd_smem(64)}
    else:
        smem = {"flash_bwd_dkv_wgmma": so.flash_attention_bwd_smem(64, 0),
                "flash_bwd_dq_wgmma": so.flash_attention_bwd_smem(64, 1)}
    found = set()
    for m in re.finditer(
            r"Function properties for \S*?\d(flash_(?:fwd|bwd_dkv|bwd_dq)"
            r"_wgmma)ILi64E(\w*?)Ev\S*\n\s*\d+ bytes stack frame, (\d+) "
            r"bytes spill stores.*\n.*?Used (\d+) registers"
            r"(?:.*?(\d+) bytes smem)?", text):
        kernel, spills = m.group(1), int(m.group(3))
        lse = ", lse" if "Lb1" in m.group(2) else ""
        found.add(kernel)
        log("build", f"ptxas {kernel}<64{lse}>: {m.group(4)} registers, "
                     f"{spills} bytes of spill stores, {m.group(5) or 0} "
                     f"bytes of static and {smem[kernel]} of dynamic shared "
                     f"memory")
        if spills:
            raise AssertionError(f"{kernel}<64{lse}> spills {spills} bytes")
    if found != set(smem):
        raise AssertionError(f"ptxas report of {sorted(set(smem) - found)} "
                             f"not found in {lib.parent / 'build.log'}")


def _fused_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's report of the whole-row bf16 fused kernel in ``lib`` at
    E1's shape (d = 64, S = 197: 13 chunks of 16 keys); raise if it spills
    or is missing."""
    lib_name = lib.name[3:-3]
    so = kernel_build.load(lib_name)
    _, _, s, d = FUSED_SHAPE
    kernel = lib_name.replace("_mha_", "_") + "_row_wgmma"
    smem = getattr(so, f"{lib_name}_smem")(d, s)
    m = re.search(
        rf"Function properties for \S*?\d{kernel}ILi{d}ELi{-(-s // 16)}E"
        r"\S*\n\s*\d+ bytes stack frame, (\d+) bytes spill stores.*\n"
        r".*?Used (\d+) registers(?:.*?(\d+) bytes smem)?", text)
    if m is None or smem <= 0:
        raise AssertionError(f"ptxas report of {kernel}<{d}, "
                             f"{-(-s // 16)}> not found in "
                             f"{lib.parent / 'build.log'}")
    spills = int(m.group(1))
    log("build", f"ptxas {kernel}<{d}, {-(-s // 16)}>: {m.group(2)} "
                 f"registers, {spills} bytes of spill stores, "
                 f"{m.group(3) or 0} bytes of static and {smem} of dynamic "
                 f"shared memory")
    if spills:
        raise AssertionError(f"{kernel}<{d}> spills {spills} bytes")


def _band_fwd_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers and spills and the dynamic shared memory of
    every K1 instantiation (per dtype, head dim, slot cap, saved weights and
    dropout); raise if one is missing or one of the main path's (bf16,
    d=64, slot cap 8, eval or training form) spills."""
    so = kernel_build.load("mhla_band_fwd")
    found = {}
    for m in re.finditer(
            r"Function properties for \S*?band_fwd_kernelI(13__nv_bfloat16|f)"
            r"Li(\d+)ELi(\d+)ELb(\d)ELb(\d)E\S*\n\s*\d+ bytes stack frame, "
            r"(\d+) bytes spill stores.*\n.*?Used (\d+) registers", text):
        dtype, d, cap, save, drop, spills, regs = m.groups()
        bf16 = dtype != "f"
        smem = so.mhla_band_fwd_smem(int(bf16), int(d), int(cap))
        key = ("bf16" if bf16 else "f32", int(d), int(cap), save + drop)
        found[key] = (int(regs), int(spills), smem)
        if bf16 and d == "64" and cap == "8" and int(spills):
            raise AssertionError(f"K1 {key} spills {spills} bytes")
    if len(found) != 64:
        raise AssertionError(f"ptxas reports {len(found)} of K1's 64 "
                             f"instantiations in {lib.parent / 'build.log'}")
    for dt in ("bf16", "f32"):
        log("build", f"ptxas K1 {dt} (d/slot cap/save,dropout: registers, "
                     f"spill bytes, dynamic smem): " + "; ".join(
                         f"{d}/{cap}/{form}: {r}, {sp}, {sm}"
                         for (t_, d, cap, form), (r, sp, sm)
                         in sorted(found.items()) if t_ == dt))


def _band_bwd_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers and spills and the dynamic shared memory of
    every K2 instantiation (pass 1 and 2, per dtype, head dim, slot cap and
    dropout flag); raise if one is missing or the main path's (bf16, d=64,
    slot cap 8) spills."""
    so = kernel_build.load("mhla_band_bwd")
    found = {}
    for m in re.finditer(
            r"Function properties for \S*?band_bwd_(query|key)_kernelI"
            r"(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E(?:Lb(\d)E)?E\S*\n\s*\d+ "
            r"bytes stack frame, (\d+) bytes spill stores.*\n.*?Used (\d+) "
            r"registers", text):
        kind, dtype, d, cap, drop, spills, regs = m.groups()
        bf16 = dtype != "f"
        smem = so.mhla_band_bwd_smem(1 if kind == "query" else 2, int(bf16),
                                     int(d), int(cap))
        key = ("bf16" if bf16 else "f32", kind, int(d), int(cap), drop)
        found[key] = (int(regs), int(spills), smem)
        if bf16 and d == "64" and cap == "8" and int(spills):
            raise AssertionError(f"K2 {key} spills {spills} bytes")
    if len(found) != 48:
        raise AssertionError(f"ptxas reports {len(found)} of K2's 48 "
                             f"instantiations in {lib.parent / 'build.log'}")
    for dt in ("bf16", "f32"):
        for kind in ("query", "key"):
            log("build", f"ptxas K2 {dt} pass {1 if kind == 'query' else 2}"
                         f" (d/slot cap[/dropout]: registers, spill bytes, "
                         f"dynamic smem): " + "; ".join(
                             f"{d}/{cap}{'' if drop is None else '/' + drop}"
                             f": {r}, {sp}, {sm}"
                             for (t_, k_, d, cap, drop), (r, sp, sm)
                             in sorted(found.items(),
                                       key=lambda kv: (kv[0][2], kv[0][3],
                                                       kv[0][4] or ""))
                             if t_ == dt and k_ == kind))


def _tile_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers, spills and shared memory of every
    instantiation of a tile-band source, K6/K8 (bf16 and f32, each head dim,
    rows and tiles) or K7 (bf16 and f32, each head dim); raise if one is
    missing or spills."""
    fwd = lib.name == "libmhla_tile_band_fwd.so"
    kind, what = ("fwd", "K6/K8") if fwd else ("bwd", "K7")
    smem = tile._kernel(f"mhla_tile_band_{kind}",
                        f"mhla_tile_band_{kind}_smem")
    found = {}
    for m in re.finditer(
            rf"Function properties for \S*?tile_band_{kind}_(mma|f32)"
            r"ILi(\d+)E(?:Lb(\d)E)?\S*\n\s*\d+ bytes stack frame, (\d+) "
            r"bytes spill stores.*\n.*?Used (\d+) registers"
            r"(?:.*?(\d+) bytes smem)?", text):
        k, d, tiles, spills, regs, static = m.groups()
        dt = "bf16" if k == "mma" else "f32"
        key = (dt, int(d), "K8" if tiles == "1" else "K6") if fwd else (
            dt, int(d))
        found[key] = (int(regs), int(spills), int(static or 0),
                      smem(int(d)) if dt == "bf16" else 0)
    expected = 2 * len(tile.HEAD_DIMS) * (2 if fwd else 1)
    if len(found) != expected:
        raise AssertionError(f"ptxas reports {len(found)} of {what}'s "
                             f"{expected} instantiations in "
                             f"{lib.parent / 'build.log'}")
    log("build", f"ptxas {what} (dtype d{' kernel' if fwd else ''}: "
                 f"registers, spill bytes, static and dynamic smem): "
        + "; ".join(f"{' '.join(map(str, key))}: {r}, {sp}, {st}, {dy}"
                    for key, (r, sp, st, dy) in sorted(found.items())))
    spilled = {key: v[1] for key, v in found.items() if v[1]}
    if spilled:
        raise AssertionError(f"{what} spills (bytes): {spilled}")


class NoDeviceTime(AssertionError):
    """``torch.profiler`` recorded no device time for a call."""


def profile_device_ms(fn, calls: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by kernel name
    (template arguments dropped), from ``torch.profiler`` over ``calls``
    calls after one warm-up: the mean of the launches the profiler recorded
    times the launches a call. Late in this script the profiler has
    recorded only about 13 of 20 launches of a kernel on an H100, so the sum
    is not divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+)[<(]", e.key)
            name = m.group(1) if m else e.key
            total[name] = total.get(name, 0.0) + e.self_device_time_total
            count[name] = count.get(name, 0) + e.count
    if not total:
        raise NoDeviceTime("the profiler recorded no device time")
    return {name: total[name] / 1e3 / count[name]
            * max(1, round(count[name] / calls)) for name in total}


def phase_kernel() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(3)]

    def compare(shape, w, dtype):
        q, k, v = inputs(shape, dtype)
        got = band.roll_banded_attention(q, k, v, w)
        ref = band.plain_banded_attention(q, k, v, w)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        if dtype == torch.float32:
            ok, what = err <= F32_TOL, f"max abs err {err:.3g}"
        else:
            ulps = bf16_ulps(got, ref)
            ok, what = ulps <= BF16_ULPS, (f"max abs err {err:.3g}, "
                                           f"{ulps:.2f} ulps")
        dt = "f32" if dtype == torch.float32 else "bf16"
        log("kernel", f"B,h,d,S={shape} W={w} {dt}: {what}")
        if not ok:
            raise AssertionError(f"band kernel disagrees with the plain "
                                 f"version at {shape} W={w} {dt}: {what}")
        return err, (q, k, v)

    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64):
            for w in (1, 3, 4, 5, 7):  # 4: PretrainedViTWithMHLA's
                # S just below and past the kernel's 512-query tile; 1001
                # leaves every channel row at another offset within 16
                # bytes.
                for s in (2 * w + 1, 197, 511, 513, 577, 1000, 1001, 3137):
                    compare((2, 3, d, s), w, dtype)

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        # PretrainedViTWithMHLA's serving forward: the same shape at W = 4.
        err_w4 = compare(SERVE_SHAPE, PMHLA_W, dtype)[0]
        torch.cuda.empty_cache()
        err, (q, k, v) = compare(SERVE_SHAPE, SERVE_W, dtype)
        ms = cuda_median_ms(lambda: band.roll_banded_attention(q, k, v,
                                                               SERVE_W))
        plain_ms = cuda_median_ms(
            lambda: band.plain_banded_attention(q, k, v, SERVE_W))
        device = profile_device_ms(
            lambda: band.roll_banded_attention(q, k, v, SERVE_W))
        nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; out written
        dt = "f32" if dtype == torch.float32 else "bf16"
        log("kernel", f"serving shape {SERVE_SHAPE} W={SERVE_W} {dt}: kernel "
                      f"{ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s of q,k,v,out"
                      f"), plain {plain_ms:.4f} ms (median of 30, CUDA events)"
                      f"; device ms a call " + ", ".join(
                          f"{n} {t:.4f}" for n, t in device.items())
                      + " (profiler, 20 calls)")
        b, h, d, n = SERVE_SHAPE
        # Two products of W*d multiply-adds a query. The error is the larger
        # of the two main-path windows'; the times are W = 7's.
        result[dt] = dict(max_abs_err=max(err, err_w4), ms=ms,
                          plain_ms=plain_ms,
                          library_ms=None,
                          **least_time(nbytes, 4 * b * h * n * SERVE_W * d))
    return result


def _worst(got: torch.Tensor, ref: torch.Tensor, dtype, f32_tol: float):
    """(max abs err, ok, description) of a kernel result against its plain
    version: f32 within ``f32_tol`` abs, bf16 within BF16_ULPS ulps."""
    err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        return err, err <= f32_tol, f"{err:.3g}"
    ulps = bf16_ulps(got, ref)
    return err, ulps <= BF16_ULPS, f"{err:.3g} ({ulps:.2f} ulps)"


def _compare_train(q, k, v, g, w, rate, seed):
    """The training forward and the backward kernel against their plain
    versions on the same inputs; returns {name: (err, ok, text)}."""
    dtype = q.dtype
    out, wts = band.band_forward_train(q, k, v, w, rate, seed)
    ref_out, ref_wts = band.plain_band_forward_train(q, k, v, w, rate, seed)
    grads = band.band_backward(q, k, v, g, wts, w, rate, seed)
    ref_grads = band.plain_band_backward(q, k, v, g, wts, w, rate, seed)
    torch.cuda.synchronize()
    res = {"out": _worst(out, ref_out, dtype, F32_TOL),
           # Saved weights are f32 on both sides: softmax of f32 logits.
           "wts": _worst(wts, ref_wts, torch.float32, F32_TOL)}
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        res[name] = _worst(a, b, dtype, F32_BWD_TOL)
    return res


def phase_kernel_train() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(4)]

    def check(where, res):
        bad = [f"{n} {t}" for n, (_, ok, t) in res.items() if not ok]
        if bad:
            raise AssertionError(f"training band kernels disagree with the "
                                 f"plain versions at {where}: {bad}")

    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for d in (16, 64):
            worst = {}
            for w in (1, 3, 4, 5, 7):
                for s in (2 * w + 1, 197, 1000, 1001, 3137):
                    q, k, v, g = inputs((2, 3, d, s), dtype)
                    for rate, seed in ((0.0, None), (TRAIN_DROPOUT, 1234567)):
                        res = _compare_train(q, k, v, g, w, rate, seed)
                        check(f"{(2, 3, d, s)} W={w} {dt} rate {rate}", res)
                        for n, (e, _, _) in res.items():
                            worst[n] = max(worst.get(n, 0.0), e)
            log("kernel-train", f"{dt} d={d}, W in 1,3,4,5,7, S in 2W+1,197,"
                                f"1000,1001,3137, rate 0 and {TRAIN_DROPOUT}: "
                                f"max abs err " + ", ".join(
                                    f"{n} {e:.3g}" for n, e in worst.items()))

    # The mask, bit for bit, at the training shape.
    b, h, d, s = TRAIN_SHAPE
    seed = 2**40 + 77
    bits = band.keep_bits(b * h, SERVE_W, s, seed, "cuda").cpu()
    if not torch.equal(bits, band.keep_bits(b * h, SERVE_W, s, seed, "cpu")):
        raise AssertionError("the kernels' dropout bits differ from the "
                             "plain generator's")
    log("kernel-train", f"dropout words at B*h={b * h}, W={SERVE_W}, S={s}: "
                        f"identical to the plain generator's "
                        f"({bits.numel()} words)")

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, g = inputs(TRAIN_SHAPE, dtype)
        # PretrainedViTWithMHLA's train step: W = 4, no dropout.
        res_w4 = _compare_train(q, k, v, g, PMHLA_W, 0.0, None)
        check(f"the training shape {TRAIN_SHAPE} W={PMHLA_W} {dt} rate 0",
              res_w4)
        log("kernel-train", f"training shape {TRAIN_SHAPE} W={PMHLA_W} {dt} "
                            f"rate 0: max abs err " + ", ".join(
                                f"{n} {t}" for n, (_, _, t) in res_w4.items()))
        res = _compare_train(q, k, v, g, SERVE_W, TRAIN_DROPOUT, seed)
        check(f"the training shape {TRAIN_SHAPE} {dt}", res)
        out, wts = band.band_forward_train(q, k, v, SERVE_W, TRAIN_DROPOUT,
                                           seed)
        times = {
            "fwd_train": cuda_median_ms(lambda: band.band_forward_train(
                q, k, v, SERVE_W, TRAIN_DROPOUT, seed)),
            "fwd_train_plain": cuda_median_ms(
                lambda: band.plain_band_forward_train(
                    q, k, v, SERVE_W, TRAIN_DROPOUT, seed)),
            "bwd": cuda_median_ms(lambda: band.band_backward(
                q, k, v, g, wts, SERVE_W, TRAIN_DROPOUT, seed)),
            "bwd_plain": cuda_median_ms(lambda: band.plain_band_backward(
                q, k, v, g, wts, SERVE_W, TRAIN_DROPOUT, seed)),
        }
        log("kernel-train", f"training shape {TRAIN_SHAPE} W={SERVE_W} {dt} "
                            f"rate {TRAIN_DROPOUT}: max abs err " + ", ".join(
                                f"{n} {t}" for n, (_, _, t) in res.items()))
        fwd_bytes = 4 * q.numel() * q.element_size() + wts.numel() * 4
        fwd_device = profile_device_ms(lambda: band.band_forward_train(
            q, k, v, SERVE_W, TRAIN_DROPOUT, seed))
        log("kernel-train", f"training shape {dt}: training forward "
                            f"{times['fwd_train']:.4f} ms (plain "
                            f"{times['fwd_train_plain']:.4f}), backward "
                            f"{times['bwd']:.4f} ms (plain "
                            f"{times['bwd_plain']:.4f}); median of 30, CUDA "
                            f"events")
        log("kernel-train", f"training shape {dt}: training forward "
                            f"{fwd_bytes / times['fwd_train'] / 1e6:.0f} "
                            f"GB/s of q,k,v,out,wts; device ms a call "
                            + ", ".join(f"{n} {t:.4f}"
                                        for n, t in fwd_device.items())
                            + " (profiler, 20 calls)")
        # The backward twice on the same inputs: the same bits (no atomics).
        again = band.band_backward(q, k, v, g, wts, SERVE_W, TRAIN_DROPOUT,
                                   seed)
        first = band.band_backward(q, k, v, g, wts, SERVE_W, TRAIN_DROPOUT,
                                   seed)
        if not all(torch.equal(a, b) for a, b in zip(again, first)):
            raise AssertionError(f"two {dt} band backward runs differ")
        passes = profile_device_ms(lambda: band.band_backward(
            q, k, v, g, wts, SERVE_W, TRAIN_DROPOUT, seed))
        log("kernel-train", f"training shape {dt}: two backward runs "
                            f"bit-identical; backward {times['bwd']:.4f} ms "
                            f"(CUDA events) = device ms a call " + ", ".join(
                                f"{n} {ms:.4f}" for n, ms in passes.items())
                            + f" (profiler, 20 calls; sum "
                            f"{sum(passes.values()):.4f})")
        # Bytes the functions must move: q, k, v in and out back, plus the
        # f32 weights; the backward reads q, k, v, g and the weights and
        # writes dq, dk, dv (its scratch is the kernel's own). Products: 2
        # in the forward, 5 in the backward, of W*d multiply-adds a query.
        one = q.numel() * q.element_size()
        pairs = b * h * s * SERVE_W * d
        # Errors: the larger of the two main-path windows'; times W = 7's.
        res = {n: max(res[n], res_w4[n]) for n in res}
        result[dt] = dict(
            fwd_train=dict(max_abs_err=max(res["out"][0], res["wts"][0]),
                           ms=times["fwd_train"],
                           plain_ms=times["fwd_train_plain"],
                           library_ms=None,
                           **least_time(fwd_bytes, 4 * pairs)),
            bwd=dict(max_abs_err=max(res[n][0] for n in ("dq", "dk", "dv")),
                     ms=times["bwd"], plain_ms=times["bwd_plain"],
                     library_ms=None,
                     **least_time(7 * one + wts.numel() * 4, 10 * pairs)),
        )
    return result


def _tile_compare(q, k, v, g, w):
    """K6, K7 (which folds the clamped positions' mass into rows 0 and S-1)
    and K8 (through ``banded_attention_v4b``) against their plain versions
    on ``[B*h, S, d]`` inputs. {name: (err, ok, text)}."""
    dtype = q.dtype
    bh, s, d = q.shape
    out = tile.tile_band_forward(q, k, v, w)
    ref = tile.plain_tile_band_forward(q, k, v, w)
    out_b = tile.banded_attention_v4b(
        *(x.view(1, bh, s, d) for x in (q, k, v)), w).view(bh, s, d)
    grads = tile.tile_band_backward(q, k, v, g, w)
    ref_grads = tile.plain_bwd_rule(q, k, v, g, w)
    torch.cuda.synchronize()
    res = {"fwd": _flash_check(out, ref, dtype, F32_TOL, TILE_BF16_ULPS),
           "fwd_b": _flash_check(out_b, ref, dtype, F32_TOL, TILE_BF16_ULPS)}
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        res[name] = _flash_check(a, b, dtype, F32_BWD_TOL, TILE_BF16_ULPS)
    return res


def phase_kernel_tileband() -> dict:
    """K6, K7 and K8 against their plain versions over a grid and at the
    serving shape; the tile-band composite against K1 there; CUDA-event
    timings of the kernels, the plain versions, the library call on the
    window tiles, and the composite against K1/K2 per band call."""
    import torch.nn.functional as F  # the library call, timed as a yardstick

    phase = "kernel-tileband"
    gen = torch.Generator(device="cuda").manual_seed(9)

    def inputs(shape, dtype, n=4):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(n)]

    def check(where, res):
        bad = [f"{n} {t}" for n, (_, ok, t) in res.items() if not ok]
        if bad:
            raise AssertionError(f"tile band kernels disagree with the plain "
                                 f"versions at {where}: {bad}")

    tile.reset_launch_count()
    windows = (3, 4, 7, 15, 33)
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for d in tile.HEAD_DIMS:
            worst, texts = {}, {}
            for w in windows:
                for s in (2 * w + 1, 197, 1000, 3137):
                    res = _tile_compare(*inputs((6, s, d), dtype), w)
                    check(f"(6, {s}, {d}) W={w} {dt}", res)
                    for n, (e, _, text) in res.items():
                        if e >= worst.get(n, -1.0):
                            worst[n], texts[n] = e, text
            log(phase, f"{dt} d={d}, W in {windows}, S in 2W+1,197,1000,3137: "
                       f"largest error " + ", ".join(
                           f"{n} {t}" for n, t in texts.items()))
    k8_launches = tile.launch_count("fwd_b")

    e5 = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        e5[dt] = _tile_compare(*inputs(E5_TILE_SHAPE, dtype), SERVE_W)
        check(f"E5's shape {E5_TILE_SHAPE} {dt}", e5[dt])
        log(phase, f"E5's shape {E5_TILE_SHAPE} W={SERVE_W} {dt}: max abs "
                   f"err " + ", ".join(
                       f"{n} {t}" for n, (_, _, t) in e5[dt].items()))

    b, h, s, d = TILE_SHAPE
    w = SERVE_W
    hw = w // 2
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, g = inputs((b * h, s, d), dtype)
        res = _tile_compare(q, k, v, g, w)
        check(f"the serving shape {TILE_SHAPE} {dt}", res)
        log(phase, f"serving shape {TILE_SHAPE} W={w} {dt}: max abs err "
                   + ", ".join(f"{n} {t}" for n, (_, _, t) in res.items()))
        first = tile.tile_band_backward(q, k, v, g, w)
        second = tile.tile_band_backward(q, k, v, g, w)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"two runs of the {dt} tile band backward "
                                 f"differ")
        del first, second
        # The composite (K6 plus the exact edge rows) is the reference
        # window at odd W: K1's result on the same inputs.
        q4, k4, v4, g4 = (x.view(b, h, s, d) for x in (q, k, v, g))
        with _environ(TILE_ENV), torch.no_grad():
            comp = window.windowed_latent_attention(q4, k4, v4, w)
        qs, ks, vs = (x.transpose(2, 3).contiguous() for x in (q4, k4, v4))
        with torch.no_grad():
            k1 = band.roll_banded_attention(qs, ks, vs, w).transpose(2, 3)
        _, ok, text = _flash_check(comp, k1, dtype, F32_TOL, TILE_BF16_ULPS)
        log(phase, f"serving shape {dt}: composite (K6 + edge rows) against "
                   f"K1, max abs err {text}")
        if not ok:
            raise AssertionError(f"the {dt} tile band composite disagrees "
                                 f"with K1")
        del comp, k1
        if dtype == torch.float32:
            del q, k, v, g, q4, k4, v4, g4, qs, ks, vs
            torch.cuda.empty_cache()
            continue

        # K8's inputs: the window tiles, built once outside the timed call.
        halo = tile._halo(tile.DEFAULT_BLOCK, hw)
        t = max(2 * halo, min(tile.DEFAULT_BLOCK, -(-s // 8) * 8))
        sp = -(-s // t) * t
        build_ms = cuda_median_ms(lambda: (
            tile._window_tiles(k, t, halo, sp),
            tile._window_tiles(v, t, halo, sp),
            tile._pad_seq(q, 0, sp - s).reshape(b * h, sp // t, t, d)
            .contiguous()), 10)
        ke, ve = (tile._window_tiles(x, t, halo, sp) for x in (k, v))
        qt = tile._pad_seq(q, 0, sp - s).reshape(b * h, sp // t, t, d)
        qt = qt.contiguous()
        mask = tile._band_mask(t, t + 2 * halo, halo, hw, "cuda")
        with torch.no_grad():
            lib = F.scaled_dot_product_attention(qt, ke, ve, attn_mask=mask)
            k8 = tile.window_tile_band(qt, ke, ve, w)
        lib_err = float((lib.float() - k8.float()).abs().max())
        del lib, k8
        with torch.no_grad():
            times = {
                "fwd": cuda_median_ms(
                    lambda: tile.tile_band_forward(q, k, v, w)),
                "bwd": cuda_median_ms(
                    lambda: tile.tile_band_backward(q, k, v, g, w)),
                # The plain edge fold that ran after K7 before it folded
                # in-kernel, for the record.
                "fold": cuda_median_ms(lambda: tile._edge_fold(
                    q, k, v, g, k, v, w)),
                "fwd_b": cuda_median_ms(
                    lambda: tile.window_tile_band(qt, ke, ve, w)),
                "fwd_plain": cuda_median_ms(
                    lambda: tile.plain_tile_band_forward(q, k, v, w), 5, 1),
                "bwd_plain": cuda_median_ms(
                    lambda: tile.plain_bwd_rule(q, k, v, g, w), 5, 1),
                "fwd_b_plain": cuda_median_ms(
                    lambda: tile.plain_window_tile_band(qt, ke, ve, w), 5, 1),
                "library": cuda_median_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, ke, ve, attn_mask=mask)),
            }
            # One band call of the model, eval: the composite on [B, h, S, d]
            # against K1 on its S-minor layout.
            with _environ(TILE_ENV):
                times["composite"] = cuda_median_ms(
                    lambda: window.windowed_latent_attention(q4, k4, v4, w))
            times["k1"] = cuda_median_ms(
                lambda: band.roll_banded_attention(qs, ks, vs, w))

        # Training: forward and backward of one band call.
        def train_call(fn, args, cot):
            def run():
                xs = [x.detach().requires_grad_(True) for x in args]
                torch.autograd.grad(fn(*xs), xs, cot)
            return run

        with _environ(TILE_ENV):
            times["composite_train"] = cuda_median_ms(train_call(
                lambda *a: window.windowed_latent_attention(*a, w),
                (q4, k4, v4), g4))
        times["k1k2_train"] = cuda_median_ms(train_call(
            lambda *a: band.roll_banded_attention(*a, w), (qs, ks, vs),
            g4.transpose(2, 3).contiguous()))
        log(phase, f"serving shape bf16, kernel / plain, ms: K6 "
                   f"{times['fwd']:.4f} / {times['fwd_plain']:.4f}; K7, "
                   f"edge fold included, {times['bwd']:.4f} / "
                   f"{times['bwd_plain']:.4f} (the plain edge fold that ran "
                   f"after the earlier K7: {times['fold']:.4f}); K8 "
                   f"{times['fwd_b']:.4f} / {times['fwd_b_plain']:.4f} on "
                   f"prebuilt tiles of {t} rows (building them "
                   f"{build_ms:.4f}); PyTorch's fused attention on the tiles "
                   f"with the band as a boolean mask {times['library']:.4f} "
                   f"(max |K8 - it| {lib_err:.3g}); CUDA-event medians of "
                   f"30, plain of 5; two backward runs bit-identical")
        log(phase, f"one band call at the serving shape, bf16, ms: eval "
                   f"composite (K6 + edge rows) {times['composite']:.4f} "
                   f"against K1 {times['k1']:.4f}; training forward + "
                   f"backward composite {times['composite_train']:.4f} "
                   f"against K1 + K2 {times['k1k2_train']:.4f}")
        # The functions' least work: K6 reads q, k, v and writes out; K7
        # reads q, k, v, g and writes dq, dk, dv; K8 reads the q tiles and
        # both window tensors and writes the output tiles. Products: 2 in
        # the forward, 5 in the backward, of 2*hw + 1 keys of d a query.
        one = q.numel() * q.element_size()
        pairs = b * h * s * (2 * hw + 1) * d
        tile_bytes = sum(x.numel() * x.element_size()
                         for x in (qt, ke, ve, qt))
        tile_pairs = qt.numel() // d * (2 * hw + 1) * d
        # K6's and K7's errors: the larger of the serving shape's and
        # E5's; the times are the serving shape's.
        res.update({n: max(res[n], e5[dt][n]) for n in ("fwd", "dq", "dk",
                                                       "dv")})
        result = dict(
            fwd=dict(max_abs_err=res["fwd"][0], ms=times["fwd"],
                     plain_ms=times["fwd_plain"],
                     library_ms=times["library"],
                     **least_time(4 * one, 4 * pairs)),
            bwd=dict(max_abs_err=max(res[n][0] for n in ("dq", "dk", "dv")),
                     ms=times["bwd"], plain_ms=times["bwd_plain"],
                     library_ms=None, **least_time(7 * one, 10 * pairs)),
            fwd_b=dict(max_abs_err=res["fwd_b"][0], ms=times["fwd_b"],
                       plain_ms=times["fwd_b_plain"],
                       library_ms=times["library"],
                       **least_time(tile_bytes, 4 * tile_pairs)),
            fwd_b_launches=k8_launches,
        )
        # K7 in batches of 10 back-to-back calls: the host's launch work
        # then runs ahead of the card instead of inside the timed span.
        k7_batched = cuda_median_ms(
            lambda: tile.tile_band_backward(q, k, v, g, w), 30, 3, 10)
        log(phase, f"bf16 bounds, ms: K6 {result['fwd']['bound_ms']:.4f}, "
                   f"K7 {result['bwd']['bound_ms']:.4f}, K8 "
                   f"{result['fwd_b']['bound_ms']:.4f} (by bytes); K6 "
                   f"{4 * one / times['fwd'] / 1e6:.0f} GB/s of q, k, v, out; "
                   f"K7 {k7_batched:.4f} ms a call in batches of 10 (CUDA "
                   f"events), {7 * one / k7_batched / 1e6:.0f} GB/s of q, k, "
                   f"v, g, dq, dk, dv")
        # Device time of K6 and K8 alone, and their rates: the profiler, or,
        # where this late in the process it records no device time, CUDA
        # events over batches of 10 calls.
        try:
            dev = {name: profile_device_ms(fn)["tile_band_fwd_mma"]
                   for name, fn in (
                       ("K6", lambda: tile.tile_band_forward(q, k, v, w)),
                       ("K8", lambda: tile.window_tile_band(qt, ke, ve, w)))}
            how = "torch.profiler, 20 calls"
        except NoDeviceTime:
            dev = {"K6": cuda_median_ms(
                       lambda: tile.tile_band_forward(q, k, v, w), 30, 3, 10),
                   "K8": cuda_median_ms(
                       lambda: tile.window_tile_band(qt, ke, ve, w), 30, 3,
                       10)}
            how = ("CUDA events, batches of 10 calls: the profiler recorded "
                   "no device time")
        log(phase, f"bf16 device time a call ({how}): K6 "
                   f"{dev['K6']:.4f} ms, {4 * one / dev['K6'] / 1e6:.0f} "
                   f"GB/s of q, k, v, out; K8 {dev['K8']:.4f} ms, "
                   f"{tile_bytes / dev['K8'] / 1e6:.0f} GB/s of the q tiles, "
                   f"window tiles and out tiles; K8 by events "
                   f"{tile_bytes / times['fwd_b'] / 1e6:.0f} GB/s")
        del q, k, v, g, q4, k4, v4, g4, qs, ks, vs, qt, ke, ve
        torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def _environ(env: dict):
    """``env`` set on top of the environment for a block, then restored."""
    with mock.patch.dict(os.environ, env):
        yield


def phase_tile_serve_b16() -> int:
    """MHLA-B/16 (S = 197) served in bf16 through the tile band: one burst
    through ``BatchingServer``; every block launches K6 once a pass and K1
    nothing."""
    phase = "tile-serve"
    rng = np.random.default_rng(11)
    cpu_model = VisionTransformerMHLA(
        img_size=224, patch_size=16, num_classes=10,
        generator=torch.Generator().manual_seed(0)).eval()
    image = _images(rng, 1)
    with torch.inference_mode():
        ref_probs = torch.softmax(cpu_model(prepare_eval_batch(
            torch.from_numpy(image), 224)), -1).numpy()
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "vit_mhla_b16.pt")
        torch.save(cpu_model.state_dict(), weights)
        args, predictor = serve.setup([
            "--model", "vit_mhla", "--patch_size", "16", "--img_size", "224",
            "--compute_dtype", "bfloat16", "--batch_size", "32",
            "--weights", weights,
        ])
    forwards = [0]
    hook = predictor.model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    TILE.reset_counts()
    burst = [np.concatenate([image, _images(rng, args.batch_size - 1)])] + [
        _images(rng, args.batch_size) for _ in range(7)]
    with serve.BatchingServer(predictor, max_delay_ms=args.max_delay_ms,
                              workers=args.workers) as srv:
        t0 = time.perf_counter()
        outs = [f.result(timeout=300) for f in [srv.submit(r) for r in burst]]
        wall = time.perf_counter() - t0
    hook.remove()
    for out in outs:
        _check_probs(out, args.batch_size)
    dp = float(np.abs(outs[0][0] - ref_probs[0]).max())
    launches = tile.launch_count()
    TILE.check_idle(phase)
    log(phase, f"MHLA-B/16 (S=197), burst of {len(burst)} x "
               f"{args.batch_size}: {len(burst) * args.batch_size / wall:.1f} "
               f"images/s (host clock, includes the first calls); bf16 "
               f"against the f32 CPU model {dp:.3g} (tol 1e-2); forward "
               f"passes {forwards[0]}, K6 launches {launches}")
    if dp > 1e-2:
        raise AssertionError("MHLA-B/16 served probabilities disagree with "
                             "the f32 reference")
    if launches != DEPTH * forwards[0] or forwards[0] == 0:
        raise AssertionError(f"K6 launches {launches} != {DEPTH} x "
                             f"{forwards[0]} forward passes")
    return launches


def _images(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)


class ModelPath:
    """One model's path through the script: its phases' labels, the model
    class, the ``--model`` flag, the op whose launches it counts (and the
    kind its training forward counts under), the environment its phases run
    in and the ops that must launch nothing on it."""

    def __init__(self, prefix, name, cls, flag, op, op_name, patch=4,
                 model_kw=None, env=None, train_fwd_kind="fwd_train",
                 idle_ops=()):
        self.prefix, self.name, self.cls = prefix, name, cls
        self.flag, self.op, self.op_name = flag, op, op_name
        self.patch, self.model_kw = patch, model_kw or {}
        self.env, self.train_fwd_kind = env or {}, train_fwd_kind
        self.idle_ops = idle_ops

    def reset_counts(self) -> None:
        for op in (self.op, *self.idle_ops):
            op.reset_launch_count()

    def expected(self, eval_passes: int, grad_passes: int,
                 depth: int = DEPTH) -> dict:
        """Launch counts by kind for forward passes of a ``depth``-block
        model without and with a backward through the op's kernels."""
        out = dict.fromkeys(self.op.LAUNCH_KINDS, 0)
        out["fwd"] += depth * eval_passes
        out[self.train_fwd_kind] += depth * grad_passes
        out["bwd"] += depth * grad_passes
        return out

    def check_idle(self, phase: str) -> None:
        busy = {op.__name__: [op.launch_count(k) for k in op.LAUNCH_KINDS]
                for op in self.idle_ops}
        if any(any(c) for c in busy.values()):
            raise AssertionError(f"{phase}: ops that {self.name} must not "
                                 f"run were launched: {busy}")

    def phase(self, base: str) -> str:
        return f"{self.prefix}{base}"

    def build(self, depth=DEPTH, **kw):
        return self.cls(img_size=224, patch_size=self.patch, num_classes=10,
                        depth=depth, **self.model_kw, **kw)


# Without the tile-band variables MHLA-B/4 runs the S-minor band (K1/K2)
# and launches no tile-band kernel.
MHLA = ModelPath("", "MHLA-B/4", VisionTransformerMHLA, "vit_mhla", band,
                 "band", idle_ops=(tile,))
DENSE = ModelPath("vit-", "dense ViT-B/4", VisionTransformer, "vit", flash,
              "flash")
# The short-S path: ViT-B/16 (S = 197) with attention dropout, whose
# attention is the fused op when FAVIT_FUSED_MHA=1.
E1 = ModelPath("e1-", "ViT-B/16", VisionTransformer, "vit", fused, "fused",
               patch=16, model_kw=dict(attn_dropout=TRAIN_DROPOUT))
# MHLA-B/4 through the token-major tile band (K6/K7) instead of the S-minor
# band (K1/K2, which must then launch nothing).
TILE_ENV = {"FAVIT_MHLA_IMPL": "shiftband", "FAVIT_USE_PALLAS_MHLA": "1"}
TILE = ModelPath("tile-", "MHLA-B/4 tile band", VisionTransformerMHLA,
                 "vit_mhla", tile, "tile band", env=TILE_ENV,
                 train_fwd_kind="fwd", idle_ops=(band,))


def phase_model(path: ModelPath, cpu_model: torch.nn.Module,
                image: np.ndarray) -> np.ndarray:
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    with torch.inference_mode():
        x = prepare_eval_batch(torch.from_numpy(image), 224)
        ref_logits = cpu_model(x)
        path.reset_counts()
        logits = gpu_model(x.to("cuda")).cpu()
        launches = path.op.launch_count()
    path.check_idle(path.phase("model"))
    ref_probs = torch.softmax(ref_logits, -1)
    probs = torch.softmax(logits, -1)
    dl = float((logits - ref_logits).abs().max())
    dp = float((probs - ref_probs).abs().max())
    log(path.phase("model"),
        f"{path.name} f32 batch 1, card vs CPU: max |d logits| {dl:.3g} "
        f"(tol 1e-3), max |d probs| {dp:.3g} (tol 1e-4), {path.op_name} "
        f"launches {launches}")
    if not (dl <= 1e-3 and dp <= 1e-4):
        raise AssertionError(f"{path.name} on the card disagrees with the "
                             f"CPU")
    if launches != DEPTH:
        raise AssertionError(f"expected {DEPTH} {path.op_name} launches, "
                             f"got {launches}")
    return ref_probs.numpy()


def _post(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise AssertionError(f"POST /predict returned {resp.status}")
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def _check_probs(probs: np.ndarray, n: int) -> None:
    if probs.shape != (n, 10):
        raise AssertionError(f"expected probs of shape {(n, 10)}, got "
                             f"{probs.shape}")
    if not np.isfinite(probs).all():
        raise AssertionError("non-finite probabilities")
    if np.abs(probs.sum(-1) - 1.0).max() > 1e-3:
        raise AssertionError("probability rows do not sum to 1")


def phase_serve(path: ModelPath, cpu_model, image, ref_probs) -> int:
    rng = np.random.default_rng(1)
    phase = path.phase("serve")
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, f"{path.flag}_b4.pt")
        torch.save(cpu_model.state_dict(), weights)
        t0 = time.perf_counter()
        args, predictor = serve.setup([
            "--model", path.flag, "--patch_size", "4", "--img_size", "224",
            "--compute_dtype", "bfloat16", "--batch_size", "32",
            "--weights", weights,
        ])
    if not isinstance(predictor.model, path.cls):
        raise AssertionError(f"--model {path.flag} built "
                             f"{type(predictor.model).__name__}")
    log(phase, f"set-up (weights, model, warm-up batch) "
                 f"{time.perf_counter() - t0:.1f} s")
    forwards = [0]
    hook = predictor.model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    path.reset_counts()

    sizes = [1, 7, 16, 32, 3, 25, 40, 12]  # 40 > the batch of 32
    reqs = [_images(rng, n) for n in sizes]
    with serve.BatchingServer(predictor, max_delay_ms=args.max_delay_ms,
                              workers=args.workers) as srv, \
            serve.HTTPFrontend(srv, host="127.0.0.1", port=0) as fe:
        with ThreadPoolExecutor(max_workers=4) as pool:
            outs = list(pool.map(
                lambda r: srv.submit(r).result(timeout=300), reqs))
        for req, out in zip(reqs, outs):
            _check_probs(out, len(req))
        url = f"http://{fe.host}:{fe.port}"
        http_req = np.concatenate([image, _images(rng, 4)])
        http_out = _post(url, http_req)
        _check_probs(http_out, len(http_req))
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        log(phase, f"{len(reqs)} concurrent requests of {sizes} images and "
                     f"one POST /predict of {len(http_req)}: shapes, finite, "
                     f"rows sum to 1; /stats {stats}")
        if stats["requests"] != len(reqs) + 1:
            raise AssertionError(f"/stats counted {stats['requests']} requests")
        # The served bf16 probabilities of the phase-4 image against the f32
        # reference: bf16 rounding through 12 blocks, so 1e-2 abs.
        dp = float(np.abs(http_out[0] - ref_probs[0]).max())
        log(phase, f"bf16 served probs vs f32 CPU reference: max abs diff "
                     f"{dp:.3g} (tol 1e-2)")
        if dp > 1e-2:
            raise AssertionError("served probabilities disagree with the "
                                 "f32 reference")

        full = _images(rng, args.batch_size)
        lat = []
        for _ in range(12):
            t0 = time.perf_counter()
            predictor.predict_proba(full)
            lat.append(time.perf_counter() - t0)
        lat_ms = statistics.median(lat[2:]) * 1e3
        burst = [_images(rng, args.batch_size) for _ in range(16)]
        t0 = time.perf_counter()
        futs = [srv.submit(r) for r in burst]
        for f in futs:
            _check_probs(f.result(timeout=300), args.batch_size)
        wall = time.perf_counter() - t0
        n_img = args.batch_size * len(burst)
        log(phase, f"full batch of {args.batch_size}: median latency "
                     f"{lat_ms:.2f} ms (host clock, 10 runs, uint8 in to "
                     f"probs out); burst of {len(burst)} x "
                     f"{args.batch_size} through the server: "
                     f"{n_img / wall:.1f} images/s")
    hook.remove()
    launches = path.op.launch_count()
    path.check_idle(phase)
    log(phase, f"forward passes {forwards[0]}, {path.op_name} launches "
                 f"{launches}")
    if launches != DEPTH * forwards[0] or forwards[0] == 0:
        raise AssertionError(f"{path.op_name} launches {launches} != "
                             f"{DEPTH} x {forwards[0]} forward passes")
    return launches


def _leaf_grads(model: torch.nn.Module) -> dict:
    return {n: p.grad.detach().float().cpu()
            for n, p in model.named_parameters()}


def phase_train_parity(path: ModelPath) -> None:
    """One train step, card against CPU, f32 with TF32 off (phase_device)."""
    cpu_model = path.build(depth=2,
                           generator=torch.Generator().manual_seed(1))
    gpu_model = copy.deepcopy(cpu_model)
    rng = np.random.default_rng(2)
    u8, y = _images(rng, 2), rng.integers(0, 10, size=2)
    step = train.make_train_step(224, augment=False)
    metrics = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        # The default device is the card; the CPU side asks for the CPU.
        state = (train.create_train_state(model, train.make_adamw(1e-4))
                 if name == "cuda" else
                 train.create_train_state(model, train.make_adamw(1e-4),
                                          device="cpu"))
        if next(model.parameters()).device.type != name:
            raise AssertionError(f"create_train_state left the model on "
                                 f"{next(model.parameters()).device}")
        path.reset_counts()
        _, m = step(state, u8, y, 0)
        metrics[name] = float(m["loss_sum"]) / 2
        if name == "cuda":
            torch.cuda.synchronize()
            counts = [path.op.launch_count(k) for k in path.op.LAUNCH_KINDS]
    d_loss = abs(metrics["cuda"] - metrics["cpu"])
    g_gpu, g_cpu = _leaf_grads(gpu_model), _leaf_grads(cpu_model)
    worst, worst_name, worst_err = 0.0, "", 0.0
    for n, ref in g_cpu.items():
        err = float((g_gpu[n] - ref).abs().max())
        bound = PARITY_GRAD_REL * float(ref.abs().max()) + PARITY_GRAD_ABS
        if err / bound > worst:
            worst, worst_name, worst_err = err / bound, n, err
    log(path.phase("train-parity"),
                        f"{path.name} at depth 2, f32, batch 2, one step: loss "
                        f"card {metrics['cuda']:.6f} CPU {metrics['cpu']:.6f}"
                        f" (|d| {d_loss:.3g}, tol {PARITY_LOSS_TOL}); worst "
                        f"gradient leaf {worst_name}: |d| {worst_err:.3g} = "
                        f"{worst:.3f} of its tolerance ({PARITY_GRAD_REL} x "
                        f"leaf max + {PARITY_GRAD_ABS}); launches "
                        f"{dict(zip(path.op.LAUNCH_KINDS, counts))}")
    if d_loss > PARITY_LOSS_TOL or worst > 1.0:
        raise AssertionError("the train step on the card disagrees with the "
                             "CPU")
    expect = list(path.expected(0, 1, depth=2).values())
    if counts != expect:
        raise AssertionError(f"expected launches {expect} of "
                             f"{path.op.LAUNCH_KINDS}, got {counts}")
    path.check_idle(path.phase("train-parity"))


def _train_run(model, data, microbatch, log_lines):
    """``train_and_evaluate`` for one epoch; returns (result, passes), the
    forward passes counted by mode with a hook."""
    passes = {"train": 0, "eval": 0}
    hook = model.register_forward_pre_hook(
        lambda mod, _: passes.__setitem__(
            "train" if mod.training else "eval",
            passes["train" if mod.training else "eval"] + 1))
    state = train.create_train_state(model, train.make_adamw(1e-4))
    result = train.train_and_evaluate(
        state,
        train.make_train_step(224, compute_dtype=torch.bfloat16,
                              microbatch=microbatch),
        train.make_eval_step(224, compute_dtype=torch.bfloat16),
        data, epochs=1, batch_size=TRAIN_BATCH, seed=0,
        log_fn=log_lines.append,
    )
    torch.cuda.synchronize()
    hook.remove()
    return result, passes


def _check_trained(model, before: dict, result: dict, what: str) -> None:
    losses = result["train_losses"] + result["val_losses"]
    if not (losses and np.isfinite(losses).all()):
        raise AssertionError(f"{what}: non-finite or missing losses {losses}")
    unmoved = [n for n, p in model.named_parameters()
               if torch.equal(p.detach(), before[n])]
    if unmoved:
        raise AssertionError(f"{what}: parameters did not move: {unmoved}")
    for name, p in model.named_parameters():
        if ".attn." in name and name.endswith("weight") and (
                p.grad is None or not bool(
                    torch.isfinite(p.grad).all() & (p.grad.abs().max() > 0))):
            raise AssertionError(f"{what}: {name} got no finite non-zero "
                                 f"gradient")


def phase_train(path: ModelPath, attn_dropout_launches: bool,
                main_steps: int = 6) -> dict:
    """Trains ``path``'s model through ``train_and_evaluate``: a main run
    at dropout 0.1, then a short run with attention dropout 0.1 at
    microbatch 16, whose training passes launch the op's training kernels
    iff ``attn_dropout_launches`` (the band drops slots inside its kernels;
    dense attention takes the query-chunked plain path). Returns the launch
    counts."""
    phase = path.phase("train")
    data = load_dataset(
        "cifar10", data_dir=str(REPO / "build" / "no-cifar"),
        subset_size=main_steps * TRAIN_BATCH, synthetic_sizes=(1024, 256))
    if not data["synthetic"]:
        raise AssertionError("expected the synthetic CIFAR stand-in")
    path.reset_counts()
    lines = []
    passes = {"train": 0, "eval": 0, "train_with_kernels": 0}
    runs = (
        # (label, model kwargs, microbatch, data, launches training kernels)
        ("dropout 0.1", dict(dropout=TRAIN_DROPOUT), None, data, True),
        (f"attn_dropout {TRAIN_DROPOUT}, microbatch 16",
         dict(dropout=TRAIN_DROPOUT, attn_dropout=TRAIN_DROPOUT), 16,
         {**data, "train_images": data["train_images"][:2 * TRAIN_BATCH],
          "train_labels": data["train_labels"][:2 * TRAIN_BATCH]},
         attn_dropout_launches),
    )
    main_state = None
    for i, (label, kwargs, microbatch, run_data, launches_train) in enumerate(
            runs):
        model = path.build(device="cuda",
                           generator=torch.Generator().manual_seed(3 + i),
                           **kwargs)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        t0 = time.perf_counter()
        result, run_passes = _train_run(model, run_data, microbatch, lines)
        for line in lines:
            log(phase, f"{label}: {line}")
        lines.clear()
        log(phase, f"{label}: {len(run_data['train_images'])} train and "
                   f"{len(run_data['test_images'])} val images in "
                   f"{time.perf_counter() - t0:.1f} s; forward passes "
                   f"{run_passes}")
        _check_trained(model, before, result, label)
        for k in run_passes:
            passes[k] += run_passes[k]
        if launches_train:
            passes["train_with_kernels"] += run_passes["train"]
        if i == 0:
            main_state = result["state"]
        del model, before
    launches = {k: path.op.launch_count(k) for k in path.op.LAUNCH_KINDS}
    log(phase, f"{path.op_name} launches {launches} for {passes} forward "
               f"passes (each train forward has one backward)")
    expect = path.expected(passes["eval"], passes["train_with_kernels"])
    if launches != expect or passes["train"] == 0 or passes["eval"] == 0:
        raise AssertionError(f"{path.op_name} launches {launches} != "
                             f"{expect}")
    path.check_idle(phase)

    # Speed and memory of the main run's step, after its epoch.
    rng = np.random.default_rng(4)
    u8 = _images(rng, TRAIN_BATCH)
    y = rng.integers(0, 10, size=TRAIN_BATCH)
    step = train.make_train_step(224, compute_dtype=torch.bfloat16)
    step(main_state, u8, y, 100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    for j in range(n):
        main_state, m = step(main_state, u8, y, 101 + j)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f"{path.name} train step, bf16 autocast, batch {TRAIN_BATCH}, "
               f"dropout {TRAIN_DROPOUT}: {ms:.2f} ms per step, "
               f"{TRAIN_BATCH / ms * 1e3:.1f} images/s (host clock, mean "
               f"of {n} steps after a warm-up), peak memory {peak:.2f} GiB "
               f"(max_memory_allocated); last loss "
               f"{float(m['loss_sum']) / TRAIN_BATCH:.4f}")
    return launches


def _flash_check(got, ref, dtype, f32_tol, max_ulps=BF16_ULPS):
    """(max abs err, ok, description) of a flash kernel result against its
    plain version: f32 within ``f32_tol`` abs; bf16 by the bound stated at
    FLASH_ULP_FLOOR_SHARE."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        return err, err <= f32_tol, f"{err:.3g}"
    floor = max(FLASH_ULP_FLOOR_SHARE * float(ref.abs().max()),
                BF16_ULP_FLOOR)
    ulps = bf16_ulps(got, ref, floor)
    rms = float((got - ref).pow(2).mean().sqrt())
    rms_ref = float(ref.pow(2).mean().sqrt())
    ok = ulps <= max_ulps and rms <= FLASH_RMS_REL * rms_ref + 1e-6
    return err, ok, (f"{err:.3g} ({ulps:.2f} ulps, rms "
                     f"{rms / max(rms_ref, 1e-30):.2g} of the plain rms)")


def _compare_flash(q, k, v, g):
    """The eval forward, the training forward and the backward kernels
    against the plain versions on the same inputs; {name: (err, ok, text)}.
    The backward takes the kernel's own out and lse, as the autograd
    Function hands them over, on both sides."""
    dtype = q.dtype
    out_eval = flash.flash_attention(q, k, v)
    out, lse = flash.flash_forward_train(q, k, v)
    ref_out, ref_lse = flash.plain_flash_forward(q, k, v)
    grads = flash.flash_backward(q, k, v, out, lse, g)
    ref_grads = flash.plain_flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    res = {"out_eval": _flash_check(out_eval, ref_out, dtype, F32_TOL),
           "out": _flash_check(out, ref_out, dtype, F32_TOL),
           # lse is f32 on both sides: f32 logits of the same inputs.
           "lse": _flash_check(lse, ref_lse, torch.float32, F32_TOL)}
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        res[name] = _flash_check(a, b, dtype, F32_BWD_TOL)
    return res


def phase_kernel_flash() -> dict:
    import torch.nn.functional as F  # the library call, timed as a yardstick

    gen = torch.Generator(device="cuda").manual_seed(5)

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(4)]

    def check(where, res):
        bad = [f"{n} {t}" for n, (_, ok, t) in res.items() if not ok]
        if bad:
            raise AssertionError(f"flash kernels disagree with the plain "
                                 f"versions at {where}: {bad}")

    # 127, 197, 513, 1000 and 3137 leave ragged last tiles on both axes.
    seqs = (1, 127, 197, 513, 1000, 3137)
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for d in (16, 64, 128):
            worst = {}
            for s in seqs:
                q, k, v, g = inputs((2, 3, s, d), dtype)
                res = _compare_flash(q, k, v, g)
                check(f"{(2, 3, s, d)} {dt}", res)
                for n, (e, _, _) in res.items():
                    worst[n] = max(worst.get(n, 0.0), e)
            log("kernel-flash", f"{dt} d={d}, S in {seqs}: max abs err "
                                + ", ".join(f"{n} {e:.3g}"
                                            for n, e in worst.items()))

    b, h, s, d = FLASH_SHAPE
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, g = inputs(FLASH_SHAPE, dtype)
        res = _compare_flash(q, k, v, g)
        check(f"the serving shape {FLASH_SHAPE} {dt}", res)
        log("kernel-flash", f"serving shape {FLASH_SHAPE} {dt}: max abs err "
                            + ", ".join(f"{n} {t}"
                                        for n, (_, _, t) in res.items()))
        out, lse = flash.flash_forward_train(q, k, v)
        first = flash.flash_backward(q, k, v, out, lse, g)
        second = flash.flash_backward(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(first, second)):
            raise AssertionError(f"two runs of the {dt} flash backward "
                                 f"differ")
        errs = {n: e for n, (e, _, _) in res.items()}
        del first, second, res
        # The scalar f32 kernels and every plain version take tens to
        # hundreds of ms a call here: fewer repeats.
        reps = 30 if dtype == torch.bfloat16 else 5
        times = {
            "fwd": cuda_median_ms(
                lambda: flash.flash_attention(q, k, v), reps),
            "fwd_train": cuda_median_ms(
                lambda: flash.flash_forward_train(q, k, v), reps),
            "bwd": cuda_median_ms(
                lambda: flash.flash_backward(q, k, v, out, lse, g), reps),
            "fwd_plain": cuda_median_ms(
                lambda: flash.plain_flash_forward(q, k, v), 5, 1),
            "bwd_plain": cuda_median_ms(
                lambda: flash.plain_flash_backward(q, k, v, out, lse, g),
                5, 1),
        }
        # PyTorch's fused attention on the same inputs: forward without and
        # with autograd's saved statistics, and its backward alone.
        with torch.no_grad():
            times["fwd_library"] = cuda_median_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), reps)
        lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
        times["fwd_train_library"] = cuda_median_ms(
            lambda: F.scaled_dot_product_attention(lq, lk, lv), reps)
        lib_out = F.scaled_dot_product_attention(lq, lk, lv)
        times["bwd_library"] = cuda_median_ms(
            lambda: torch.autograd.grad(lib_out, (lq, lk, lv), g,
                                        retain_graph=True), reps)
        lib_err = float(
            (lib_out.detach().float() - out.float()).abs().max())
        del lib_out, lq, lk, lv
        log("kernel-flash", f"serving shape {dt}, kernel / plain / PyTorch "
                            f"fused attention, ms: forward "
                            f"{times['fwd']:.4f} / {times['fwd_plain']:.4f} / "
                            f"{times['fwd_library']:.4f}; training forward "
                            f"{times['fwd_train']:.4f} / "
                            f"{times['fwd_plain']:.4f} / "
                            f"{times['fwd_train_library']:.4f}; backward "
                            f"{times['bwd']:.4f} / {times['bwd_plain']:.4f} / "
                            f"{times['bwd_library']:.4f} (CUDA-event medians "
                            f"of {reps}, plain of 5); two backward runs "
                            f"bit-identical; max |kernel - fused| "
                            f"{lib_err:.3g}")
        # The function's least work: q, k, v in and out back (plus lse),
        # two products of S*S*d multiply-adds; the backward reads q, k, v,
        # out, g and lse, writes dq, dk, dv, and needs five products.
        one = q.numel() * q.element_size()
        pairs = b * h * s * s * d
        result[dt] = dict(
            fwd=dict(max_abs_err=errs["out_eval"],
                     ms=times["fwd"], plain_ms=times["fwd_plain"],
                     library_ms=times["fwd_library"],
                     **least_time(4 * one, 4 * pairs)),
            fwd_train=dict(max_abs_err=max(errs["out"], errs["lse"]),
                           ms=times["fwd_train"],
                           plain_ms=times["fwd_plain"],
                           library_ms=times["fwd_train_library"],
                           **least_time(4 * one + lse.numel() * 4, 4 * pairs)),
            bwd=dict(max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
                     ms=times["bwd"], plain_ms=times["bwd_plain"],
                     library_ms=times["bwd_library"],
                     **least_time(8 * one + lse.numel() * 4, 10 * pairs)),
        )
        gflop = {"fwd": 4 * pairs / 1e9, "fwd_train": 4 * pairs / 1e9,
                 "bwd": 10 * pairs / 1e9}
        rates = "; ".join(
            f"{kind} {r['ms']:.4f} ms, {gflop[kind] / r['ms']:.1f} TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.3f} of the bound, "
            f"{r['ms'] / r['library_ms']:.3f}x the library"
            for kind, r in result[dt].items())
        log("kernel-flash", f"serving shape {dt}, of the function's work (4 "
                            f"S^2 d B h flops forward, 10 backward): {rates}")
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    return result


def _rms_check(got, ref):
    """(max abs err, ok, description): the error's rms within FLASH_RMS_REL
    of the reference's rms, and no bound on the worst entry."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    rms = float((got - ref).pow(2).mean().sqrt())
    rms_ref = float(ref.pow(2).mean().sqrt())
    return err, rms <= FLASH_RMS_REL * rms_ref + 1e-6, (
        f"{err:.3g} (rms {rms / max(rms_ref, 1e-30):.2g} of the plain rms)")


def _compare_fused(q, k, v, g, rate, seed, max_ulps=BF16_ULPS):
    """The eval forward (at rate 0), the training forward and the backward
    kernels of the fused short-S attention against the plain versions on
    the same inputs; {name: (err, ok, text)}. The backward takes the
    kernel's own out and lse, as the autograd Function hands them over.

    The f32 backward is held to the plain version's direct row sum, which
    shows that the kernel's rowsum(g * out) is the same number with
    dropout. The bf16 kernels are held to the plain versions run in f32 on
    the same bf16 values (as the flash op's plain versions compute) and
    not rounded: the plain versions' own bf16 roundings of the weights, of
    ds and of the result would otherwise count against the kernel. The
    bf16 backward is held twice: entry by entry to a reference that takes
    the row sum from the same bf16 out, whose rounding both then carry, and
    by the rms bound to the direct row sum (``dq_direct``, ``dk_direct``),
    which holds the identity in bf16 too. At S = 1 the true dq and dk are 0
    and out's rounding is all there is, so the second has no scale to be
    relative to and is left out."""
    dtype = q.dtype
    res = {}

    def held(got, ref, dt, tol):
        return _flash_check(got, ref, dt, tol, max_ulps)

    if dtype == torch.bfloat16:
        rq, rk, rv, rg = (x.float() for x in (q, k, v, g))
    else:
        rq, rk, rv, rg = q, k, v, g
    ref_out, ref_lse = fused.plain_fused_mha_forward(rq, rk, rv, rate, seed)
    if rate == 0.0:
        with torch.no_grad():
            out_eval = fused.fused_multi_head_attention(q, k, v)
        res["out_eval"] = held(out_eval, ref_out, dtype, F32_TOL)
    out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    ref_grads = fused.plain_fused_mha_backward(
        rq, rk, rv, rg, rate, seed,
        out=out.float() if dtype == torch.bfloat16 else None)
    torch.cuda.synchronize()
    res["out"] = held(out, ref_out, dtype, F32_TOL)
    # lse is f32 on both sides: f32 logits of the same inputs.
    res["lse"] = held(lse, ref_lse, torch.float32, F32_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        res[name] = held(a, b, dtype, F32_BWD_TOL)
    if dtype == torch.bfloat16 and q.shape[2] > 1:
        direct = fused.plain_fused_mha_backward(rq, rk, rv, rg, rate, seed)
        for name, a, b in zip(("dq_direct", "dk_direct"), grads, direct):
            res[name] = _rms_check(a, b)
    return res


def phase_kernel_fused() -> dict:
    import torch.nn.functional as F  # the library call, timed as a yardstick

    gen = torch.Generator(device="cuda").manual_seed(6)
    phase = "kernel-fused"

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(4)]

    failures = []

    def check(where, res):
        bad = [f"{n} {t}" for n, (_, ok, t) in res.items() if not ok]
        if bad:
            failures.append(f"{where}: {bad}")

    def raise_failures():
        if failures:
            raise AssertionError("fused attention kernels disagree with the "
                                 "plain versions at " + "; ".join(failures))

    # 1, 17, 197 and 577 leave ragged last tiles on both axes; 1024 is the
    # op's longest sequence.
    seqs = (1, 17, 128, 197, 256, 577, 1024)
    seed = 2**40 + 99
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for d in (16, 64):
            worst = {}
            for s in seqs:
                q, k, v, g = inputs((2, 3, s, d), dtype)
                loose = dtype == torch.bfloat16 and (s, d) in FUSED_LOOSE_CASES
                for rate in (0.0, TRAIN_DROPOUT):
                    res = _compare_fused(
                        q, k, v, g, rate, seed + s,
                        FUSED_LOOSE_ULPS if loose else BF16_ULPS)
                    check(f"{(2, 3, s, d)} {dt} rate {rate}", res)
                    if loose:
                        log(phase, f"{(2, 3, s, d)} bf16 rate {rate}, held "
                                   f"to {FUSED_LOOSE_ULPS} ulps: "
                                   + ", ".join(f"{n} {t}" for n, (_, _, t)
                                               in res.items()))
                    for n, (e, _, _) in res.items():
                        worst[n] = max(worst.get(n, 0.0), e)
            log(phase, f"{dt} d={d}, S in {seqs}, rate 0 and "
                       f"{TRAIN_DROPOUT}: max abs err "
                       + ", ".join(f"{n} {e:.3g}" for n, e in worst.items()))
    raise_failures()

    # The mask, bit for bit: against the plain generator on the CPU at a
    # few rows, and on the card at the training shape.
    b, h, s, d = FUSED_SHAPE
    small = fused.keep_bits(6, s, seed, "cuda").cpu()
    if not torch.equal(small, fused.keep_bits(6, s, seed, "cpu")):
        raise AssertionError("the fused kernels' dropout bits differ from "
                             "the plain generator's on the CPU")
    bits = fused.keep_bits(b * h, s, seed, "cuda")
    if not torch.equal(bits, philox.mha_keep_bits(b * h, s, seed, "cuda")):
        raise AssertionError("the fused kernels' dropout bits differ from "
                             "the plain generator's")
    kept = float((bits >= philox.keep_threshold(TRAIN_DROPOUT)).float().mean())
    log(phase, f"dropout words at B*h={b * h}, S={s}: identical to the plain "
               f"generator's ({bits.numel()} words; share kept at rate "
               f"{TRAIN_DROPOUT}: {kept:.5f})")
    del bits, small
    torch.cuda.empty_cache()

    rate = TRAIN_DROPOUT
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, g = inputs(FUSED_SHAPE, dtype)
        errs = {}
        for r in (0.0, rate):
            res = _compare_fused(q, k, v, g, r, seed)
            check(f"the training shape {FUSED_SHAPE} {dt} rate {r}", res)
            log(phase, f"training shape {FUSED_SHAPE} {dt} rate {r}: max abs "
                       f"err " + ", ".join(f"{n} {t}"
                                           for n, (_, _, t) in res.items()))
            for n, (e, _, _) in res.items():
                errs[n] = max(errs.get(n, 0.0), e)
        raise_failures()
        out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
        first = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
        second = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(first, second)):
            raise AssertionError(f"two runs of the {dt} fused backward "
                                 f"differ")
        del first, second, res
        # bf16 kernels and library calls: medians of 30 batches of 10 calls
        # (a call takes about as long on the host as on the card).
        reps, batch = (30, 10) if dtype == torch.bfloat16 else (5, 1)
        with torch.no_grad():
            times = {
                "fwd": cuda_median_ms(
                    lambda: fused.fused_multi_head_attention(q, k, v), reps,
                    batch=batch),
                "fwd_train": cuda_median_ms(
                    lambda: fused.fused_mha_forward_train(q, k, v, rate,
                                                          seed), reps,
                    batch=batch),
                "fwd_train_nodrop": cuda_median_ms(
                    lambda: fused.fused_mha_forward_train(q, k, v), reps,
                    batch=batch),
                "bwd": cuda_median_ms(
                    lambda: fused.fused_mha_backward(q, k, v, out, lse, g,
                                                     rate, seed), reps,
                    batch=batch),
                "bwd_nodrop": cuda_median_ms(
                    lambda: fused.fused_mha_backward(q, k, v, out, lse, g),
                    reps, batch=batch),
                "fwd_plain": cuda_median_ms(
                    lambda: fused.plain_fused_mha_forward(q, k, v), 5, 1),
                "fwd_train_plain": cuda_median_ms(
                    lambda: fused.plain_fused_mha_forward(q, k, v, rate,
                                                          seed), 5, 1),
                "bwd_plain": cuda_median_ms(
                    lambda: fused.plain_fused_mha_backward(
                        q, k, v, g, rate, seed, out=out), 5, 1),
                # PyTorch's fused attention on the same inputs.
                "fwd_library": cuda_median_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v), reps,
                    batch=batch),
            }
        times.update(_fused_library_times(q, k, v, g, rate, reps, batch))
        log(phase, f"training shape {dt}, kernel / plain / PyTorch fused "
                   f"attention, ms: eval forward {times['fwd']:.4f} / "
                   f"{times['fwd_plain']:.4f} / {times['fwd_library']:.4f}; "
                   f"training forward at rate {rate} "
                   f"{times['fwd_train']:.4f} / "
                   f"{times['fwd_train_plain']:.4f} / "
                   f"{times['fwd_train_library']:.4f} (at rate 0: kernel "
                   f"{times['fwd_train_nodrop']:.4f}, PyTorch "
                   f"{times['fwd_train_nodrop_library']:.4f}); backward at "
                   f"rate {rate} {times['bwd']:.4f} / "
                   f"{times['bwd_plain']:.4f} / {times['bwd_library']:.4f} "
                   f"(at rate 0: kernel {times['bwd_nodrop']:.4f}, PyTorch "
                   f"{times['bwd_nodrop_library']:.4f}) (CUDA-event medians "
                   f"of {reps} batches of {batch}, plain of 5 calls); two "
                   f"backward runs bit-identical")
        # The function's least work: q, k, v in and out back; the backward
        # takes q, k, v and g and gives dq, dk, dv. Two products of S*S*d
        # multiply-adds forward, five backward. The lse that the training
        # forward writes, and the out and lse that the backward reads, are
        # this design's saved state and not part of the function (the TPU
        # kernel saves q, k, v and the seed alone): they stay out of the
        # bound.
        one = q.numel() * q.element_size()
        pairs = b * h * s * s * d
        result[dt] = dict(
            fwd=dict(max_abs_err=errs["out_eval"], ms=times["fwd"],
                     plain_ms=times["fwd_plain"],
                     library_ms=times["fwd_library"],
                     **least_time(4 * one, 4 * pairs)),
            fwd_train=dict(max_abs_err=max(errs["out"], errs["lse"]),
                           ms=times["fwd_train"],
                           plain_ms=times["fwd_train_plain"],
                           library_ms=times["fwd_train_library"],
                           **least_time(4 * one, 4 * pairs)),
            bwd=dict(max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
                     ms=times["bwd"], plain_ms=times["bwd_plain"],
                     library_ms=times["bwd_library"],
                     **least_time(7 * one, 10 * pairs)),
        )
        if dtype == torch.bfloat16:
            log(phase, f"training shape bf16: eval forward "
                       f"{4 * one / times['fwd'] / 1e6:.0f} GB/s of q, k, v, "
                       f"out and {4 * pairs / times['fwd'] / 1e9:.1f} "
                       f"TFLOP/s; backward "
                       f"{7 * one / times['bwd'] / 1e6:.0f} GB/s of q, k, "
                       f"v, g, dq, dk, dv and "
                       f"{10 * pairs / times['bwd'] / 1e9:.1f} TFLOP/s")
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()

    # A row longer than one block holds: the tiled kernels, timed beside
    # the library call (bf16, d = 64, rate 0.1). The grid above holds them
    # to the ulps rule at S = 577; this timing shape, 64 times as many
    # rows, is held to the rms rule, and its worst entries are printed.
    q, k, v, g = inputs(FUSED_TILED_SHAPE, torch.bfloat16)
    res = _compare_fused(q, k, v, g, rate, seed, max_ulps=float("inf"))
    check(f"the tiled shape {FUSED_TILED_SHAPE} bf16 rate {rate}", res)
    raise_failures()
    out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
    with torch.no_grad():
        tiled = {
            "fwd": cuda_median_ms(
                lambda: fused.fused_multi_head_attention(q, k, v), 30,
                batch=10),
            "fwd_train": cuda_median_ms(
                lambda: fused.fused_mha_forward_train(q, k, v, rate, seed),
                30, batch=10),
            "bwd": cuda_median_ms(
                lambda: fused.fused_mha_backward(q, k, v, out, lse, g, rate,
                                                 seed), 30, batch=10),
            "fwd_library": cuda_median_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), 30,
                batch=10),
        }
    tiled.update(_fused_library_times(q, k, v, g, rate, 30, 10))
    log(phase, f"tiled shape {FUSED_TILED_SHAPE} bf16 (S past the whole-row "
               f"kernels), kernel / PyTorch fused attention, ms: eval "
               f"forward {tiled['fwd']:.4f} / {tiled['fwd_library']:.4f}; "
               f"training forward at rate {rate} {tiled['fwd_train']:.4f} / "
               f"{tiled['fwd_train_library']:.4f}; backward at rate {rate} "
               f"{tiled['bwd']:.4f} / {tiled['bwd_library']:.4f} (medians of "
               f"30 batches of 10); max abs err "
               + ", ".join(f"{n} {t}" for n, (_, _, t) in res.items()))
    del q, k, v, g, out, lse
    torch.cuda.empty_cache()
    return result


def _fused_library_times(q, k, v, g, rate, reps, batch) -> dict:
    """CUDA-event times of PyTorch's fused attention as the training forward
    (with ``dropout_p``) and of its backward through autograd, at ``rate``
    and at 0: the yardstick, used nowhere in the port."""
    import torch.nn.functional as F

    times = {}
    lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
    for key, p_drop in (("", rate), ("_nodrop", 0.0)):
        times[f"fwd_train{key}_library"] = cuda_median_ms(
            lambda: F.scaled_dot_product_attention(
                lq, lk, lv, dropout_p=p_drop), reps, batch=batch)
        lib_out = F.scaled_dot_product_attention(lq, lk, lv,
                                                 dropout_p=p_drop)
        times[f"bwd{key}_library"] = cuda_median_ms(
            lambda: torch.autograd.grad(lib_out, (lq, lk, lv), g,
                                        retain_graph=True), reps,
            batch=batch)
    return times


@contextlib.contextmanager
def _fused_switch(on: bool):
    """FAVIT_FUSED_MHA set to 1, or unset, for a block; the environment is
    restored after."""
    with mock.patch.dict(os.environ):
        os.environ.pop("FAVIT_FUSED_MHA", None)
        if on:
            os.environ["FAVIT_FUSED_MHA"] = "1"
        yield


def _host_mask_dropout(x, rate, rng):
    """``layers.inverted_dropout`` with the mask drawn on the CPU from
    ``rng.host``: the card and the CPU then drop the same entries."""
    if rate == 0.0:
        return x
    keep = torch.empty(x.shape, dtype=torch.bool).bernoulli_(
        1.0 - rate, generator=rng.host).to(x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def phase_e1_parity() -> None:
    """One f32 train step of ViT-B/16 at 2 blocks with attention dropout
    0.1 and the fused switch on, card against CPU: K3 with in-kernel
    dropout and K4 against their plain versions through the whole model.
    The attention's output dropout draws from a device generator, which
    differs between the card and the CPU, so for this phase its mask is
    drawn on the CPU on both sides; the weight dropout inside the fused op
    is the op's own (Philox from a host seed) on both."""
    from focused_attention_vit_tpu_torch.models import layers

    with _fused_switch(True), mock.patch.object(
            layers, "inverted_dropout", _host_mask_dropout):
        phase_train_parity(E1)


E1_COLUMNS = [
    "model", "img_size", "patch_size", "embed_dim", "depth", "num_heads",
    "parameters", "flops", "time_complexity", "space_complexity_mb",
    "model_size_mb", "avg_epoch_time", "total_training_time",
    "final_val_acc", "final_val_loss", "test_acc", "test_loss",
    "avg_inference_time_per_image", "peak_gpu_memory_mb",
]
E1_BATCH = 128


def _cli_run(tmp: str, argv: list, model_cls, results: str):
    """``cli.main(argv)`` with its working directory in ``tmp`` (where the
    CLI writes its log file and E3/E5 find ``./pretrained_weights``) on the
    synthetic CIFAR stand-in; returns the experiment (None for the E7/E8
    batch runners), the model's forward passes by kind and the seconds
    taken. Passes are counted by a global
    forward hook: ``train`` in training mode, ``probe`` in eval mode under
    autograd (the mid-run memory probe's backward), ``eval`` in eval mode
    without."""
    from torch.nn.modules import module as nn_module

    from focused_attention_vit_tpu_torch import cli

    passes = {"train": 0, "probe": 0, "eval": 0}

    def count(mod, _):
        if type(mod) is model_cls:
            kind = ("train" if mod.training else
                    "probe" if torch.is_grad_enabled() else "eval")
            passes[kind] += 1

    hook = nn_module.register_module_forward_pre_hook(count)
    cwd = os.getcwd()
    os.chdir(tmp)
    t0 = time.perf_counter()
    try:
        e = cli.main(argv + ["--data_dir", os.path.join(tmp, "no-cifar"),
                             "--results_dir", results])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        hook.remove()
    if e is not None and not e.data["synthetic"]:
        raise AssertionError("expected the synthetic CIFAR stand-in")
    return e, passes, time.perf_counter() - t0


def _csv_row(path: str, columns: list) -> dict:
    import csv as csv_mod

    with open(path, newline="") as f:
        rows = list(csv_mod.reader(f))
    if rows[0] != columns or len(rows) != 2:
        raise AssertionError(f"{path}: columns {rows[0]}, {len(rows) - 1} "
                             f"rows; expected {columns}")
    return dict(zip(rows[0], rows[1]))


def _check_run(e, row, epochs: int, what: str) -> None:
    tr = e.metrics["training"]
    losses = (tr["train_losses"] + tr["val_losses"]
              + [float(row["test_loss"]), float(row["final_val_loss"])])
    if len(tr["train_losses"]) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite or missing losses {losses}")
    if not float(row["peak_gpu_memory_mb"]) > 0:
        raise AssertionError(f"{what} CSV: peak_gpu_memory_mb is not "
                             f"positive")


def _e1_cli(tmp: str, epochs: int):
    """E1 ``traditional`` at ViT-B/16 through ``cli.main``; returns the
    experiment, the model's forward passes by kind, the seconds taken and
    the CSV row."""
    from focused_attention_vit_tpu_torch.utils.metrics import (
        calculate_vit_complexity,
    )

    results = os.path.join(tmp, f"results-{epochs}")
    e, passes, seconds = _cli_run(tmp, [
        "--experiment", "traditional", "--img_size", "224",
        "--patch_size", "16", "--batch_size", str(E1_BATCH),
        "--attn_dropout", str(TRAIN_DROPOUT),
        "--compute_dtype", "bfloat16", "--epochs", str(epochs),
        "--subset_size", "1024",
    ], VisionTransformer, results)
    row = _csv_row(os.path.join(results, "exp1_traditional.csv"),
                   E1_COLUMNS)
    theory = calculate_vit_complexity(224, 16, 768, 12, 12)
    if (int(row["parameters"]), int(row["flops"])) != (
            theory["parameters"], theory["flops"]):
        raise AssertionError(f"E1 CSV: parameters {row['parameters']}, "
                             f"flops {row['flops']} != {theory}")
    _check_run(e, row, epochs, "E1")
    cm = np.load(os.path.join(results, "exp1_traditional_confusion.npy"))
    n_test = len(e.data["test_labels"])
    if cm.shape != (10, 10) or cm.sum() != n_test:
        raise AssertionError(f"E1 confusion matrix {cm.shape} sums to "
                             f"{cm.sum()}, not {n_test}")
    return e, passes, seconds, row


def _step_time(e, microbatch=None, n: int = 5, batch=None):
    """(ms per step, peak GiB) of an experiment's bf16 train step at batch
    128 on its trained state (E1-E6), on ``batch`` (uint8 images, labels)
    or seeded random pixels."""
    rng = np.random.default_rng(7)
    u8, y = batch or (_images(rng, E1_BATCH),
                      rng.integers(0, 10, size=E1_BATCH))
    step = train.make_train_step(224, compute_dtype=torch.bfloat16,
                                 microbatch=microbatch)
    state = e.state
    state, _ = step(state, u8, y, 100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for j in range(n):
        state, _ = step(state, u8, y, 101 + j)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    return ms, torch.cuda.max_memory_allocated() / 2**30


def phase_e1() -> dict:
    """E1 ``traditional`` at ViT-B/16 through the CLI with the fused switch
    on (2 epochs, so that the mid-run probe fires), then one epoch with it
    off; returns the fused launch counts of the first run."""
    phase = "e1"
    ops = (fused, flash, band)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, on, epochs in (("on", True, 2), ("off", False, 1)):
            for op in ops:
                op.reset_launch_count()
            with _fused_switch(on):
                e, passes, seconds, row = _e1_cli(tmp, epochs)
                counts = {k: fused.launch_count(k)
                          for k in fused.LAUNCH_KINDS}
                others = [op.launch_count(k) for op in (flash, band)
                          for k in op.LAUNCH_KINDS]
                ms, peak = _step_time(e)
                sweep = {}
                if on:
                    out.update(counts)
                    sweep = {mb: _step_time(e, mb) for mb in (64, 32, 16)}
            log(phase, f"switch {label}: cli.main, {epochs} epochs of "
                       f"{len(e.data['train_images'])} train and "
                       f"{len(e.data['test_labels'])} test images in "
                       f"{seconds:.1f} s; forward passes {passes}; fused "
                       f"launches {counts}; CSV test_loss "
                       f"{float(row['test_loss']):.4f}, final_val_loss "
                       f"{float(row['final_val_loss']):.4f}, "
                       f"peak_gpu_memory_mb "
                       f"{float(row['peak_gpu_memory_mb']):.1f}, "
                       f"avg_inference_time_per_image "
                       f"{float(row['avg_inference_time_per_image']):.6f} s")
            expect = {"fwd": 0, "fwd_train": 0, "bwd": 0}
            if on:
                grads = DEPTH * (passes["train"] + passes["probe"])
                expect = {"fwd": DEPTH * passes["eval"], "fwd_train": grads,
                          "bwd": grads}
            steps = epochs * (len(e.data["train_images"]) // E1_BATCH)
            if (counts != expect or any(others) or passes["train"] != steps
                    or passes["probe"] != 1 or passes["eval"] == 0):
                raise AssertionError(
                    f"E1 switch {label}: fused launches {counts} != "
                    f"{expect}, flash and band launches {others}, passes "
                    f"{passes} for {steps} steps")
            log(phase, f"switch {label}: ViT-B/16 train step, bf16 autocast, "
                       f"batch {E1_BATCH}, dropout {TRAIN_DROPOUT}, attention "
                       f"dropout {TRAIN_DROPOUT}: {ms:.2f} ms per step, "
                       f"{E1_BATCH / ms * 1e3:.1f} images/s (host clock, "
                       f"mean of 5 steps after a warm-up), peak memory "
                       f"{peak:.2f} GiB (max_memory_allocated)")
            if sweep:
                log(phase, "switch on, microbatch 0 / 64 / 32 / 16: "
                           + " / ".join(f"{m:.2f} ms, {p:.2f} GiB"
                                        for m, p in [(ms, peak),
                                                     *sweep.values()]))
            del e
            torch.cuda.empty_cache()
    return out


E3_COLUMNS = [
    "model", "pretrained_source", "pretrained_model_variant",
    "freeze_layers", "img_size", "patch_size", "embed_dim", "depth",
    "num_heads", "total_parameters", "trainable_parameters",
    "frozen_parameters", "flops", "time_complexity", "space_complexity_mb",
    "model_size_mb", "avg_epoch_time", "total_training_time",
    "final_val_acc", "final_val_loss", "test_acc", "test_loss",
    "avg_inference_time_per_image", "peak_gpu_memory_mb",
]
# E5's row puts the window and the complexity ratio after num_heads.
E5_COLUMNS = E3_COLUMNS[:9] + ["window_size", "complexity_reduction_ratio"] + (
    E3_COLUMNS[9:])
PRETRAINED_ARGS = ["--img_size", "224", "--patch_size", "16", "--batch_size",
                   str(E1_BATCH), "--compute_dtype", "bfloat16", "--epochs",
                   "1", "--subset_size", "1024"]
# The fixture's tensor that the first block's fused qkv is loaded from.
FIXTURE_QKV = "encoder.layers.encoder_layer_0.self_attention.in_proj_weight"
ALL_OPS = (band, flash, fused, tile)


def phase_pretrained_fixture(tmp: str) -> dict:
    """The vit_b_16 fixture written by the port's writer into
    ``tmp/pretrained_weights``, where E3 and E5 look for it; returns it as
    read back."""
    from focused_attention_vit_tpu_torch.data.pretrained import write_fixture

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = write_fixture(os.path.join(tmp, "pretrained_weights"))
    seconds = time.perf_counter() - t0
    log("pretrained-fixture", f"{out.getvalue().strip()}; "
                              f"{os.path.getsize(path)} bytes in "
                              f"{seconds:.1f} s (host clock)")
    return torch.load(path, weights_only=True)


def _pretrained_cli(tmp: str, name: str, model_cls, csv_name: str,
                    columns: list, extra=()):
    """E3 or E5 through ``cli.main`` at ViT-B/16, batch 128, bf16, one
    epoch, with ``./pretrained_weights`` the fixture. Checks that the
    checkpoint loaded and merged (every tensor but the 10-class head), the
    CSV's columns and its parameter counts against the model's; returns the
    experiment, the passes, the seconds, the CSV row and the model's state
    dict as loaded."""
    from focused_attention_vit_tpu_torch.experiments.pretrained_common import (
        PretrainedMixin,
    )

    loaded = {}
    real = PretrainedMixin.build_params

    def spy(self, model):
        real(self, model)
        loaded.update({k: v.detach().clone()
                       for k, v in model.state_dict().items()})

    results = os.path.join(tmp, f"results-{name}-{len(extra)}")
    with mock.patch.object(PretrainedMixin, "build_params", spy):
        e, passes, seconds = _cli_run(
            tmp, ["--experiment", name, *PRETRAINED_ARGS, *extra], model_cls,
            results)
    row = _csv_row(os.path.join(results, csv_name), columns)
    _check_run(e, row, 1, name)
    n = len(loaded)
    if not e.pretrained_loaded or e.merge_counts != {"copied": n - 2,
                                                     "skipped": 0}:
        raise AssertionError(f"{name}: pretrained_loaded "
                             f"{e.pretrained_loaded}, merge {e.merge_counts}"
                             f" of {n} tensors (expected all but the head)")
    total = sum(p.numel() for p in e.model.parameters())
    trainable = sum(p.numel() for p in e.model.parameters()
                    if p.requires_grad)
    counts = tuple(int(row[k]) for k in ("total_parameters",
                                         "trainable_parameters",
                                         "frozen_parameters"))
    if counts != (total, trainable, total - trainable):
        raise AssertionError(f"{name} CSV parameter counts {counts} != the "
                             f"model's {(total, trainable)}")
    return e, passes, seconds, row, loaded


def _check_loaded(loaded: dict, fixture: dict, what: str) -> None:
    got = loaded["blocks.0.attn.qkv.weight"].cpu()
    if not torch.equal(got, fixture[FIXTURE_QKV].float()):
        raise AssertionError(f"{what}: blocks.0.attn.qkv.weight is not the "
                             f"fixture's upcast {FIXTURE_QKV}")


def _op_counts() -> dict:
    return {op.__name__.rsplit(".", 1)[1]: {
        k: op.launch_count(k) for k in op.LAUNCH_KINDS} for op in ALL_OPS}


def _reset_ops() -> None:
    for op in ALL_OPS:
        op.reset_launch_count()


def _log_run(phase, label, e, passes, seconds, row, launches) -> None:
    log(phase, f"{label}: cli.main, 1 epoch of {len(e.data['train_images'])}"
               f" train and {len(e.data['test_labels'])} test images in "
               f"{seconds:.1f} s; pretrained_loaded {e.pretrained_loaded}, "
               f"merge {e.merge_counts}; parameters total "
               f"{row['total_parameters']}, trainable "
               f"{row['trainable_parameters']}; forward passes {passes}; "
               f"launches {launches}; CSV test_loss "
               f"{float(row['test_loss']):.4f}, peak_gpu_memory_mb "
               f"{float(row['peak_gpu_memory_mb']):.1f}")


def _log_step(phase, label, timings) -> None:
    """Step times of one experiment path: microbatch 0 first."""
    (ms, peak), *rest = timings.values()
    log(phase, f"{label}: ViT-B/16 train step, bf16 autocast, batch "
               f"{E1_BATCH}: {ms:.2f} ms per step, "
               f"{E1_BATCH / ms * 1e3:.1f} images/s (host clock, mean of 5 "
               f"steps after a warm-up), peak memory {peak:.2f} GiB "
               f"(max_memory_allocated)")
    if rest:
        log(phase, f"{label}, microbatch 0 / 64 / 32 / 16: " + " / ".join(
            f"{m:.2f} ms, {p:.2f} GiB" for m, p in timings.values()))


def phase_e3(tmp: str, fixture: dict) -> dict:
    """E3 ``traditional_pretrained`` through the CLI with the fused switch
    on: the fixture loaded, the CSV, and K3/K4 launched 12 times a pass
    (training passes and the memory probe's backward, eval passes); returns
    the fused launch counts."""
    phase = "e3"
    _reset_ops()
    with _fused_switch(True):
        e, passes, seconds, row, loaded = _pretrained_cli(
            tmp, "traditional_pretrained", VisionTransformer,
            "exp3_pretrained_traditional.csv", E3_COLUMNS)
        launches = _op_counts()
        timings = {None: _step_time(e)}
    _check_loaded(loaded, fixture, "E3")
    _log_run(phase, "switch on", e, passes, seconds, row, launches)
    _log_step(phase, "switch on", timings)
    grads = DEPTH * (passes["train"] + passes["probe"])
    expect = {"fwd": DEPTH * passes["eval"], "fwd_train": grads,
              "bwd": grads}
    others = [c for op, k in launches.items() if op != "mha_kernel"
              for c in k.values()]
    if (launches["mha_kernel"] != expect or any(others)
            or passes["train"] != len(e.data["train_images"]) // E1_BATCH
            or passes["probe"] != 1
            or passes["eval"] == 0):
        raise AssertionError(f"E3: launches {launches}, expected fused "
                             f"{expect} and nothing else; passes {passes}")
    del e, loaded
    torch.cuda.empty_cache()
    return launches["mha_kernel"]


def phase_e5(tmp: str, fixture: dict) -> dict:
    """E5 ``mhla_pretrained`` through the CLI: by default (the dense band at
    S = 197, no kernel), under the tile-band opt-in (K6/K7 12 times a pass)
    and with ``--freeze_layers`` (only the head and the latent projections
    train); the step time at microbatch 0, 64, 32 and 16 on both paths.
    Returns the tile launch counts."""
    phase = "e5"
    out = {}
    for label, env, extra in (("dense band", {}, ()),
                              ("tile band", TILE_ENV, ()),
                              ("dense band, --freeze_layers", {},
                               ("--freeze_layers",))):
        _reset_ops()
        with _environ(env):
            e, passes, seconds, row, loaded = _pretrained_cli(
                tmp, "mhla_pretrained", VisionTransformerMHLA,
                "exp4_pretrained_mhla.csv", E5_COLUMNS, extra)
            launches = _op_counts()
            timings = {None: _step_time(e)}
            if not extra:
                timings.update({mb: _step_time(e, mb) for mb in (64, 32, 16)})
        _check_loaded(loaded, fixture, f"E5 {label}")
        d = e.embed_dim // e.num_heads
        for i in range(e.depth):
            w = loaded[f"blocks.{i}.attn.latent_proj.weight"]
            if not (torch.equal(w, torch.eye(d, device=w.device)) and not
                    loaded[f"blocks.{i}.attn.latent_proj.bias"].any()):
                raise AssertionError(f"E5: block {i}'s latent_proj is not "
                                     f"the identity at load time")
        _log_run(phase, label, e, passes, seconds, row, launches)
        _log_step(phase, label, timings)
        if extra:
            _check_frozen(e, loaded)
        tile_counts = launches["mhla_kernel_v4"]
        grads = DEPTH * (passes["train"] + passes["probe"])
        expect = {"fwd": grads + DEPTH * passes["eval"], "bwd": grads,
                  "fwd_b": 0} if env else dict.fromkeys(tile.LAUNCH_KINDS, 0)
        others = [c for op, k in launches.items() if op != "mhla_kernel_v4"
                  for c in k.values()]
        if tile_counts != expect or any(others) or passes["eval"] == 0:
            raise AssertionError(f"E5 {label}: launches {launches}, expected "
                                 f"tile band {expect} and nothing else; "
                                 f"passes {passes}")
        if env:
            out = tile_counts
        del e, loaded
        torch.cuda.empty_cache()
    return out


def _check_frozen(e, loaded: dict) -> None:
    """After the frozen run only the head and the latent projections have
    moved from the loaded weights, and one more step moves only them;
    ``trainable_parameters`` counts the head and the latent projections."""
    d = e.embed_dim // e.num_heads
    head, latent = e.embed_dim * 10 + 10, e.depth * (d * d + d)

    def moved(before):
        return sorted(n for n, p in e.model.named_parameters()
                      if not torch.equal(p.detach(), before[n]))

    want = sorted(n for n, _ in e.model.named_parameters()
                  if n.startswith("head.") or "latent_proj" in n)
    before = {n: p.detach().clone() for n, p in e.model.named_parameters()}
    rng = np.random.default_rng(9)
    e.train_step(e.state, _images(rng, E1_BATCH),
                 rng.integers(0, 10, size=E1_BATCH), 1000)
    torch.cuda.synchronize()
    after_run, after_step = moved(loaded), moved(before)
    log("e5", f"--freeze_layers: trainable_parameters "
              f"{e.param_counts['trainable_params']} (head {head} + "
              f"{e.depth} x ({d}*{d} + {d})); moved over the run "
              f"{len(after_run)} tensors, over one more step "
              f"{len(after_step)}, all head or latent_proj: "
              f"{after_run == after_step == want}")
    if (e.param_counts["trainable_params"] != head + latent
            or after_run != want or after_step != want):
        raise AssertionError(f"E5 --freeze_layers: trainable "
                             f"{e.param_counts}, moved {after_run} / "
                             f"{after_step}, expected {want}")


# PretrainedViTWithMHLA at its defaults: patch 4 (S = 3137) and W = 4, an
# even window, through the S-minor band (K1/K2).
PMHLA = ModelPath("pretrained-mhla-", "PretrainedViTWithMHLA B/4 W=4",
                  PretrainedViTWithMHLA, None, band, "band", idle_ops=(tile,))


def phase_pretrained_mhla(image: np.ndarray) -> int:
    """``PretrainedViTWithMHLA`` at full width and its defaults: the f32
    forward against the CPU (phase_model), the bf16 serving forward at
    batch 32 against the f32 CPU probabilities with K1 launched once a
    block, timed; then a 2-block f32 train step against the CPU
    (phase_train_parity). Returns the bf16 forward's K1 launches."""
    phase = "pretrained-mhla"
    cpu_model = PMHLA.build(generator=torch.Generator().manual_seed(0)).eval()
    if cpu_model.window_size != 4 or cpu_model.blocks[0].attn.window_size != 4:
        raise AssertionError("PretrainedViTWithMHLA's default window is not 4")
    ref_probs = phase_model(PMHLA, cpu_model, image)
    model = copy.deepcopy(cpu_model).to("cuda", torch.bfloat16).eval()
    del cpu_model
    rng = np.random.default_rng(12)
    u8 = torch.from_numpy(np.concatenate([image, _images(rng, 31)]))
    x = prepare_eval_batch(u8.to("cuda"), 224).to(torch.bfloat16)
    forwards = [0]
    hook = model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    PMHLA.reset_counts()
    with torch.inference_mode():
        probs = torch.softmax(model(x).float(), -1).cpu().numpy()
        ms = cuda_median_ms(lambda: model(x), repeats=10, warmup=2)
    torch.cuda.synchronize()
    hook.remove()
    launches = band.launch_count()
    PMHLA.check_idle(phase)
    _check_probs(probs, 32)
    dp = float(np.abs(probs[0] - ref_probs[0]).max())
    log(phase, f"bf16 forward, batch 32: {ms:.2f} ms (median of 10, CUDA "
               f"events), {32 / ms * 1e3:.1f} images/s; bf16 against the "
               f"f32 CPU model {dp:.3g} (tol 1e-2); forward passes "
               f"{forwards[0]}, K1 launches {launches}")
    if dp > 1e-2:
        raise AssertionError("PretrainedViTWithMHLA bf16 probabilities "
                             "disagree with the f32 reference")
    if launches != DEPTH * forwards[0]:
        raise AssertionError(f"K1 launches {launches} != {DEPTH} x "
                             f"{forwards[0]} forward passes")
    del model
    torch.cuda.empty_cache()
    phase_train_parity(PMHLA)
    return launches


# --- the SPPP family: SLIC, SPPPViT, E2, E4, E6, PretrainedSPPPViTWithMHLA ----

FIXTURES = REPO / "tests" / "fixtures"
SLIC_BATCH = 128  # the E2/E4/E6 training batch
SLIC_ON_BATCH = 8  # the device connectivity pass, the slow mode at 224^2
# B*h, S, d of E6's tile band (ViT-B/16, batch 128): R + 1 = 17 tokens.
E6_TILE_SHAPE = (128 * 12, 17, 64)
# B, h, d, S of PretrainedSPPPViTWithMHLA's S-minor band at batch 32.
PSPPP_BAND_SHAPE = (32, 12, 64, 17)
E2_COLUMNS = E1_COLUMNS[:6] + ["num_superpixels", "traditional_tokens",
                               "sppp_tokens", "token_reduction_factor"] + (
    E1_COLUMNS[6:])
E4_COLUMNS = (E3_COLUMNS[:4] + E2_COLUMNS[1:10] + E3_COLUMNS[9:12]
              + E2_COLUMNS[11:])
E6_COLUMNS = (E3_COLUMNS[:4] + E2_COLUMNS[1:7] + ["window_size"]
              + E2_COLUMNS[7:10] + ["complexity_reduction_ratio"]
              + E3_COLUMNS[9:12] + E2_COLUMNS[11:])


def _golden(name: str):
    fix = np.load(FIXTURES / name)
    return (fix["images"], fix["golden_labels"], int(fix["n_segments"]),
            float(fix["compactness"]), float(fix["sigma"]))


def _sppp_images(n: int) -> np.ndarray:
    """``n`` ImageNet-standardised 224^2 images with structure for SLIC to
    find (random pixels collapse into one superpixel): the six images of
    ``slic_golden_224.npz``, mirrored and shifted at random, seeded."""
    images = _golden("slic_golden_224.npz")[0]
    rng = np.random.default_rng(14)
    return np.stack([
        np.roll(images[i][:, ::rng.choice([1, -1])],
                int(rng.integers(0, 224)), axis=1)
        for i in [0, 1, *rng.integers(0, len(images), n)][:n]]).copy()


def _dominant_agreement(a: np.ndarray, b: np.ndarray, patch: int) -> float:
    """Share of patches whose dominant superpixels agree under the best
    one-to-one matching of the two label sets (tests/test_ops.py's
    measure)."""
    from scipy.optimize import linear_sum_assignment

    da, db = (segment_pool.dominant_superpixel_per_patch(
        torch.from_numpy(x), patch, int(x.max()) + 1).numpy() for x in (a, b))
    n = int(max(da.max(), db.max())) + 1
    cont = np.zeros((n, n))
    np.add.at(cont, (da, db), 1)
    ri, ci = linear_sum_assignment(-cont)
    return float(cont[ri, ci].sum() / da.size)


def _host_ms(fn, repeats: int) -> float:
    """Median host-clock ms of ``fn()``, each call ended by a device
    sync."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_slic() -> dict:
    """SLIC on the card against the numpy oracle and the committed
    skimage-faithful goldens, then its time at 224^2 by connectivity mode;
    returns the times."""
    from tools.slic_numpy import slic_numpy

    phase = "slic"
    images, golden, r, m, sigma = _golden("slic_golden.npz")
    x = torch.from_numpy(images).cuda()
    off = slic.slic_segment(x, r, m, sigma, enforce_connectivity=False)
    oracle = np.stack([slic_numpy(im, n_segments=r, compactness=m,
                                  sigma=sigma, enforce_connectivity=False)
                       for im in images])
    share = float((off.cpu().numpy() == oracle).mean())
    dev = slic.slic_segment(x, r, m, sigma, enforce_connectivity=True)
    scores = [_dominant_agreement(golden[i], dev[i].cpu().numpy(), 4)
              for i in range(len(images))]
    log(phase, f"32^2 golden ({len(images)} images, R={r}): connectivity-off "
               f"core equal to the numpy oracle on {share:.6f} of the "
               f"pixels; device connectivity pass, patch-dominant agreement "
               f"with the golden mean {np.mean(scores):.4f} (>= 0.72), min "
               f"{np.min(scores):.4f} (>= 0.60)")
    if np.mean(scores) < 0.72 or np.min(scores) < 0.60:
        raise AssertionError(f"SLIC's device pass disagrees with the 32^2 "
                             f"golden: {scores}")

    images, golden, r, m, sigma = _golden("slic_golden_224.npz")
    x = torch.from_numpy(images).cuda()
    host = slic.slic_segment(x, r, m, sigma, enforce_connectivity="host")
    host = host.cpu().numpy()
    scores = [_dominant_agreement(golden[i], host[i], 16)
              for i in range(len(images))]
    pixels0 = float((host[0] == golden[0]).mean())
    log(phase, f"224^2 golden ({len(images)} images): host connectivity, "
               f"patch-dominant agreement (patch 16) mean "
               f"{np.mean(scores):.4f} (>= 0.97); image 0 equal to the golden "
               f"on {pixels0:.4f} of its pixels (>= 0.98)")
    if np.mean(scores) < 0.97 or pixels0 < 0.98:
        raise AssertionError(f"SLIC's host path disagrees with the 224^2 "
                             f"golden: {scores}, image 0 {pixels0}")

    # A training batch of ImageNet-standardised images, under the train
    # step's bf16 autocast.
    x = torch.from_numpy(_sppp_images(SLIC_BATCH)).cuda()
    times = {}
    with torch.autocast("cuda", dtype=torch.bfloat16):
        for mode, n, reps in (("off", SLIC_BATCH, 10),
                              ("host", SLIC_BATCH, 10),
                              ("on", SLIC_ON_BATCH, 3)):
            conn = {"off": False, "on": True}.get(mode, mode)
            xs = x[:n]
            times[mode] = cuda_median_ms(
                lambda: slic.slic_segment(xs, r, m, sigma,
                                          enforce_connectivity=conn),
                repeats=reps, warmup=1)
            log(phase, f"224^2, batch {n}, connectivity {mode}: "
                       f"{times[mode]:.2f} ms a batch (median of {reps}, "
                       f"CUDA events), {times[mode] / n:.3f} ms an image")
        labels = slic.slic_segment(x, r, m, sigma, enforce_connectivity=False)
    min_size = int(round(slic.MIN_SIZE_FACTOR * 224 * 224 / r))
    host_labels = labels.to("cpu", torch.int32).numpy()
    split = {
        "d2h": _host_ms(lambda: labels.to("cpu", torch.int32), 10),
        "cxx": _host_ms(lambda: native_connectivity.enforce_connectivity_host(
            host_labels, min_size, r), 10),
        "h2d": _host_ms(lambda: torch.from_numpy(host_labels).cuda(), 10),
    }
    log(phase, f"host connectivity at batch {SLIC_BATCH}: copy to the host "
               f"{split['d2h']:.2f} ms, C++ ({os.cpu_count()} cores) "
               f"{split['cxx']:.2f} ms, copy back {split['h2d']:.2f} ms "
               f"(medians of 10, host clock); k-means and blur "
               f"{times['off']:.2f} ms")
    times["host_split"] = split
    return times


def phase_sppp_model() -> None:
    """SPPPViT at ViT-B/16 width in f32 on the card against the same weights
    on the CPU, on two structured images: the dominant-superpixel ids
    first, then the logits."""
    phase = "sppp-model"
    cpu_model = SPPPViT(img_size=224, patch_size=16, num_classes=10,
                        generator=torch.Generator().manual_seed(0)).eval()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(_sppp_images(2))
    ids = {}
    for dev, xx in (("cpu", x), ("cuda", x.cuda())):
        seg = slic.slic_segment(xx, 16)  # auto: the host pass at 224^2
        ids[dev] = segment_pool.dominant_superpixel_per_patch(
            seg, 16, 16).cpu()
    same = bool(torch.equal(ids["cpu"], ids["cuda"]))
    with torch.inference_mode():
        ref = cpu_model(x)
        got = gpu_model(x.cuda()).cpu()
    dl = float((got - ref).abs().max())
    dp = float((torch.softmax(got, -1) - torch.softmax(ref, -1)).abs().max())
    log(phase, f"SPPPViT-B/16 f32 batch 2, card vs CPU: dominant-superpixel "
               f"ids equal {same} ({[len(torch.unique(i)) for i in ids['cpu']]}"
               f" distinct an image); "
               f"max |d logits| {dl:.3g} (tol 1e-3), max |d probs| {dp:.3g} "
               f"(tol 1e-4)")
    if not same:
        raise AssertionError("SLIC's superpixels on the card differ from the "
                             "CPU's")
    if not (dl <= 1e-3 and dp <= 1e-4):
        raise AssertionError("SPPPViT on the card disagrees with the CPU")


def _sppp_cli(tmp: str, name: str, model_cls, csv_name: str, columns: list):
    """E2 (no checkpoint) or E4/E6 (the fixture) through ``cli.main`` at
    ViT-B/16, batch 128, bf16, one epoch; returns the experiment, passes,
    seconds, CSV row and the state dict as loaded (None for E2)."""
    if name != "sppp":
        return _pretrained_cli(tmp, name, model_cls, csv_name, columns)
    results = os.path.join(tmp, "results-sppp")
    e, passes, seconds = _cli_run(tmp, ["--experiment", name,
                                        *PRETRAINED_ARGS], model_cls, results)
    row = _csv_row(os.path.join(results, csv_name), columns)
    _check_run(e, row, 1, name)
    return e, passes, seconds, row, None


def phase_sppp_experiments(tmp: str, fixture: dict) -> dict:
    """E2 ``sppp``, E4 ``sppp_pretrained`` and E6 ``sppp_mhla_pretrained``
    through the CLI at the CLI's SPPP defaults (R = 16, mean pooling,
    compactness 0.1, 10 iterations, ``auto`` connectivity: the host pass at
    224^2), then E6 under the tile-band opt-in, where K6/K7 are first held
    against their plain versions at E6's shape. Each: the CSV in JAX's
    columns, the checkpoint loaded (E4, E6), the launches, ms per step,
    images/s, peak memory and SLIC's share of the step. Returns E6's tile
    launches."""
    from focused_attention_vit_tpu_torch.utils import step_profile

    gen = torch.Generator(device="cuda").manual_seed(17)
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        res = _tile_compare(*[torch.randn(E6_TILE_SHAPE, device="cuda",
                                          generator=gen).to(dtype)
                              for _ in range(4)], SERVE_W)
        bad = [f"{n} {t}" for n, (_, ok, t) in res.items() if not ok]
        log("e6", f"tile band at E6's shape {E6_TILE_SHAPE} W={SERVE_W} {dt}:"
                  f" max abs err " + ", ".join(
                      f"{n} {t}" for n, (_, _, t) in res.items()))
        if bad:
            raise AssertionError(f"tile band kernels disagree with the plain "
                                 f"versions at E6's shape {dt}: {bad}")

    out = {}
    for phase, name, cls, csv_name, columns, env in (
            ("e2", "sppp", SPPPViT, "exp2_sppp.csv", E2_COLUMNS, {}),
            ("e4", "sppp_pretrained", SPPPViT, "exp3_pretrained_sppp.csv",
             E4_COLUMNS, {}),
            ("e6", "sppp_mhla_pretrained", SPPPViTMHLA,
             "exp5_pretrained_sppp_mhla.csv", E6_COLUMNS, {}),
            ("e6", "sppp_mhla_pretrained", SPPPViTMHLA,
             "exp5_pretrained_sppp_mhla.csv", E6_COLUMNS, TILE_ENV)):
        label = "tile band" if env else "default"
        _reset_ops()
        with _environ(env):
            e, passes, seconds, row, loaded = _sppp_cli(tmp, name, cls,
                                                        csv_name, columns)
            launches = _op_counts()
            # The synthetic CIFAR batch it trained on: SLIC's work depends on
            # the pixels (random ones collapse into one superpixel).
            u8 = e.data["train_images"][:E1_BATCH]
            y = e.data["train_labels"][:E1_BATCH]
            ms, peak = _step_time(e, batch=(u8, y))
            prof = step_profile.profile(
                lambda i: e.train_step(e.state, u8, y, 300 + i), 3)
        if loaded is not None:
            _check_loaded(loaded, fixture, f"{phase} {label}")
            _log_run(phase, label, e, passes, seconds, row, launches)
        else:
            log(phase, f"cli.main, 1 epoch of {len(e.data['train_images'])} "
                       f"train and {len(e.data['test_labels'])} test images "
                       f"in {seconds:.1f} s; forward passes {passes}; "
                       f"launches {launches}; CSV test_loss "
                       f"{float(row['test_loss']):.4f}")
        if name == "sppp_mhla_pretrained":
            d = e.embed_dim // e.num_heads
            for i in range(e.depth):
                if not torch.equal(loaded[f"blocks.{i}.attn.latent_proj."
                                          f"weight"],
                                   torch.eye(d, device="cuda")):
                    raise AssertionError(f"E6: block {i}'s latent_proj is "
                                         f"not the identity at load time")
        share = prof["slic_host_ms"] / prof["wall_ms"]
        log(phase, f"{label}: SPPP-B/16 train step, bf16 autocast, batch "
                   f"{E1_BATCH}: {ms:.2f} ms per step, "
                   f"{E1_BATCH / ms * 1e3:.1f} images/s (host clock, mean of "
                   f"5 steps after a warm-up), peak memory {peak:.2f} GiB "
                   f"(max_memory_allocated); under the profiler "
                   f"{prof['wall_ms']:.2f} ms a step, SLIC's range "
                   f"{prof['slic_host_ms']:.2f} ms of it ({share:.1%}; "
                   f"{prof['slic_device_ms']:.2f} ms of kernels in it), "
                   f"kernels {prof['kernel_ms']:.2f} ms")
        tile_counts = launches["mhla_kernel_v4"]
        grads = DEPTH * (passes["train"] + passes["probe"])
        expect = ({"fwd": grads + DEPTH * passes["eval"], "bwd": grads,
                   "fwd_b": 0} if env else dict.fromkeys(tile.LAUNCH_KINDS, 0))
        others = [c for op, k in launches.items() if op != "mhla_kernel_v4"
                  for c in k.values()]
        if (tile_counts != expect or any(others) or passes["probe"] != 1
                or passes["train"] != len(e.data["train_images"]) // E1_BATCH
                or passes["eval"] == 0):
            raise AssertionError(f"{phase} {label}: launches {launches}, "
                                 f"expected tile band {expect} and nothing "
                                 f"else; passes {passes}")
        if env:
            out = tile_counts
        del e, loaded
        torch.cuda.empty_cache()
    return out


def phase_pretrained_sppp_mhla() -> int:
    """``PretrainedSPPPViTWithMHLA`` at its defaults (patch 4, W = 4, R + 1
    = 17 tokens): K1 against its plain version at the S-minor shape of a
    batch of 32, then the bf16 forward at batch 32 by default (the dense
    band, no kernel) and under ``FAVIT_MHLA_IMPL=roll`` (K1 once a block),
    each against the f32 CPU model; returns the roll forward's K1
    launches."""
    phase = "pretrained-sppp-mhla"
    gen = torch.Generator(device="cuda").manual_seed(18)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(PSPPP_BAND_SHAPE, device="cuda",
                               generator=gen).to(dtype) for _ in range(3))
        got = band.roll_banded_attention(q, k, v, PMHLA_W)
        err, ok, text = _worst(got, band.plain_banded_attention(
            q, k, v, PMHLA_W), dtype, F32_TOL)
        dt = "f32" if dtype == torch.float32 else "bf16"
        log(phase, f"K1 at B,h,d,S={PSPPP_BAND_SHAPE} W={PMHLA_W} {dt}: max "
                   f"abs err {text}")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{PSPPP_BAND_SHAPE} {dt}: {text}")
    cpu_model = PretrainedSPPPViTWithMHLA(
        num_classes=10, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_sppp_images(32))  # f32: SLIC reads f32
    with torch.inference_mode():
        ref = torch.softmax(cpu_model(x[:1]), -1).numpy()
    model = copy.deepcopy(cpu_model).to("cuda", torch.bfloat16).eval()
    del cpu_model
    x = x.cuda()
    forwards = [0]
    hook = model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    launches = 0
    for label, env in (("dense band", {}), ("roll", {"FAVIT_MHLA_IMPL":
                                                     "roll"})):
        _reset_ops()
        forwards[0] = 0
        with _environ(env), torch.inference_mode():
            probs = torch.softmax(model(x).float(), -1).cpu().numpy()
            ms = cuda_median_ms(lambda: model(x), repeats=10, warmup=2)
        torch.cuda.synchronize()
        counts = _op_counts()
        _check_probs(probs, 32)
        dp = float(np.abs(probs[0] - ref[0]).max())
        k1 = band.launch_count("fwd")
        log(phase, f"{label}: bf16 forward, batch 32: {ms:.2f} ms (median of "
                   f"10, CUDA events, SLIC included), {32 / ms * 1e3:.1f} "
                   f"images/s; bf16 against the f32 CPU model {dp:.3g} (tol "
                   f"1e-2); forward passes {forwards[0]}, launches {counts}")
        others = [c for op, kinds in counts.items() for kk, c in kinds.items()
                  if env == {} or (op, kk) != ("mhla_band_roll", "fwd")]
        if dp > 1e-2 or any(others):
            raise AssertionError(f"PretrainedSPPPViTWithMHLA {label}: probs "
                                 f"{dp}, unexpected launches {counts}")
        if env and k1 != DEPTH * forwards[0]:
            raise AssertionError(f"K1 launches {k1} != {DEPTH} x "
                                 f"{forwards[0]} forward passes")
        if env:
            launches = k1
    hook.remove()
    del model
    torch.cuda.empty_cache()
    return launches


# --- checkpoint, resume and preemption; the cross-attention family -------------

def _timed_save(mngr, step: int, state) -> dict:
    """One async save of ``state``: the training thread's hold (host
    clock), the device time of the snapshot's copies (CUDA events around a
    stream kept busy by a sleep, so that the host has queued every copy
    before the first runs), the background pull and write, and the card's
    memory beyond the live state at the peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the stream
    ev0.record()
    t0 = time.perf_counter()
    mngr.save(step, state)
    held_ms = (time.perf_counter() - t0) * 1e3
    ev1.record()
    ev1.synchronize()
    t1 = time.perf_counter()
    mngr.wait_until_finished()
    return dict(mngr.stats, held_ms=held_ms, copy_ms=ev0.elapsed_time(ev1),
                waited_s=time.perf_counter() - t1,
                extra=torch.cuda.max_memory_allocated() - base)


def phase_checkpoint() -> dict:
    """The MHLA-B/4 ``TrainState`` at batch 32 takes one bf16 training step
    through K1's training form and K2 and is saved asynchronously twice
    (clones on the training stream, the pull and the write in the
    background; the first save meets a cold allocator and cold pinned
    memory), restored into a fresh state and held bit for bit (parameters,
    AdamW moments and step counters, step and update count); then one more
    step from each with the same key must give the same bits. Returns the
    band launches of the first step."""
    from focused_attention_vit_tpu_torch.train.checkpoint import (
        CheckpointManager,
        STATE_FILE,
    )

    phase = "checkpoint"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    u8, y = _images(rng, TRAIN_BATCH), rng.integers(0, 10, size=TRAIN_BATCH)
    step = train.make_train_step(224, compute_dtype=torch.bfloat16)

    def fresh(seed):
        return train.create_train_state(MHLA.build(
            dropout=TRAIN_DROPOUT, device="cuda",
            generator=torch.Generator().manual_seed(seed)),
            train.make_adamw(1e-4))

    MHLA.reset_counts()
    state, _ = step(fresh(21), u8, y, 0)
    torch.cuda.synchronize()
    launches = {k: band.launch_count(k) for k in band.LAUNCH_KINDS}
    if launches != MHLA.expected(0, 1):
        raise AssertionError(f"checkpoint: the step launched {launches}, "
                             f"expected {MHLA.expected(0, 1)}")
    MHLA.check_idle(phase)
    with tempfile.TemporaryDirectory() as tmp:
        mngr = CheckpointManager(tmp, async_save=True)
        saves = [_timed_save(mngr, i, state) for i in (1, 2)]
        size = os.path.getsize(os.path.join(tmp, "2", STATE_FILE))
        other = fresh(22)
        t2 = time.perf_counter()
        mngr.restore(other)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t2
    for label, t in zip(("first", "second"), saves):
        log(phase, f"MHLA-B/4 TrainState, bf16 autocast, batch "
                   f"{TRAIN_BATCH}: {label} async save of {t['bytes']} bytes "
                   f"({size} on disk): training thread held "
                   f"{t['held_ms']:.2f} ms (host clock), the snapshot's "
                   f"copies {t['copy_ms']:.3f} ms of the card (CUDA events), "
                   f"background pull to pinned memory {t['pull_s']:.3f} s and "
                   f"write {t['write_s']:.3f} s (host clock; "
                   f"{t['waited_s']:.3f} s waited for them here), extra peak "
                   f"memory {t['extra'] / 2**30:.2f} GiB")
    mismatch = [k for k, v in state.model.state_dict().items()
                if not torch.equal(v, other.model.state_dict()[k])]
    opt_a, opt_b = (s.tx.adamw.state_dict()["state"] for s in (state, other))
    mismatch += [f"adamw {i} {n}" for i, s in opt_a.items()
                 for n, t in s.items() if not torch.equal(t, opt_b[i][n])]
    if mismatch or (state.step, state.tx.count) != (other.step,
                                                    other.tx.count):
        raise AssertionError(f"checkpoint: restore is not bit-equal: "
                             f"{mismatch[:5]}, steps {state.step} "
                             f"{other.step}")
    a, _ = step(state, u8, y, 1)
    b, _ = step(other, u8, y, 1)
    torch.cuda.synchronize()
    b_params = dict(b.model.named_parameters())
    diff = [n for n, p in a.model.named_parameters()
            if not torch.equal(p, b_params[n])]
    log(phase, f"restore into a fresh state {restore_s:.3f} s (host clock); "
               f"parameters, AdamW moments, step counters and step "
               f"bit-equal; one more step from each with the same key: "
               f"{len(diff)} parameters differ; band launches {launches}")
    if diff:
        raise AssertionError(f"checkpoint: the step after restore differs "
                             f"in {diff[:5]}")
    del state, other, a, b, b_params
    torch.cuda.empty_cache()
    log(phase, f"{time.perf_counter() - t_phase:.1f} s")
    return launches


E1_ARGS = ["--experiment", "traditional", "--img_size", "224", "--patch_size",
           "16", "--batch_size", str(E1_BATCH), "--attn_dropout",
           str(TRAIN_DROPOUT), "--compute_dtype", "bfloat16",
           "--subset_size", "1024"]


def phase_preempt(tmp: str):
    """E1 at ViT-B/16, batch 128, with ``FAVIT_FUSED_MHA=1`` and
    ``--checkpoint_dir`` in a child process (signals reach the main thread
    only), SIGTERM after its ``Epoch 1/`` line: exit code 143, the
    ``Preempted`` line, a committed checkpoint and no CSV. Then the command
    again in this process to one epoch past the checkpoint: ``Resumed from
    checkpoint epoch``, the CSV, and K3/K4 launched 12 times a pass.
    Returns the fused launches, the checkpoint directory and the
    experiment."""
    import signal
    import sys
    import threading

    phase = "preempt"
    t_phase = time.perf_counter()
    ckpt = os.path.join(tmp, "e1-ckpt")
    results = os.path.join(tmp, "results-preempt")
    argv = E1_ARGS + ["--epochs", "2", "--checkpoint_dir", ckpt]
    env = dict(os.environ, FAVIT_FUSED_MHA="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    torch.cuda.empty_cache()
    child = subprocess.Popen(
        [sys.executable, "-u", "-m", "focused_attention_vit_tpu_torch.cli",
         *argv, "--data_dir", os.path.join(tmp, "no-cifar"),
         "--results_dir", results], cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(300, child.kill)
    timer.start()
    lines, sent = [], None
    try:
        for line in child.stdout:
            lines.append(line)
            if line.startswith("Epoch 1/") and sent is None:
                child.send_signal(signal.SIGTERM)
                sent = time.perf_counter()
        rc = child.wait()
    finally:
        timer.cancel()
    out = "".join(lines)
    stop = [ln for ln in lines if ln.startswith("Preempted")]
    if (rc != 143 or not stop or sent is None
            or os.path.exists(os.path.join(results, "exp1_traditional.csv"))):
        raise AssertionError(f"preempt: child exit code {rc} (expected "
                             f"143), Preempted line {stop}, CSV present; "
                             f"output tail:\n{out[-3000:]}")
    from focused_attention_vit_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    done = CheckpointManager(ckpt).latest_step()
    log(phase, f"child: SIGTERM after 'Epoch 1/', exit code {rc} "
               f"{time.perf_counter() - sent:.1f} s later; "
               f"{stop[0].strip()}; committed epoch {done}; no CSV")

    _reset_ops()
    buf = io.StringIO()
    argv[argv.index("--epochs") + 1] = str(done + 1)
    with _fused_switch(True), contextlib.redirect_stdout(buf):
        e, passes, seconds = _cli_run(tmp, argv, VisionTransformer, results)
    launches = _op_counts()
    printed = buf.getvalue()
    resumed = [ln for ln in printed.splitlines()
               if ln.startswith("Resumed from checkpoint epoch")]
    row = _csv_row(os.path.join(results, "exp1_traditional.csv"), E1_COLUMNS)
    _check_run(e, row, 1, "E1 resumed")
    grads = DEPTH * (passes["train"] + passes["probe"])
    expect = {"fwd": DEPTH * passes["eval"], "fwd_train": grads,
              "bwd": grads}
    others = [c for op, k in launches.items() if op != "mha_kernel"
              for c in k.values()]
    log(phase, f"rerun in process to --epochs {done + 1}: {resumed}; "
               f"{seconds:.1f} s; forward passes {passes}; launches "
               f"{launches}; CSV test_loss {float(row['test_loss']):.4f}; "
               f"checkpoint epoch {CheckpointManager(ckpt).latest_step()}")
    if (resumed != [f"Resumed from checkpoint epoch {done}"]
            or launches["mha_kernel"] != expect or any(others)
            or min(expect.values()) == 0 or e.preempted):
        raise AssertionError(f"preempt: resumed {resumed}, fused launches "
                             f"{launches['mha_kernel']} != {expect}, others "
                             f"{others}")
    log(phase, f"{time.perf_counter() - t_phase:.1f} s")
    return launches["mha_kernel"], ckpt, e


def phase_serve_checkpoint(ckpt: str, e) -> None:
    """``serve --checkpoint_dir`` on the directory the preempt phase left:
    the sidecar of its last epoch is the resumed run's final model, so the
    served probabilities (f32) equal that model's eval forward on the same
    images."""
    phase = "serve-checkpoint"
    t0 = time.perf_counter()
    args, pred = serve.setup([
        "--checkpoint_dir", ckpt, "--model", "vit", "--patch_size", "16",
        "--compute_dtype", "float32", "--batch_size", "32"])
    load_s = time.perf_counter() - t0
    images = _images(np.random.default_rng(12), 40)
    probs = pred.predict_proba(images)
    model = e.state.model.eval()
    with torch.inference_mode():
        want = torch.softmax(model(prepare_eval_batch(
            torch.from_numpy(images).cuda(), 224)).float(), -1).cpu().numpy()
    _check_probs(probs, 40)
    err = float(np.abs(probs - want).max())
    log(phase, f"serve.setup(--checkpoint_dir, --model vit, f32, batch 32) "
               f"in {load_s:.2f} s (host clock: the sidecar of "
               f"{os.path.getsize(os.path.join(ckpt, 'params_latest.pt'))} "
               f"bytes read and the warm-up batch); 40 images against the "
               f"resumed run's model: max abs err {err:.3g} (tol 1e-6)")
    if err > 1e-6:
        raise AssertionError(f"serve --checkpoint_dir disagrees with the "
                             f"trained model: {err}")
    del pred
    torch.cuda.empty_cache()
    log(phase, f"{time.perf_counter() - t0:.1f} s")


def _slic_share(e, u8, y, n: int = 3):
    """(ms a step, ms of SLIC in it) of an SPPP experiment's train step, by
    host clock with a device sync on both sides of each SLIC call."""
    from focused_attention_vit_tpu_torch.models import sppp_common

    spent = []
    real = sppp_common.slic_segment

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    with mock.patch.object(sppp_common, "slic_segment", timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            e.train_step(e.state, u8, y, 300 + i)
        torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / n * 1e3, sum(spent) / n * 1e3)


E7_COLUMNS = [
    "model", "use_pretrained", "pretrained_source", "pretrained_model_variant",
    "freeze_layers", "img_size", "patch_size", "embed_dim", "depth",
    "num_heads", "use_multi_head", "total_parameters",
    "trainable_parameters", "frozen_parameters", "flops", "time_complexity",
    "space_complexity_mb", "model_size_mb", "avg_epoch_time",
    "total_training_time", "final_val_acc", "final_val_loss", "test_acc",
    "test_loss", "avg_inference_time_per_image", "peak_gpu_memory_mb",
]
E7_SPPP_COLUMNS = E7_COLUMNS + ["num_superpixels", "traditional_tokens",
                                "sppp_tokens", "token_reduction_factor"]


def phase_e7_e8(tmp: str) -> None:
    """E7 ``cross_attention`` and E8 ``multihead_cross_attention`` through
    ``cli.main`` at ViT-B/16, batch 128, bf16, one epoch each of 4A-4D and
    5A-5D (C and D from the fixture in ``tmp/pretrained_weights``): the
    eight CSVs under JAX's names and columns, the pretrained runs' merge,
    no kernel launched (the cross-attention is plain ``torch.matmul``, as
    JAX's einsums); ms a step and peak memory of each, and SLIC's share of
    the SPPP rows' step."""
    from focused_attention_vit_tpu_torch.experiments import attention

    from focused_attention_vit_tpu_torch.experiments import base

    phase = "e7-e8"
    t_phase = time.perf_counter()
    results = os.path.join(tmp, "results-e7e8")
    # The eight runs cut the same subset from the synthetic stand-in, which
    # takes seconds to build: build it once.
    data = {}
    real_load = base.load_dataset

    def load(name, data_dir, subset_size, seed):
        if not data:
            data.update(real_load(name, data_dir=data_dir,
                                  subset_size=subset_size, seed=seed))
        return dict(data)

    for name in ("cross_attention", "multihead_cross_attention"):
        runs = []
        real = attention.CrossAttentionExperiment.run
        _reset_ops()
        with mock.patch.object(attention.CrossAttentionExperiment, "run",
                               lambda self: (runs.append(self),
                                             real(self))[1]), \
                mock.patch.object(base, "load_dataset", load):
            e, passes, seconds = _cli_run(
                tmp, ["--experiment", name, *PRETRAINED_ARGS],
                None, results)
        launches = _op_counts()
        if e is not None or len(runs) != 4 or any(
                c for k in launches.values() for c in k.values()):
            raise AssertionError(f"{name}: returned {e}, {len(runs)} runs, "
                                 f"launches {launches}")
        for r in runs:
            if not r.data["synthetic"]:
                raise AssertionError("expected the synthetic CIFAR stand-in")
            cols = E7_SPPP_COLUMNS if r.use_sppp else E7_COLUMNS
            row = _csv_row(os.path.join(results, r.csv_filename), cols)
            _check_run(r, row, 1, r.csv_filename)
            n = len(r.model.state_dict())
            if r.use_pretrained and (not r.pretrained_loaded or r.merge_counts
                                     != {"copied": n - 2, "skipped": 0}):
                raise AssertionError(f"{r.csv_filename}: merge "
                                     f"{r.merge_counts} of {n} tensors")
            u8 = r.data["train_images"][:E1_BATCH]
            y = r.data["train_labels"][:E1_BATCH]
            ms, peak = _step_time(r, batch=(u8, y))
            share = ""
            if r.use_sppp:
                step_ms, slic_ms = _slic_share(r, u8, y)
                share = (f"; with a device sync around SLIC, {step_ms:.2f} ms "
                         f"a step, SLIC {slic_ms:.2f} ms of it "
                         f"({slic_ms / step_ms:.1%}, host clock, 3 steps)")
            log(phase, f"{r.csv_filename}: {r.model_display_name}, merge "
                       f"{r.merge_counts}, test_loss "
                       f"{float(row['test_loss']):.4f}; train step, bf16 "
                       f"autocast, batch {E1_BATCH}: {ms:.2f} ms, "
                       f"{E1_BATCH / ms * 1e3:.1f} images/s (host clock, "
                       f"mean of 5 steps after a warm-up), peak memory "
                       f"{peak:.2f} GiB{share}")
        log(phase, f"{name}: cli.main ran 4 experiments in {seconds:.1f} s, "
                   f"launches {launches}")
        del runs, r
        torch.cuda.empty_cache()
    names = sorted(f for f in os.listdir(results) if f.endswith(".csv"))
    want = sorted(f"exp{n}_{t}{p}_{m}.csv"
                  for n, t in ((4, "cross_attention"),
                               (5, "multihead_cross_attention"))
                  for p in ("", "_pretrained") for m in ("traditional",
                                                          "sppp"))
    if names != want:
        raise AssertionError(f"E7/E8 CSVs {names} != {want}")
    log(phase, f"8 CSVs with JAX's names and columns; "
               f"{time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    name = phase_device()
    phase_build()
    timing = phase_kernel()
    train_timing = phase_kernel_train()

    rng = np.random.default_rng(0)
    image = _images(rng, 1)
    launches, train_launches = {}, {}
    for path, attn_dropout_launches in ((MHLA, True), (DENSE, False)):
        if path is DENSE:
            flash_timing = phase_kernel_flash()
        cpu_model = path.build(
            generator=torch.Generator().manual_seed(0)).eval()
        ref_probs = phase_model(path, cpu_model, image)
        torch.cuda.empty_cache()
        launches[path] = phase_serve(path, cpu_model, image, ref_probs)
        del cpu_model
        torch.cuda.empty_cache()
        phase_train_parity(path)
        train_launches[path] = phase_train(path, attn_dropout_launches)
        torch.cuda.empty_cache()

    fused_timing = phase_kernel_fused()
    e1_launches = phase_e1()
    phase_e1_parity()

    # The fixture's directory lives until the checkpoint phases have run.
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    fixture = phase_pretrained_fixture(tmp)
    e3_launches = phase_e3(tmp, fixture)
    e5_launches = phase_e5(tmp, fixture)
    pmhla_launches = phase_pretrained_mhla(image)
    phase_slic()
    phase_sppp_model()
    e6_launches = phase_sppp_experiments(tmp, fixture)
    del fixture
    psppp_launches = phase_pretrained_sppp_mhla()

    tile_timing = phase_kernel_tileband()
    with _environ(TILE.env):
        cpu_model = TILE.build(
            generator=torch.Generator().manual_seed(0)).eval()
        ref_probs = phase_model(TILE, cpu_model, image)
        torch.cuda.empty_cache()
        launches[TILE] = phase_serve(TILE, cpu_model, image, ref_probs)
        del cpu_model
        launches[TILE] += phase_tile_serve_b16()
        torch.cuda.empty_cache()
        phase_train_parity(TILE)
        train_launches[TILE] = phase_train(TILE, False)
        torch.cuda.empty_cache()

    # Checkpoint, resume and preemption, and the cross-attention suites:
    # last, and without the profiler, whose later sessions in one process
    # record fewer and fewer launches (profile_device_ms).
    phase_e7_e8(tmp)
    preempt_launches, ckpt, resumed = phase_preempt(tmp)
    phase_serve_checkpoint(ckpt, resumed)
    del resumed
    tmp_dir.cleanup()
    ckpt_launches = phase_checkpoint()

    tpu = "focused_attention_vit_tpu/ops/mhla_band_roll.py"
    tpu_flash = "focused_attention_vit_tpu/ops/flash_attention_pallas.py"
    tpu_fused = "focused_attention_vit_tpu/ops/mha_kernel.py"
    tpu_tile = "focused_attention_vit_tpu/ops/mhla_kernel_v4.py"
    kernels = [
        # K1 also serves PretrainedViTWithMHLA (S = 3137) and, under
        # FAVIT_MHLA_IMPL=roll, PretrainedSPPPViTWithMHLA (S = 17), at W = 4.
        ("mhla_band_fwd", band.KERNEL_SOURCE, f"{tpu}:158",
         launches[MHLA] + pmhla_launches + psppp_launches, timing["bf16"]),
        # K1's training form and K2 also run in the checkpoint phase's steps.
        ("mhla_band_fwd_train", band.KERNEL_SOURCE, f"{tpu}:158",
         train_launches[MHLA]["fwd_train"] + ckpt_launches["fwd_train"],
         train_timing["bf16"]["fwd_train"]),
        ("mhla_band_bwd", band.BWD_KERNEL_SOURCE, f"{tpu}:199",
         train_launches[MHLA]["bwd"] + ckpt_launches["bwd"],
         train_timing["bf16"]["bwd"]),
        ("flash_attention_fwd", flash.FWD_KERNEL_SOURCE, f"{tpu_flash}:73",
         launches[DENSE], flash_timing["bf16"]["fwd"]),
        ("flash_attention_fwd_train", flash.FWD_KERNEL_SOURCE,
         f"{tpu_flash}:73", train_launches[DENSE]["fwd_train"],
         flash_timing["bf16"]["fwd_train"]),
        ("flash_attention_bwd", flash.BWD_KERNEL_SOURCE, f"{tpu_flash}:73",
         train_launches[DENSE]["bwd"], flash_timing["bf16"]["bwd"]),
        # K3/K4 run in E1, E3 and E1 resumed after preemption, with the
        # fused switch on.
        ("fused_mha_fwd", fused.FWD_KERNEL_SOURCE, f"{tpu_fused}:59",
         e1_launches["fwd"] + e3_launches["fwd"] + preempt_launches["fwd"],
         fused_timing["bf16"]["fwd"]),
        ("fused_mha_fwd_train", fused.FWD_KERNEL_SOURCE, f"{tpu_fused}:59",
         e1_launches["fwd_train"] + e3_launches["fwd_train"]
         + preempt_launches["fwd_train"],
         fused_timing["bf16"]["fwd_train"]),
        ("fused_mha_bwd", fused.BWD_KERNEL_SOURCE, f"{tpu_fused}:83",
         e1_launches["bwd"] + e3_launches["bwd"] + preempt_launches["bwd"],
         fused_timing["bf16"]["bwd"]),
        # K6 runs in serving (MHLA-B/4 and B/16), in training and in E5 and
        # E6 under the opt-in; K8 has no caller on a model path, so its
        # launches are kernel-tileband's.
        ("mhla_tile_band_fwd", tile.KERNEL_SOURCE, f"{tpu_tile}:66",
         launches[TILE] + train_launches[TILE]["fwd"] + e5_launches["fwd"]
         + e6_launches["fwd"], tile_timing["fwd"]),
        ("mhla_tile_band_bwd", tile.BWD_KERNEL_SOURCE, f"{tpu_tile}:104",
         train_launches[TILE]["bwd"] + e5_launches["bwd"]
         + e6_launches["bwd"], tile_timing["bwd"]),
        ("mhla_tile_band_fwd_tiles", tile.KERNEL_SOURCE, f"{tpu_tile}:383",
         tile_timing["fwd_b_launches"], tile_timing["fwd_b"]),
    ]
    for name_, _, _, count, _ in kernels:
        if count <= 0:
            raise AssertionError(f"{name_} was launched no time on its path")
    print(json.dumps({"kernels": [{
        "name": name_,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": count,
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    } for name_, source, replaces, count, t in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
