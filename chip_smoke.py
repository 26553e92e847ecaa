#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Drives the serving path and the training path of
``focused_attention_vit_tpu_torch`` at ViT-H/14 (MHLA at W=7 and W=129 and
dense, 518x518, d=80; through the tile band also at W=257), at MHLA-B/4 and at dense ViT-B/4 (D=768,
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
and checks every CUDA kernel on them. The serving paths are also exported
(``torch.export``) and served from their artifacts, and the training paths
run with remat and a bf16 first moment.
Phases, one or more lines each; any failure raises and exits non-zero:

1. device: requires CUDA and compute capability 9.0; prints the card's name
   and ``nvidia-smi`` name and power limit;
2. build: compiles the eight kernel sources from ``csrc/`` with nvcc, and
   ``native/connectivity.cpp`` and ``native/batcher.cpp`` with g++, in
   parallel, and prints ptxas's registers, spills and shared memory of the
   main path's wgmma kernels (and of K5's and K3/K4's blocks at the tile
   widths 192 and 256, held to no spill) and of every instantiation of the
   band forward (K1) and backward (K2) and of the tile band's forward (K6,
   K8) and backward (K7);
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

Two more phases run inside the sequence above:

34. export, vit-export, tile-export (each right after its serve phase) and
    e1-fused-export (after e1-train-parity, ViT-B/16 with
    ``FAVIT_FUSED_MHA=1``): ``serve --weights W --export_artifact DIR`` at
    full width in bf16, batch 32, then ``serve --from_export DIR``; the
    artifact's probabilities against the live Predictor's on the same
    requests (bit for bit expected, 1e-2 the bound), K1, K5, K6 or K3
    launched 12 x the artifact's forward passes (counted inside the
    ``favit::`` ops), requests through ``BatchingServer`` and one ``POST
    /predict``, and a batch timed from the artifact against the live path
    (CUDA-event medians, in turns);
35. train-flags and vit-train-flags (after train and vit-train): 12 blocks,
    batch 32, bf16 autocast, dropout 0.1 (and attention dropout 0.1 on
    MHLA): the first step with ``remat`` (and ``remat_policy
    band_weights`` on MHLA) against the step without, loss and gradients
    within train-parity's tolerances; the training forward launched once a
    block without remat, twice under full remat and once under
    ``band_weights``; step time and peak memory of each; the bf16 first
    moment's AdamW state bytes (three quarters of f32's) and losses against
    f32's; on MHLA one ``utils.profiling.trace`` of a step, which must name
    the band kernels.

Three phases of PR 17 run inside the sequence too:

36. native-batcher (inside e1, after the first run, which must log that it
    drew its batches from the native C++ prefetcher): the host ms a batch
    of 128 CIFAR-shaped uint8 images from the prefetcher and from the
    numpy iterator over a 50,000-image set, then E1's step fed by each, in
    turns;
37. mhla-mask (after vit-train-flags): an MHLA-B/4 block (S=3137, batch 2)
    with an attention mask: bf16 with an all-ones mask against the
    unmasked kernel path (K1), its attention sublayer by the flash rule and
    the block by the rms bound, f32 with a random mask against the CPU
    within 1e-4, and the masked forward's ms;
38. parallel (after mhla-mask): a world-1 NCCL group, ``make_mesh(1)``,
    MHLA-B/4 at batch 32 in f32 with remat (``band_weights``), 3 steps
    plain, under DDP, FSDP2 (``fully_shard``) and tensor parallelism at
    tp=1: losses and parameters within 1e-5 of the plain path's, K1's
    training form and K2 12 launches a step inside each, ms a step and peak
    GiB; the FSDP2 state's gathered checkpoint restored into a plain model
    bit for bit; the group destroyed before the next phase.

Three phases of PR 18 run right after parallel, on another world-1 NCCL
group:

39. sequence: the SP band (``parallel/sequence.py``; plain on the card, as
    JAX's is) over a size-1 ``seq`` dimension at B=8, S=3137, W=7 against
    the plain shift band and K1's eval output (f32 within 1e-5, bf16
    within BF16_ULPS), 4 virtual shards (L=785, 3 pad rows) stitched
    against the single-device band and their f32 gradients through the
    exchange against the plain band's; a 12-block MHLA-B/4 f32 eval at
    batch 8 with the size-1 seq dimension against the S-minor path, logits
    within 1e-3, ms a batch of both;
40. pipeline: MHLA-B/4 at batch 32, f32, remat ``band_weights``, over a
    1-stage ``stage`` dimension in 4 microbatches, 3 steps, against the
    plain step at microbatch 8: losses within 1e-5, the first step's
    gradients by train-parity's rule, the parameters printed, K1's
    training form and K2 12 x 4 launches a step, ms a step and peak GiB,
    the gathered checkpoint restored into a plain model bit for bit;
41. mesh-serve: ``Predictor(mesh=make_mesh(1))`` at MHLA-B/4, bf16, batch
    32, behind ``BatchingServer`` and ``HTTPFrontend``: its probabilities
    against the plain Predictor's on the same requests, K1 12 x the
    forward passes.

Four groups of phases run right after kernel-train, at ViT-H/14's
widths (D=1280, 32 blocks, 16 heads of d=80, patch 14) on 518x518 images
(S=1370), batch 8:

42. kernel-h14: K1 (eval, and training at dropout 0 and 0.1), K2 and the
    dropout words at the band shape (8, 16, 80, 1370) for W in 7, 17, 64
    and 129 (past 16 slots the kernels' wide path), and K5's eval forward,
    training forward and backward at d in 24, 80 and 256, each in f32 and
    bf16 against its plain version (the kernel phases' rules; the wide
    gradients' bf16 entries within 2 ulps or 1e-4), each bf16 form timed
    beside its plain version, its bound and PyTorch's fused attention;
43. h14-model, h14-serve, export and h14-train for MHLA-H/14 at W=7 and at
    W=129 and for dense ViT-H/14, with weights from a seeded tree in the
    JAX package's Flax layout through ``convert/from_jax.py``: the model
    cut to 2 blocks on the card against the CPU (f32 logits within 1e-3,
    bf16 probabilities within 1e-2), then the model cut to 8 blocks served
    by ``serve.setup`` with the width flags through ``BatchingServer`` and
    one ``POST /predict`` (the eval kernel 8 x the forward passes),
    MHLA-H/14 W=7 exported and served from its artifact bit-equal to the
    live path, and 3 train steps (losses finite and falling; the training
    forward and the backward 8 x the steps);
44. kernel-h14-optin: the opt-in kernels at ViT-H/14's shapes, in f32 and
    bf16 against their plain versions: K3 (eval, training at dropout 0 and
    0.1, the dropout words) and K4 at B*h=128, S in 65 and 257 (and 64 at
    d=256), d in 24, 80, 256 (kernel-fused's loose-case rule: 3 ulps and
    the rms bound); K6, K7 and K8 at B*h=128, S=1370, the same head dims,
    W in 7, 17, 64, 129 (kernel-tileband's rule); each bf16 form timed
    beside its plain version, its bound and PyTorch's fused attention;
45. h14-model, h14-serve, export and h14-train through the opt-in
    kernels, cut to 8 blocks: dense ViT-H/14 at 224x224 (S=257) with
    ``FAVIT_FUSED_MHA=1`` (K3's eval form 8 x the forward passes, K3's
    training form and K4 8 x the steps, the flash op and K1/K2 never),
    MHLA-H/14 through the tile band at W=7 and W=129 (K6 8 x the passes,
    K7 8 x the steps, K1/K2 never; trained without attention dropout),
    W=129 also exported and served from its artifact bit-equal to the
    live path.

Then two groups at ViT-B's width (D=768) with every head count the CLI
takes (1, 2, 3, 4 and 64 heads: d = 768, 384, 256, 192 and 12), batch 8:

46. kernel-headdims: K5 (eval, training forward, backward) at d = 768, 12,
    256, 192 and 136 (dense ViT-B/4, S=3137) and 1280 (ViT-H's width in one
    head, S=1370); K1 (eval, training at dropout 0 and 0.1) and K2 at
    d = 384, 12 and 1280 (W=7); K3 and K4 at d = 384, 1280, 256 and 192
    (S=197, dropout 0 and 0.1, kernel-fused's loose-case rule); K6, K7
    and K8 at d = 4, 12, 36 (S=3137, W=7 and 129): f32 at batch 1 and
    bf16 at batch 8 against the plain versions, the paths' widths and K5,
    K3/K4 at 1280 timed beside plain, bound and PyTorch's fused attention
    (its backend named), the wide blocks' slice plan and recomputation
    factor beside K5's and K3/K4's times past 256 (up to 256: the tile
    width; at the tile widths 192 and 256 also the backward's products
    over 10 S^2 d from the dkv and dq launches counted in this run, 1.4,
    which raises unless it is one of each), the pad's copies at d = 12;
47. headdims-model, headdims-serve, export and headdims-train: MHLA-B/4
    with 2 and 64 heads (K1/K2), dense ViT-B/4 with 1 and 64 heads (K5),
    ViT-B/16 with 2 heads and ``FAVIT_FUSED_MHA=1`` (K3/K4, attention
    dropout 0.1), cut to 4 blocks: each against the CPU at 2 blocks, served
    and trained 3 steps with its launches checked; MHLA-B/4 with 2 heads
    also exported and served bit-equal from its artifact. Then the tile
    widths 256 and 192 (csrc/flash_block256.cuh): dense ViT-B/4 with 3
    heads at all 12 blocks (K5's eval form 12 x the passes, its training
    form and backward 12 x the steps) and with 4 heads, and ViT-B/16 with
    3 heads and the fused switch (K3/K4 past 64 keys, attention dropout
    0.1), the last two cut to 4 blocks.

And the tile band past W = 129 and d = 256, where its sources stream the
band:

48. kernel-tileband-range (right after kernel-h14-optin): K6, K7 and K8 at
    W = 131, 257 and 683 (JAX's halo 80, 128, 352) and d = 16, 80, 264,
    384 and 768, f32 and bf16 against their plain versions
    (kernel-tileband's rule), and at the paths' shapes in bf16 (d = 384
    and 768 at W = 7, B*h = 16 and 8, S = 3137; d = 80 at W = 257 and 683,
    B*h = 128, S = 1370) timed beside the plain versions, the bound and
    PyTorch's fused attention on K8's window tiles;
49. the paths: MHLA-H/14 at W = 257 through the tile band among
    h14-optin's paths (cut to 4 blocks; peak memory logged), and MHLA-B/4
    with 2 and 1 heads (d = 384, 768) through the tile band among the
    head-count paths, d = 384 also exported and served bit-equal from its
    artifact (``favit::tile_band_fwd``); K1/K2 launch nothing on them.

A ``[time]`` line after each group of phases gives the seconds since the
start.

The kernel, kernel-train and kernel-tileband phases also time PyTorch's
fused attention on K1's function (the band's float log-multiplicity mask
on the S-minor tensors' transposed views: the eval call, the call with
dropout for K1's training form, its backward for K2) and the backward of
K6's boolean band-mask call for K7.

Every launch count is set to 0 just before its path is driven and read just
after. The line before the last is a JSON summary of the twelve kernels
and of the new widths' rows (K3/K4 at d=80; K6/K7 at d=80, W=7 and 129;
K8 at W=129; K5 at d=768, 12, 256 and 192, K1/K2 at d=384 and 12,
K3/K4 at d=384 and 256;
K6/K7 at d=384 and 768 and at d=80, W=257, K8 at d=80, W=257), each
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
import logging
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
from focused_attention_vit_tpu_torch.data import native as native_batcher
from focused_attention_vit_tpu_torch.data.datasets import load_dataset
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
)
from focused_attention_vit_tpu_torch.data.pipeline import (
    batch_iterator,
    prepare_eval_batch,
)
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
# kernel-headdims' fused cases are batch 8 at S = 197: up to 1.2M entries a
# gradient, each a sum of 197 terms whose ds and weights the kernels round
# to bf16 (as JAX's kernels do). On one draw at d = 384 the worst entry
# lay 3.53 ulps from the f32 plain version, past FUSED_LOOSE_ULPS (dq at
# rate 0; its rms 0.0024 of the plain rms, as the roundings give). Over 16
# seeds (utils/bwd_rounding.py, PERF.md §6: K4 at d = 384, 256, 192 and
# 64) the plain version run in bf16, which makes the same roundings,
# reached up to 2.70 ulps of the f32 version, the kernels the same worst
# entry as it in each of the 24 (d, rate, gradient) cases, and the kernels
# lay within 2.16 ulps of it: their worst entry is the roundings' own. So
# there the bf16 gradients are held within FUSED_LOOSE_ULPS of the bf16
# plain version, their worst entry against the f32 version within
# HEADDIM_OWN_MARGIN ulps of the bf16 version's worst, and by the rms bound
# against the f32 version, unchanged (_near_check).
HEADDIM_OWN_MARGIN = 1
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


# The card's name and power limit as nvidia-smi gives them (phase_device).
CARD = "unknown card"


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


def band_library_call(s: int, w: int, dtype, forced: bool = True):
    """PyTorch's fused attention computing the band's function (K1's):
    ``F.scaled_dot_product_attention`` on the S-minor tensors' transposed
    views, with the band's float mask (log m on the window, m the slots a
    key fills, -inf off it; ``ops/window._band_log_multiplicity``), the
    memory-efficient backend (or, ``forced=False``, the backend PyTorch
    picks; ``call.backend(q, k, v)`` names it). That backend takes rows of
    stride 1, so the views are copied inside the call. Timed as a
    yardstick; the port uses it nowhere."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    bias = torch.as_tensor(window._band_log_multiplicity(s, w),
                           device="cuda").to(dtype)

    def call(q, k, v, dropout_p=0.0):
        with (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if forced
              else contextlib.nullcontext()):
            return F.scaled_dot_product_attention(
                *(x.transpose(-1, -2).contiguous() for x in (q, k, v)),
                attn_mask=bias, dropout_p=dropout_p)

    def backend(q, k, v):
        if forced:
            return "EFFICIENT_ATTENTION (forced, the mask's)"
        rows = [x.transpose(-1, -2).contiguous() for x in (q, k, v)]
        return SDPBackend(torch._fused_sdp_choice(*rows,
                                                  attn_mask=bias)).name

    call.backend = backend
    return call


def backward_ms(fn, args, cot, repeats: int = 30) -> float:
    """CUDA-event median ms of the backward alone of ``fn(*args)`` through
    autograd, the forward's graph kept across the repeats."""
    xs = [x.detach().requires_grad_(True) for x in args]
    out = fn(*xs)
    return cuda_median_ms(
        lambda: torch.autograd.grad(out, xs, cot, retain_graph=True),
        repeats)


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
    global CARD
    CARD = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    # The host libraries (g++: SLIC's connectivity pass and the batch
    # prefetcher) build beside the eight nvcc processes.
    with ThreadPoolExecutor(max_workers=2) as pool:
        natives = [pool.submit(kernel_build.build_native, n)
                   for n in ("connectivity", "batcher")]
        libs = kernel_build.build_many(LIBRARIES)
        libs += [f.result() for f in natives]
    for name in LIBRARIES:
        kernel_build.load(name)
    native_connectivity.get_lib()
    native_batcher.get_lib()
    log("build", f"{', '.join(str(p.relative_to(REPO)) for p in libs)} "
                 f"ready in {time.perf_counter() - t0:.1f} s")
    del libs[-2:]  # ptxas reports below are the CUDA libraries'.
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
            _headdim_wide_ptxas(lib, text)
        if lib.name.startswith("libfused_mha_"):
            _fused_ptxas(lib, text)
            _fused_wide_ptxas(lib, text)
            _headdim_wide_ptxas(lib, text)
        if lib.name == "libmhla_band_fwd.so":
            _band_fwd_ptxas(lib, text)
        if lib.name == "libmhla_band_bwd.so":
            _band_bwd_ptxas(lib, text)
        if lib.name in ("libmhla_tile_band_fwd.so",
                        "libmhla_tile_band_bwd.so"):
            _tile_ptxas(lib, text)


# The bf16 kernels' tile widths up to head dim 256 (csrc/flash_common.cuh
# tile_width: a call runs at the narrowest that holds its d); the last two
# run csrc/flash_block256.cuh's blocks. The tile-band sources are built at
# the same widths.
TILE_WIDTHS = (16, 32, 64, 80, 128, 192, 256)
BLOCK256_WIDTHS = TILE_WIDTHS[-2:]
# The tile widths whose bf16 flash kernels the build phase reports and
# holds to no spill: the B/4 paths' d = 64, ViT-H/14's d = 80, and the
# blocks of csrc/flash_block256.cuh at 192 and 256 (the 3- and 4-head
# paths at D = 768).
FLASH_PTXAS_DIMS = (64, 80, 192, 256)
FLASH_NO_SPILL_DIMS = FLASH_PTXAS_DIMS


def _flash_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's report of each bf16 flash kernel in ``lib`` at the tile
    widths of FLASH_PTXAS_DIMS (``flash_*_block256`` at 192 and 256,
    ``flash_*_wgmma`` below); raise if one of FLASH_NO_SPILL_DIMS spills
    or one is missing."""
    lib_name = lib.name[3:-3]
    so = kernel_build.load(lib_name)
    found = set()
    for d in FLASH_PTXAS_DIMS:
        block = "block256" if d in BLOCK256_WIDTHS else "wgmma"
        if lib_name == "flash_attention_fwd":
            smem = {f"flash_fwd_{block}": so.flash_attention_fwd_smem(d, 0)}
        else:
            smem = {f"flash_bwd_dkv_{block}":
                        so.flash_attention_bwd_smem(d, 0, 0),
                    f"flash_bwd_dq_{block}":
                        so.flash_attention_bwd_smem(d, 1, 0)}
        for m in re.finditer(
                r"Function properties for \S*?\d(flash_(?:fwd|bwd_dkv|bwd_dq)"
                rf"_{block})ILi{d}E(\w*?)Ev\S*\n\s*\d+ bytes stack frame, "
                r"(\d+) bytes spill stores.*\n.*?Used (\d+) registers"
                r"(?:.*?(\d+) bytes smem)?", text):
            kernel, spills = m.group(1), int(m.group(3))
            form = ", lse" if "Lb1" in m.group(2) else ""
            found.add((kernel, d))
            log("build", f"ptxas {kernel}<{d}{form}>: {m.group(4)} registers, "
                         f"{spills} bytes of spill stores, {m.group(5) or 0} "
                         f"bytes of static and {smem[kernel]} of dynamic "
                         f"shared memory")
            if spills and d in FLASH_NO_SPILL_DIMS:
                raise AssertionError(f"{kernel}<{d}{form}> spills {spills} "
                                     f"bytes")
        missing = {(k, d) for k in smem} - found
        if missing:
            raise AssertionError(f"ptxas report of {sorted(missing)} not "
                                 f"found in {lib.parent / 'build.log'}")


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


# The fused kernels' tile widths past the four of the whole-row backward.
FUSED_NEW_WIDTHS = (80, 192, 256)


def _fused_wide_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers and spills of the fused source's bf16 kernels
    at the tile widths 80, 192 and 256 (the whole-row forward at each count
    of key chunks, the flash blocks with the mask: at 192 and 256
    csrc/flash_block256.cuh's forward, dkv and dq); raise if a width has no
    kernel, or if a block256 kernel is missing or spills (the whole-row
    ones are reported)."""
    got = {}
    for m in re.finditer(
            r"Function properties for \S*?(fused_(?:fwd|bwd)_(?:\w+?_)?"
            r"(?:wgmma|block256))"
            r"ILi(\d+)E(?:Li(\d+)E|Lb(\d)E)?\S*\n\s*\d+ bytes stack frame, "
            r"(\d+) bytes spill stores.*\n.*?Used (\d+) registers", text):
        name, d, n, flag, spills, regs = m.groups()
        if int(d) in FUSED_NEW_WIDTHS:
            key = (int(d), name + (f"<{n}>" if n else "")
                   + (f", lse {flag}" if flag else ""))
            got[key] = (int(regs), int(spills))
    missing = [w for w in FUSED_NEW_WIDTHS if not any(k[0] == w for k in got)]
    if missing:
        raise AssertionError(f"no ptxas report of {lib.name}'s kernels at "
                             f"tile widths {missing}")
    kinds = (("fused_fwd_block256",) if "_fwd" in lib.name else
             ("fused_bwd_dkv_block256", "fused_bwd_dq_block256"))
    for w in BLOCK256_WIDTHS:
        held = {k[1]: v for k, v in got.items()
                if k[0] == w and "block256" in k[1]}
        if {k.split(",")[0] for k in held} != set(kinds):
            raise AssertionError(f"ptxas report of {kinds} at tile width {w}"
                                 f" not found in {lib.parent / 'build.log'}")
        if any(sp for _, sp in held.values()):
            raise AssertionError(f"{lib.name}'s flash blocks at tile width "
                                 f"{w} spill: {held}")
    for w in FUSED_NEW_WIDTHS:
        rows = {k[1]: v for k, v in got.items() if k[0] == w}
        regs = [r for r, _ in rows.values()]
        spills = {n: sp for n, (_, sp) in rows.items() if sp}
        log("build", f"ptxas {lib.name} at tile width {w}: {len(rows)} bf16 "
                     f"kernels, registers {min(regs)}-{max(regs)}, spill "
                     f"stores (bytes) {spills or 'none'}")


# The head dims at which the build phase reports the wide kernels' dynamic
# shared memory: the one-head paths' (each own tile kept at 768 in the
# forward, streamed in the backward and at 1280).
WIDE_SMEM_DIMS = (384, 768, 1280)


def _headdim_wide_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers and spills of the blocks past head dim 256
    (csrc/flash_wide.cuh) in a flash or fused library, each instantiation
    (NT output tiles a warpgroup, with or without lse): the bf16 forward,
    or the dkv and dq kernels, with their dynamic shared memory at
    WIDE_SMEM_DIMS; raise if one is missing or spills."""
    op = "flash" if lib.name.startswith("libflash") else "fused"
    kinds = ("fwd",) if "_fwd" in lib.name else ("bwd_dkv", "bwd_dq")
    so = kernel_build.load("flash_attention_fwd" if kinds == ("fwd",)
                           else "flash_attention_bwd")
    for kind in kinds:
        name = f"{op}_{kind}_wide"
        found = re.findall(
            rf"Function properties for \S*?\d{name}ILi(\d)E(?:Lb(\d)E)?"
            r"\S*\n\s*\d+ bytes stack frame, (\d+) bytes spill stores.*\n"
            r".*?Used (\d+) registers", text)
        if len(found) != (6 if kind == "fwd" else 3):
            raise AssertionError(f"ptxas reports {len(found)} instantiations "
                                 f"of {name} in {lib.parent / 'build.log'}")
        def smem(nt):
            return [so.flash_attention_fwd_smem(d, nt) if kind == "fwd"
                    else so.flash_attention_bwd_smem(
                        d, int(kind == "bwd_dq"), nt)
                    for d in WIDE_SMEM_DIMS]
        log("build", f"ptxas {name} (head dims past 256; NT, lse: "
                     f"registers, spill bytes, dynamic smem at d = "
                     f"{WIDE_SMEM_DIMS}): " + "; ".join(
                         f"{nt}{',' + lse if lse else ''}: {regs}, {spills},"
                         f" {smem(int(nt))}"
                         for nt, lse, spills, regs in sorted(found)))
        if any(int(spills) for _, _, spills, _ in found):
            raise AssertionError(f"{name} spills: {found}")


def _band_fwd_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers and spills and the dynamic shared memory of
    every K1 instantiation (per dtype, slot cap 8 or 16 or the wide kernel's
    groups, saved weights and dropout; the head dim is an argument); raise
    if one is missing or one of the main path's (bf16, slot cap 8, eval or
    training form) spills."""
    so = kernel_build.load("mhla_band_fwd")
    found = {}
    for m in re.finditer(
            r"Function properties for \S*?band_fwd_(kernel|wide_kernel)I"
            r"(13__nv_bfloat16|f)(?:Li(\d+)E)?Lb(\d)ELb(\d)E\S*\n\s*\d+ "
            r"bytes stack frame, (\d+) bytes spill stores.*\n.*?Used (\d+) "
            r"registers", text):
        kind, dtype, cap, save, drop, spills, regs = m.groups()
        bf16 = dtype != "f"
        cap = cap or "wide"
        smem = so.mhla_band_fwd_smem(int(bf16), 64,
                                     129 if cap == "wide" else int(cap))
        key = ("bf16" if bf16 else "f32", cap, save + drop)
        found[key] = (int(regs), int(spills), smem)
        if bf16 and cap == "8" and int(spills):
            raise AssertionError(f"K1 {key} spills {spills} bytes")
    if len(found) != 24:
        raise AssertionError(f"ptxas reports {len(found)} of K1's 24 "
                             f"instantiations in {lib.parent / 'build.log'}")
    for dt in ("bf16", "f32"):
        log("build", f"ptxas K1 {dt} (slot cap/save,dropout: registers, "
                     f"spill bytes, dynamic smem): " + "; ".join(
                         f"{cap}/{form}: {r}, {sp}, {sm}"
                         for (t_, cap, form), (r, sp, sm)
                         in sorted(found.items()) if t_ == dt))


def _band_bwd_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers and spills and the dynamic shared memory of
    every K2 instantiation (pass 1 and 2, per dtype, slot cap 8 or 16 or
    the wide kernels' groups, and dropout flag); raise if one is missing or
    the main path's (bf16, slot cap 8) spills."""
    so = kernel_build.load("mhla_band_bwd")
    found = {}
    for m in re.finditer(
            r"Function properties for \S*?band_bwd_(query|key)_(?:wide_)?"
            r"kernelI(13__nv_bfloat16|f)(?:Li(\d+)E)?(?:Lb(\d)E)?E\S*\n"
            r"\s*\d+ bytes stack frame, (\d+) bytes spill stores.*\n.*?Used "
            r"(\d+) registers", text):
        kind, dtype, cap, drop, spills, regs = m.groups()
        bf16 = dtype != "f"
        cap = cap or "wide"
        smem = so.mhla_band_bwd_smem(1 if kind == "query" else 2, int(bf16),
                                     64, 129 if cap == "wide" else int(cap))
        key = ("bf16" if bf16 else "f32", kind, cap, drop)
        found[key] = (int(regs), int(spills), smem)
        if bf16 and cap == "8" and int(spills):
            raise AssertionError(f"K2 {key} spills {spills} bytes")
    if len(found) != 18:
        raise AssertionError(f"ptxas reports {len(found)} of K2's 18 "
                             f"instantiations in {lib.parent / 'build.log'}")
    for dt in ("bf16", "f32"):
        for kind in ("query", "key"):
            log("build", f"ptxas K2 {dt} pass {1 if kind == 'query' else 2}"
                         f" (slot cap[/dropout]: registers, spill bytes, "
                         f"dynamic smem at d=64): " + "; ".join(
                             f"{cap}{'' if drop is None else '/' + drop}"
                             f": {r}, {sp}, {sm}"
                             for (t_, k_, cap, drop), (r, sp, sm)
                             in sorted(found.items(),
                                       key=lambda kv: (kv[0][2], kv[0][3]
                                                       or ""))
                             if t_ == dt and k_ == kind))


# The ring kernels' head dims (hw <= 16): the MHLA-B/4 and E5/E6 paths'.
TILE_RING_DIMS = (16, 32, 64, 128)
# The wgmma kernels' output slice widths (tile_band_sm90.cuh slice_width).
TILE_SLICE_WIDTHS = (64, 128, 192, 256)


def _tile_ptxas(lib: Path, text: str) -> None:
    """Log ptxas's registers, spills and shared memory of every
    instantiation of a tile-band source: K6/K8's ring kernels (bf16, the
    four ring head dims, rows and tiles), wide kernels (bf16, every tile
    width, rows and tiles), wgmma kernels (every slice width, rows and
    tiles) and f32 kernels (rows and tiles), or K7's ring kernels, the wide
    band and keys kernels (every tile width), the wgmma band kernels (Q and
    G kept or streamed) and rows kernels (every slice width) and the two
    f32 kernels. Raise if one is missing or spills."""
    fwd = lib.name == "libmhla_tile_band_fwd.so"
    kind, what = ("fwd", "K6/K8") if fwd else ("bwd", "K7")
    smem = tile._kernel(f"mhla_tile_band_{kind}",
                        f"mhla_tile_band_{kind}_smem")
    found = {}
    for m in re.finditer(
            rf"Function properties for \S*?tile_band_{kind}_"
            r"(mma|f32_rows|f32_keys|f32|wide_band|wide_keys|wide|"
            r"sm90_band|sm90_rows|sm90)(?:I?Li(\d+)E)?(?:I?Lb(\d)E)?"
            r"\S*\n\s*\d+ bytes stack frame, (\d+) bytes spill stores.*\n"
            r".*?Used (\d+) registers(?:.*?(\d+) bytes smem)?", text):
        k, d, tiles, spills, regs, static = m.groups()
        d = int(d or 0)
        line = (("K8" if tiles == "1" else "K6") if fwd
                else ("kept" if tiles == "1" else "streamed")
                if k == "sm90_band" else "")
        # The dynamic shared memory at the widest halo a kernel takes (the
        # ring kernels' 16, the wide ones' 64); the wgmma kernels' at the
        # widest head dim of their slice width past the wide range (the
        # band kernel's at d = 768, Q and G kept beside the ring, and at
        # d = 1024, streamed).
        dyn = {"mma": lambda: smem(d, 16), "wide": lambda: smem(d, 64),
               "wide_band": lambda: smem(d, 64),
               "wide_keys": lambda: smem(d, 64),
               "sm90": lambda: smem(d, 128),
               "sm90_band": lambda: smem(768 if line == "kept" else 1024,
                                         128),
               "sm90_rows": lambda: smem(d, 128)}.get(k, lambda: 0)()
        found[(k, d, line)] = (int(regs), int(spills), int(static or 0), dyn)
    expected = (2 * len(TILE_RING_DIMS) + 2 * len(TILE_WIDTHS)
                + 2 * len(TILE_SLICE_WIDTHS) + 2 if fwd
                else len(TILE_RING_DIMS) + 2 * len(TILE_WIDTHS) + 2
                + len(TILE_SLICE_WIDTHS) + 2)
    if len(found) != expected:
        raise AssertionError(f"ptxas reports {len(found)} of {what}'s "
                             f"{expected} instantiations in "
                             f"{lib.parent / 'build.log'}")
    log("build", f"ptxas {what} (kernel D{' line' if fwd else ' form'}: "
                 f"registers, spill bytes, static smem, dynamic smem at the "
                 f"kernel's widest halo): " + "; ".join(
                     f"{k} {d}{' ' + ln if ln else ''}: {r}, {sp}, {st}, {dy}"
                     for (k, d, ln), (r, sp, st, dy) in sorted(found.items())))
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
        library = band_library_call(SERVE_SHAPE[3], SERVE_W, dtype)
        with torch.no_grad():
            lib_err = float((library(q, k, v).transpose(-1, -2).float()
                             - band.roll_banded_attention(
                                 q, k, v, SERVE_W).float()).abs().max())
            library_ms = cuda_median_ms(lambda: library(q, k, v))
        log("kernel", f"serving shape {dt}: PyTorch's fused attention "
                      f"(memory-efficient backend) on the transposed views "
                      f"with the band's log-multiplicity mask {library_ms:.4f}"
                      f" ms (max |K1 - it| {lib_err:.3g}); K1 "
                      f"{ms / library_ms:.3f} x it")
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
                          library_ms=library_ms,
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


def _compare_train(q, k, v, g, w, rate, seed, bwd_check=None):
    """The training forward and the backward kernel against their plain
    versions on the same inputs; returns {name: (err, ok, text)}. The
    gradients are held by ``bwd_check`` (default ``_worst``)."""
    bwd_check = bwd_check or _worst
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
        res[name] = bwd_check(a, b, dtype, F32_BWD_TOL)
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
        library = band_library_call(s, SERVE_W, dtype)
        with torch.no_grad():
            times["library_fwd_train"] = cuda_median_ms(
                lambda: library(q, k, v, TRAIN_DROPOUT))
        times["library_bwd"] = backward_ms(
            lambda *a: library(*a, TRAIN_DROPOUT), (q, k, v),
            g.transpose(-1, -2).contiguous())
        log("kernel-train", f"training shape {dt}: PyTorch's fused attention "
                            f"with the band's log-multiplicity mask and "
                            f"dropout_p {TRAIN_DROPOUT}: forward "
                            f"{times['library_fwd_train']:.4f} ms, its "
                            f"backward through autograd "
                            f"{times['library_bwd']:.4f} ms (CUDA-event "
                            f"medians of 30)")
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
                           library_ms=times["library_fwd_train"],
                           **least_time(fwd_bytes, 4 * pairs)),
            bwd=dict(max_abs_err=max(res[n][0] for n in ("dq", "dk", "dv")),
                     ms=times["bwd"], plain_ms=times["bwd_plain"],
                     library_ms=times["library_bwd"],
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
        for d in TILE_RING_DIMS:
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

        # K7's yardstick: the backward of K6's library call on the tiles.
        gt = torch.randn(qt.shape, device="cuda", generator=gen).to(dtype)
        times["library_bwd"] = backward_ms(
            lambda *a: F.scaled_dot_product_attention(*a, attn_mask=mask),
            (qt, ke, ve), gt)
        log(phase, f"serving shape bf16: the backward of PyTorch's fused "
                   f"attention on the window tiles with the band as a "
                   f"boolean mask {times['library_bwd']:.4f} ms (CUDA-event "
                   f"median of 30); K7 {times['bwd'] / times['library_bwd']:.3f}"
                   f" x it")
        del gt

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
                     library_ms=times["library_bwd"],
                     **least_time(7 * one, 10 * pairs)),
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


MASK_BATCH = 2


def phase_mhla_mask() -> None:
    """An MHLA-B/4 block (D=768, 12 heads, W=7, S=3137) with an attention
    mask, batch 2: in bf16 an all-ones mask (the plain masked shift band)
    against no mask (K1), the attention sublayer by the flash rule and the
    block by its rms bound; in f32 a random mask on the card against the
    same block on the CPU within 1e-4; ms a masked bf16 forward."""
    from focused_attention_vit_tpu_torch.models.layers import (
        MHLATransformerBlock,
    )

    phase = "mhla-mask"
    s = (224 // 4) ** 2 + 1
    gen = torch.Generator().manual_seed(12)
    block = MHLATransformerBlock(768, 12, SERVE_W)
    with torch.no_grad():  # the default init leaves attention near uniform
        for p in block.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 768 ** -0.5, generator=gen)
    block.eval()
    x = torch.randn(MASK_BATCH, s, 768, generator=gen)
    mask = (torch.rand(MASK_BATCH, s, s, generator=gen) > 0.3).float()
    with torch.no_grad():
        t0 = time.perf_counter()
        want = block(x, mask)
        cpu_s = time.perf_counter() - t0
        block.to("cuda")
        band.reset_launch_count()
        got = block(x.cuda(), mask.cuda()).cpu()
        if band.launch_count("fwd"):
            raise AssertionError("the masked block launched K1")
        err, ok, text = _flash_check(got, want, torch.float32, 1e-4)
        log(phase, f"f32, random mask (30% zeros), batch {MASK_BATCH}, "
                   f"S={s}: card against the CPU's plain masked shift band "
                   f"(the CPU took {cpu_s:.1f} s): max abs err {text}")
        if not ok:
            raise AssertionError(f"the masked block on the card disagrees "
                                 f"with the CPU: {text}")
        block.to(torch.bfloat16)
        xb = x.to("cuda", torch.bfloat16)
        ones = torch.ones(MASK_BATCH, s, s, device="cuda")
        # The attention sublayer, where the plain masked band replaces K1,
        # by the flash rule; the whole block by its rms bound (its bf16
        # LayerNorm, GEMMs and residual adds can turn one ulp of the
        # attention into a few of an entry: 2 and 3 in two card runs).
        h = block.norm1(xb)
        unmasked = block.attn(h)
        if band.launch_count("fwd") != 1:
            raise AssertionError("the unmasked layer did not launch K1")
        checks = {"attention": _flash_check(
                      block.attn(h, attention_mask=ones), unmasked,
                      torch.bfloat16, None),
                  "block": _rms_check(block(xb, ones), block(xb))}
        log(phase, "bf16, all-ones mask against no mask (K1): max abs err "
                   + "; ".join(f"{n} {t}" for n, (_, _, t) in checks.items()))
        bad = [n for n, (_, ok, _) in checks.items() if not ok]
        if bad:
            raise AssertionError(f"the all-ones masked {bad} disagree with "
                                 f"the kernel path: {checks}")
        ms_masked = cuda_median_ms(lambda: block(xb, ones), 10, 2)
        ms_plain = cuda_median_ms(lambda: block(xb), 10, 2)
    log(phase, f"bf16 forward of the block, batch {MASK_BATCH}: masked (the "
               f"plain shift band, mask gathered into [B, W, S]) "
               f"{ms_masked:.3f} ms, unmasked (K1) {ms_plain:.3f} ms "
               f"(CUDA-event medians of 10)")
    del block, x, mask, got, want, xb, ones
    torch.cuda.empty_cache()


PARALLEL_STEPS = 3


def phase_parallel(tmp: str) -> dict:
    """A world-1 NCCL group on the card: MHLA-B/4 (12 blocks) at batch 32,
    f32, dropout 0.1, remat with ``band_weights`` (so that f32 fits),
    ``PARALLEL_STEPS`` steps plain, then under DDP, FSDP2 and tensor
    parallelism at tp=1 from the same weights and batches: losses and
    parameters equal the plain path's within 1e-5, and K1's training form
    and K2 launch 12 times a step inside each wrapper; ms a step and peak
    GiB each; the sharded state's checkpoint restored into a plain model
    bit for bit. Returns the launches under the wrappers."""
    import torch.distributed as dist

    from focused_attention_vit_tpu_torch.parallel import make_mesh, shard_state
    from focused_attention_vit_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    phase = "parallel"
    rng = np.random.default_rng(13)
    data = [(_images(rng, TRAIN_BATCH), rng.integers(0, 10, TRAIN_BATCH))
            for _ in range(PARALLEL_STEPS)]

    def fresh():
        model = MHLA.build(device="cuda", dropout=TRAIN_DROPOUT, remat=True,
                           remat_policy="band_weights",
                           generator=torch.Generator().manual_seed(21))
        return train.create_train_state(model, train.make_adamw(1e-4))

    def run(state, step, label):
        losses = []
        band.reset_launch_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i, (u8, y) in enumerate(data):
            state, m = step(state, u8, y, 300 + i)
            losses.append(float(m["loss_sum"] / m["count"]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / len(data) * 1e3
        launches = {k: band.launch_count(k) for k in band.LAUNCH_KINDS}
        want = {"fwd": 0, "fwd_train": DEPTH * len(data),
                "bwd": DEPTH * len(data)}
        if launches != want:
            raise AssertionError(f"{label}: band launches {launches} != "
                                 f"{want}")
        log(phase, f"{label}: {ms:.1f} ms a step (host clock, {len(data)} "
                   f"steps, the first included), peak "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                   f"losses {['%.6f' % x for x in losses]}; band launches "
                   f"{launches}")
        return state, losses, launches

    step = train.make_train_step(224)
    plain, want_losses, _ = run(fresh(), step, "plain")
    want = {n: p.detach() for n, p in plain.model.named_parameters()}
    del plain
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl-store",
                            rank=0, world_size=1)
    total = dict.fromkeys(band.LAUNCH_KINDS, 0)
    try:
        mesh = make_mesh(1)
        step = train.make_train_step(224, mesh=mesh)
        for label in ("DDP", "FSDP2 (fully_shard)", "TP at tp=1"):
            state = shard_state(fresh(), mesh, fsdp=label.startswith("F"),
                                ddp=label == "DDP",
                                tensor_parallel=label.startswith("TP"))
            state, losses, launches = run(state, step, label)
            for k in total:
                total[k] += launches[k]
            got = state.layout.params
            worst = max(
                float(((p.full_tensor() if hasattr(p, "full_tensor") else p)
                       .detach() - want[n]).abs().max())
                for n, p in got.items())
            loss_err = max(abs(a - b) for a, b in zip(losses, want_losses))
            log(phase, f"{label}: against plain, losses within "
                       f"{loss_err:.3g}, parameters within {worst:.3g}")
            if loss_err > 1e-5 or worst > 1e-5:
                raise AssertionError(f"{label} departs from the plain path: "
                                     f"losses {loss_err}, parameters {worst}")
            if state.layout.fsdp:
                mngr = CheckpointManager(os.path.join(tmp, "parallel-ckpt"))
                mngr.save(PARALLEL_STEPS, state)
                full = state.layout.full_state(state)
                back = fresh()
                mngr.restore(back)
                same = all(torch.equal(p.detach(), full["model"][n])
                           for n, p in back.model.named_parameters())
                log(phase, f"{label}: the gathered checkpoint restored into "
                           f"a plain model: bit-equal {same}")
                if not same:
                    raise AssertionError("the FSDP2 checkpoint does not "
                                         "restore bit for bit")
                del back, full
            del state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


# The SP band at MHLA-B/4 width, batch 8 (B, h, S, d), over 4 virtual
# shards: L = 785 rows a shard, 3 pad rows on the last.
SEQ_SHAPE = (8, 12, 3137, 64)
SEQ_SHARDS = 4
PIPE_MICROBATCHES = 4


@contextlib.contextmanager
def _world_one(tmp: str):
    """A world-1 NCCL process group for the phases of the parallel layer,
    destroyed on the way out."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp}/mesh-store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _band_check(what: str, got, ref, dtype, f32_tol: float) -> float:
    err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        ok, text = err <= f32_tol, f"max abs err {err:.3g} (tol {f32_tol:g})"
    else:
        ulps = bf16_ulps(got, ref)
        ok, text = ulps <= BF16_ULPS, (f"max abs err {err:.3g}, {ulps:.2f} "
                                       f"ulps (tol {BF16_ULPS})")
    log("sequence", f"{what}: {text}")
    if not ok:
        raise AssertionError(f"sequence: {what} disagrees: {text}")
    return err


def phase_sequence(card: str) -> None:
    """Sequence parallelism at MHLA-B/4 width on a world-1 group: the SP
    band (``parallel.sequence.sp_windowed_attention``, plain on the card
    as in JAX) over a size-1 ``seq`` dimension against the plain shift band
    and K1's eval output at B=8, S=3137, W=7 (f32 within 1e-5, bf16 within
    BF16_ULPS); 4 virtual shards (L=785, 3 pad rows) stitched against the
    single-device band, and their gradients through the exchange against
    the plain band's (f32, F32_BWD_TOL); then a 12-block MHLA-B/4 f32 eval
    at batch 8 with the size-1 seq dimension against the S-minor path
    (K1): logits within 1e-3, ms a batch of both."""
    from focused_attention_vit_tpu_torch.parallel import make_mesh, sequence

    phase = "sequence"
    mesh = make_mesh(1, unit_dims=("seq",))
    b, h, s, d = SEQ_SHAPE
    w = SERVE_W
    shards = sequence.SeqShards.of(mesh, "seq", s)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        q, k, v = (torch.randn(SEQ_SHAPE, device="cuda", generator=gen)
                   .to(dtype) for _ in range(3))
        with torch.no_grad():
            got = sequence.sp_windowed_attention(q, k, v, w, shards)
            plain = window._shift_banded_attention(q, k, v, w)
            k1 = band.roll_banded_attention(
                *(t.transpose(2, 3).contiguous() for t in (q, k, v)),
                w).transpose(2, 3)
            virtual = sequence.virtual_sp_windowed_attention(
                q, k, v, w, SEQ_SHARDS)
        _band_check(f"{SEQ_SHAPE} W={w} {dt}, a size-1 seq group against "
                    f"the plain shift band", got, plain, dtype, F32_TOL)
        _band_check(f"{dt}, a size-1 seq group against K1", got, k1, dtype,
                    F32_TOL)
        _band_check(f"{dt}, {SEQ_SHARDS} virtual shards (L, pad = "
                    f"{sequence.check_shards(s, SEQ_SHARDS, w)}) stitched "
                    f"against the plain shift band", virtual, plain, dtype,
                    F32_TOL)
        sp_ms = cuda_median_ms(
            lambda: sequence.sp_windowed_attention(q, k, v, w, shards))
        k1_ms = cuda_median_ms(lambda: band.roll_banded_attention(
            *(t.transpose(2, 3).contiguous() for t in (q, k, v)), w))
        log(phase, f"{dt}: the SP band over a size-1 group {sp_ms:.3f} ms, "
                   f"K1 with its layout copies {k1_ms:.3f} ms (median of 30, "
                   f"CUDA events; {card})")
        del got, plain, k1, virtual
    q, k, v = (torch.randn(SEQ_SHAPE, device="cuda", generator=gen)
               .requires_grad_() for _ in range(3))
    g = torch.randn(SEQ_SHAPE, device="cuda", generator=gen)
    out = sequence.virtual_sp_windowed_attention(q, k, v, w, SEQ_SHARDS)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(window._shift_banded_attention(q, k, v, w),
                               (q, k, v), g)
    for name, a, c in zip("qkv", got, want):
        _band_check(f"f32 d{name} of {SEQ_SHARDS} virtual shards through the "
                    f"exchange against the plain band's", a, c,
                    torch.float32, F32_BWD_TOL)
    del q, k, v, g, out, got, want
    torch.cuda.empty_cache()

    ref = MHLA.build(generator=torch.Generator().manual_seed(0))
    sp_model = MHLA.build(generator=torch.Generator().manual_seed(0),
                          sp_mesh=mesh)
    ref, sp_model = ref.to("cuda").eval(), sp_model.to("cuda").eval()
    x = prepare_eval_batch(torch.from_numpy(
        _images(np.random.default_rng(8), b)).cuda(), 224)
    band.reset_launch_count()
    with torch.inference_mode():
        want = ref(x)
        launches = band.launch_count()
        got = sp_model(x)
        if band.launch_count() != launches:
            raise AssertionError("the SP model launched K1")
        ref_ms = cuda_median_ms(lambda: ref(x), repeats=5, warmup=1)
        sp_ms = cuda_median_ms(lambda: sp_model(x), repeats=5, warmup=1)
    dl = float((got - want).abs().max())
    log(phase, f"MHLA-B/4 f32 eval, batch {b}: a size-1 seq group (the plain "
               f"SP band) against the S-minor path (K1, {launches} launches):"
               f" max |d logits| {dl:.3g} (tol 1e-3); {sp_ms:.1f} ms a batch "
               f"against {ref_ms:.1f} (median of 5, CUDA events; {card})")
    if dl > 1e-3:
        raise AssertionError("the SP model departs from the S-minor path")
    del ref, sp_model, x
    torch.cuda.empty_cache()


def phase_pipeline(tmp: str, card: str) -> dict:
    """Pipeline parallelism on a world-1 group: MHLA-B/4 (12 blocks) over a
    1-stage ``stage`` dimension in ``PIPE_MICROBATCHES`` microbatches at
    batch 32, f32, dropout 0, remat with ``band_weights``,
    ``PARALLEL_STEPS`` steps, against the plain step at the same microbatch
    split (``microbatch=8``, no augmentation on either side): losses
    within 1e-5 and the first step's gradients by the train-parity rule
    (each leaf within 1e-3 of its largest entry plus 1e-6); K1's training
    form and K2 launch 12 x 4 times a step on both; ms a step and peak GiB;
    the gathered checkpoint restored into a plain model bit for bit.
    Returns the pipeline's launches. The parameters after the AdamW steps
    are printed and not bound: the stem and the head run on the whole
    batch in the pipeline and per microbatch in the plain step (other
    cuBLAS kernels), and Adam turns the f32 noise of an entry whose
    gradient is near zero into a step of up to the learning rate."""
    from focused_attention_vit_tpu_torch.parallel import make_mesh, shard_state
    from focused_attention_vit_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    phase = "pipeline"
    mesh = make_mesh(1, unit_dims=("stage",))
    rng = np.random.default_rng(17)
    data = [(_images(rng, TRAIN_BATCH), rng.integers(0, 10, TRAIN_BATCH))
            for _ in range(PARALLEL_STEPS)]
    per_step = DEPTH * PIPE_MICROBATCHES

    def fresh(**kw):
        model = MHLA.build(device="cuda", remat=True,
                           remat_policy="band_weights",
                           generator=torch.Generator().manual_seed(21), **kw)
        return train.create_train_state(model, train.make_adamw(1e-4))

    def run(state, step, label):
        losses, grads = [], None
        band.reset_launch_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i, (u8, y) in enumerate(data):
            state, m = step(state, u8, y, 400 + i)
            losses.append(float(m["loss_sum"] / m["count"]))
            if grads is None:  # the first step's, as the update used them
                grads = {n: p.grad.detach().clone()
                         for n, p in state.model.named_parameters()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / len(data) * 1e3
        launches = {k: band.launch_count(k) for k in band.LAUNCH_KINDS}
        want = {"fwd": 0, "fwd_train": per_step * len(data),
                "bwd": per_step * len(data)}
        if launches != want:
            raise AssertionError(f"{label}: band launches {launches} != "
                                 f"{want}")
        log(phase, f"{label}: {ms:.1f} ms a step (host clock, {len(data)} "
                   f"steps, the first included), peak "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                   f"({card}); losses {['%.6f' % x for x in losses]}; band "
                   f"launches {launches}")
        return state, losses, launches, grads

    plain, want_losses, _, want_grads = run(
        fresh(), train.make_train_step(
            224, augment=False,
            microbatch=TRAIN_BATCH // PIPE_MICROBATCHES),
        f"plain, microbatch {TRAIN_BATCH // PIPE_MICROBATCHES}")
    want = {n: p.detach() for n, p in plain.model.named_parameters()}
    del plain
    torch.cuda.empty_cache()
    state = shard_state(fresh(scan_layers=True, pp_mesh=mesh,
                              pp_microbatches=PIPE_MICROBATCHES), mesh)
    state, losses, launches, grads = run(
        state, train.make_train_step(224, augment=False, mesh=mesh),
        f"GPipe, 1 stage, {PIPE_MICROBATCHES} microbatches")
    loss_err = max(abs(a - b) for a, b in zip(losses, want_losses))
    grad_worst = max(
        (float((g - want_grads[n]).abs().max())
         / (PARITY_GRAD_REL * float(want_grads[n].abs().max())
            + PARITY_GRAD_ABS), n) for n, g in grads.items())
    errs = {n: float((p.detach() - want[n]).abs().max())
            for n, p in state.layout.params.items()}
    top = max(errs, key=errs.get)
    log(phase, f"against plain: losses within {loss_err:.3g} (tol 1e-5); "
               f"the first step's gradients within {grad_worst[0]:.3g} of "
               f"the train-parity bound (worst leaf {grad_worst[1]}); "
               f"parameters after {PARALLEL_STEPS} AdamW steps within "
               f"{errs[top]:.3g}, at {top} (printed, not bound)")
    if loss_err > 1e-5 or grad_worst[0] > 1.0:
        raise AssertionError(f"the pipeline departs from the plain step: "
                             f"losses {loss_err}, gradients {grad_worst}")
    mngr = CheckpointManager(os.path.join(tmp, "pipeline-ckpt"))
    mngr.save(PARALLEL_STEPS, state)
    full = state.layout.full_state(state)
    back = fresh()
    mngr.restore(back)
    same = all(torch.equal(p.detach(), full["model"][n])
               for n, p in back.model.named_parameters())
    log(phase, f"the gathered checkpoint restored into a plain model: "
               f"bit-equal {same}")
    if not same:
        raise AssertionError("the pipeline's checkpoint does not restore bit "
                             "for bit")
    del state, back, full, want
    torch.cuda.empty_cache()
    return launches


def phase_mesh_serve(card: str) -> int:
    """Mesh serving on a world-1 group: MHLA-B/4 in bf16 at batch 32,
    ``Predictor(mesh=make_mesh(1))`` behind ``BatchingServer`` and
    ``HTTPFrontend``: concurrent requests and one ``POST /predict``, whose
    probabilities must equal the plain ``Predictor``'s on the same
    requests (the difference printed; bit for bit expected, 1e-2 the
    bound), and K1 launched 12 x the forward passes. Returns those
    launches."""
    from focused_attention_vit_tpu_torch.infer import Predictor
    from focused_attention_vit_tpu_torch.parallel import make_mesh

    phase = "mesh-serve"
    rng = np.random.default_rng(9)
    cpu_model = MHLA.build(generator=torch.Generator().manual_seed(0))
    kw = dict(img_size=224, device="cuda", batch_size=32)
    plain = Predictor(copy.deepcopy(cpu_model), **kw)
    meshed = Predictor(cpu_model, mesh=make_mesh(1), **kw)
    meshed.warmup()
    sizes = [1, 7, 32, 40, 12]
    reqs = [_images(rng, n) for n in sizes]
    http_req = _images(rng, 5)
    want = [plain.predict_proba(r) for r in reqs + [http_req]]
    del plain
    forwards = [0]
    hook = meshed.model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    band.reset_launch_count()
    t0 = time.perf_counter()
    with serve.BatchingServer(meshed, max_delay_ms=5.0, workers=2) as srv, \
            serve.HTTPFrontend(srv, host="127.0.0.1", port=0) as fe:
        with ThreadPoolExecutor(max_workers=4) as pool:
            outs = list(pool.map(
                lambda r: srv.submit(r).result(timeout=300), reqs))
        outs.append(_post(f"http://{fe.host}:{fe.port}", http_req))
    wall = time.perf_counter() - t0
    meshed.close()
    hook.remove()
    launches = band.launch_count()
    for req, out in zip(reqs + [http_req], outs):
        _check_probs(out, len(req))
    dp = max(float(np.abs(a - b).max()) for a, b in zip(outs, want))
    log(phase, f"{len(reqs)} concurrent requests of {sizes} images and one "
               f"POST /predict of {len(http_req)} through a (data 1, model 1)"
               f" mesh in {wall:.2f} s: max |d probs| against the plain "
               f"Predictor {dp:.3g} (tol 1e-2); forward passes {forwards[0]},"
               f" K1 launches {launches} ({card})")
    if dp > 1e-2:
        raise AssertionError("mesh serving disagrees with the plain Predictor")
    if launches != DEPTH * forwards[0] or forwards[0] == 0:
        raise AssertionError(f"K1 launches {launches} != {DEPTH} x "
                             f"{forwards[0]} forward passes")
    del meshed, cpu_model
    torch.cuda.empty_cache()
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


def _near_check(got, exact, near, max_ulps):
    """(max abs err, ok, description) of a bf16 gradient of the fused op
    by the rule stated at HEADDIM_OWN_MARGIN: within ``max_ulps`` of
    ``near`` (the plain version run in bf16, which rounds ds and the
    weights as the kernels do), its worst entry against ``exact`` (the
    plain version in f32) at most HEADDIM_OWN_MARGIN ulps past the worst
    of ``near`` against it, both counted as _flash_check counts them, and
    the error's rms against ``exact`` within FLASH_RMS_REL of its rms."""
    got, exact, near = got.float(), exact.float(), near.float()
    err = float((got - exact).abs().max())
    floor = max(FLASH_ULP_FLOOR_SHARE * float(exact.abs().max()),
                BF16_ULP_FLOOR)
    to_exact = bf16_ulps(got, exact, floor)
    own = bf16_ulps(near, exact, floor)
    to_near = bf16_ulps(got, near, floor)
    rms = float((got - exact).pow(2).mean().sqrt())
    rms_ref = float(exact.pow(2).mean().sqrt())
    ok = (to_near <= max_ulps and to_exact <= own + HEADDIM_OWN_MARGIN
          and rms <= FLASH_RMS_REL * rms_ref + 1e-6)
    return err, ok, (f"{err:.3g} ({to_exact:.2f} ulps, the bf16 plain "
                     f"version {own:.2f}, {to_near:.2f} from it; rms "
                     f"{rms / max(rms_ref, 1e-30):.2g} of the plain rms)")


def _compare_fused(q, k, v, g, rate, seed, max_ulps=BF16_ULPS,
                   rounded=False):
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
    relative to and is left out. With ``rounded`` (kernel-headdims) the
    bf16 gradients are held entry by entry by _near_check instead."""
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
    if rounded and dtype == torch.bfloat16:
        # cuBLAS's bf16 products of the rounded version sum in f32.
        mm = torch.backends.cuda.matmul
        reduced = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = False
        try:
            near = fused.plain_fused_mha_backward(q, k, v, g, rate, seed,
                                                  out=out)
        finally:
            mm.allow_bf16_reduced_precision_reduction = reduced
        for name, a, b, n in zip(("dq", "dk", "dv"), grads, ref_grads, near):
            res[name] = _near_check(a, b, n, max_ulps)
    else:
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


class _Lines(logging.Handler):
    """The messages of the records a logger emits while attached."""

    def __init__(self, logger: str):
        super().__init__()
        self.lines, self._logger = [], logging.getLogger(logger)

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())

    def __enter__(self):
        self._logger.addHandler(self)
        return self.lines

    def __exit__(self, *exc):
        self._logger.removeHandler(self)


PIPELINE_LINE = "train batch pipeline: native C++ prefetcher"


def phase_native_batcher(e) -> None:
    """The host side of E1's input: ms a batch of 128 CIFAR-shaped uint8
    images from the native prefetcher and from the numpy iterator over a
    50,000-image train set, then E1's step (ViT-B/16, batch 128, bf16,
    the trained state) fed by each, per step with the batch's assembly
    and copy to the card inside."""
    phase = "native-batcher"
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (50_000, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 50_000).astype(np.int32)

    def native_batches():
        pf = native_batcher.NativePrefetcher(u8, y, E1_BATCH, seed=5)
        try:
            yield from pf.epoch_batches()
        finally:
            pf.close()

    def numpy_batches():
        return batch_iterator(u8, y, E1_BATCH, shuffle=True,
                              rng=np.random.default_rng(5), drop_last=True)

    host = {}
    for name, batches in (("native", native_batches),
                          ("numpy", numpy_batches)):
        t0 = time.perf_counter()
        n = sum(1 for _ in batches())
        host[name] = (time.perf_counter() - t0) / n * 1e3
        if n != len(u8) // E1_BATCH:
            raise AssertionError(f"{name}: {n} batches an epoch")
    log(phase, f"host ms a batch of {E1_BATCH} uint8 32x32x3 images (one "
               f"epoch of {len(u8) // E1_BATCH} batches, shuffled, copied "
               f"out): native C++ prefetcher {host['native']:.4f}, numpy "
               f"iterator {host['numpy']:.4f}")
    step = train.make_train_step(224, compute_dtype=torch.bfloat16)
    state, steps = e.state, 10
    for name, batches in (("native", native_batches),
                          ("numpy", numpy_batches), ("native", native_batches),
                          ("numpy", numpy_batches)):
        it = batches()
        state, _ = step(state, *next(it), 200)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(steps):
            state, m = step(state, *next(it), 201 + j)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        it.close()
        log(phase, f"E1 step fed by the {name} pipeline: {ms:.2f} ms per "
                   f"step (host clock, {steps} steps after a warm-up, the "
                   f"batch's assembly inside); last loss "
                   f"{float(m['loss_sum']) / E1_BATCH:.4f}")


def phase_e1() -> dict:
    """E1 ``traditional`` at ViT-B/16 through the CLI with the fused switch
    on (2 epochs, so that the mid-run probe fires), then one epoch with it
    off; each run must log that it drew its batches from the native
    prefetcher. After the first run, the native-batcher phase. Returns the
    fused launch counts of the first run."""
    phase = "e1"
    ops = (fused, flash, band)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, on, epochs in (("on", True, 2), ("off", False, 1)):
            for op in ops:
                op.reset_launch_count()
            with _fused_switch(on), _Lines(
                    "focused_attention_vit_tpu_torch.train.loop") as lines:
                e, passes, seconds, row = _e1_cli(tmp, epochs)
            if PIPELINE_LINE not in lines:
                raise AssertionError(f"E1 switch {label}: no "
                                     f"'{PIPELINE_LINE}' in {lines}")
            with _fused_switch(on):
                counts = {k: fused.launch_count(k)
                          for k in fused.LAUNCH_KINDS}
                others = [op.launch_count(k) for op in (flash, band)
                          for k in op.LAUNCH_KINDS]
                ms, peak = _step_time(e)
                sweep = {}
                if on:
                    out.update(counts)
                    sweep = {mb: _step_time(e, mb) for mb in (64, 32, 16)}
            log(phase, f"switch {label}: {PIPELINE_LINE} (logged)")
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
                with _fused_switch(on):
                    phase_native_batcher(e)
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


# --- export ------------------------------------------------------------------

EXPORT_BATCH = 32
EXPORT_SIZES = (1, 7, 32, 40)  # request sizes; 40 takes two batches
# Artifact against live, bf16 at 12 blocks: the serve phases' bound on
# served probabilities (the artifact is expected to equal the live path bit
# for bit; the bound only stands if it does not).
EXPORT_PROBS_TOL = 1e-2
E1_FUSED = ModelPath("e1-fused-", "ViT-B/16 (FAVIT_FUSED_MHA=1)",
                     VisionTransformer, "vit", fused, "fused", patch=16,
                     env={"FAVIT_FUSED_MHA": "1"}, idle_ops=(flash, band))


def phase_export(path: ModelPath, cpu_model, state_dict=None,
                 geom_flags=(), img: int = 224, batch: int = EXPORT_BATCH,
                 sizes=EXPORT_SIZES, depth: int = DEPTH, patch=None,
                 name=None, bit_equal: bool = False) -> dict:
    """``serve --export_artifact`` on ``path``'s model at full width with
    ``cpu_model``'s weights, in bf16 at batch 32 on the card, then ``serve
    --from_export``: the artifact's probabilities against the live
    Predictor's on the same requests, its kernel launches (counted inside
    the ``favit::`` ops) equal 12 x the artifact's forward passes, requests
    through ``BatchingServer`` and one ``POST /predict``, and a full batch
    timed from each (CUDA-event medians, in turns). An exported program
    takes one input shape, the model's 224x224 by default (JAX's rule), so
    the requests here are 224x224. Returns the artifact's launches and the
    times. ``state_dict``, ``geom_flags``, ``img``, ``batch``, ``sizes``,
    ``depth``, ``patch`` and ``name`` set another model (ViT-H/14: its
    weights in place of ``cpu_model``'s, its width flags, 518x518 requests,
    batch 8, 32 blocks, patch 14); with ``bit_equal`` the artifact's
    probabilities must equal the live path's bit for bit."""
    phase = path.phase("export")
    name = name or path.name
    rng = np.random.default_rng(6)

    def images(n):
        return rng.integers(0, 256, size=(n, img, img, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "w.pt")
        torch.save(cpu_model.state_dict() if state_dict is None
                   else state_dict, weights)
        flags = ["--model", path.flag, "--patch_size",
                 str(patch or path.patch), "--img_size", str(img),
                 "--compute_dtype", "bfloat16",
                 "--batch_size", str(batch), "--weights", weights,
                 *geom_flags]
        art = os.path.join(tmp, "artifact")
        t0 = time.perf_counter()
        serve.main([*flags, "--export_artifact", art])
        t_export = time.perf_counter() - t0
        with open(os.path.join(art, "meta.json")) as f:
            meta = json.load(f)
        size = os.path.getsize(os.path.join(art, "serving_fn.pt2"))
        t0 = time.perf_counter()
        _, exported = serve.setup(["--from_export", art])
        t_load = time.perf_counter() - t0
        _, live = serve.setup(flags)
    want_env = {k: path.env.get(k) for k in meta["trace_env"]}
    if meta["device"] != "cuda" or meta["trace_env"] != want_env or meta[
            "batch_size"] != batch:
        raise AssertionError(f"{phase}: meta {meta}, expected the cuda "
                             f"device and the trace environment {want_env}")
    log(phase, f"{name}: serve --export_artifact in {t_export:.1f} s "
               f"({size / 2**20:.1f} MiB program with its bf16 weights); "
               f"--from_export load and warm-up {t_load:.1f} s; meta {meta}")
    reqs = [images(n) for n in sizes]
    path.reset_counts()
    got = [exported.predict_proba(r) for r in reqs]
    torch.cuda.synchronize()
    launches = path.op.launch_count()
    path.check_idle(phase)
    passes = sum(-(-n // batch) for n in sizes)
    want = [live.predict_proba(r) for r in reqs]
    equal = all(np.array_equal(a, b) for a, b in zip(got, want))
    dp = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    for r, a in zip(reqs, got):
        _check_probs(a, len(r))
    log(phase, f"requests of {list(sizes)} images: artifact against "
               f"the live Predictor bit-equal: {equal}, max |d probs| {dp:.3g} "
               f"(tol {EXPORT_PROBS_TOL}); {path.op_name} launches "
               f"{launches} inside the ops for {passes} forward passes")
    if dp > EXPORT_PROBS_TOL or (bit_equal and not equal):
        raise AssertionError(f"{phase}: the artifact disagrees with the live "
                             f"path")
    if launches != depth * passes:
        raise AssertionError(f"{phase}: {path.op_name} launches {launches} "
                             f"!= {depth} x {passes} forward passes")

    path.reset_counts()
    with serve.BatchingServer(exported, max_delay_ms=5.0, workers=2) as srv, \
            serve.HTTPFrontend(srv, host="127.0.0.1", port=0) as fe:
        with ThreadPoolExecutor(max_workers=4) as pool:
            outs = list(pool.map(
                lambda r: srv.submit(r).result(timeout=300), reqs))
        http_out = _post(f"http://{fe.host}:{fe.port}", reqs[1])
    served = max(float(np.abs(a - b).max())
                 for a, b in zip(outs + [http_out], want + [want[1]]))
    launches += path.op.launch_count()
    log(phase, f"BatchingServer ({len(reqs)} concurrent requests) and one "
               f"POST /predict on the artifact: max |d probs| against the "
               f"live path {served:.3g} (tol {EXPORT_PROBS_TOL})")
    if served > EXPORT_PROBS_TOL:
        raise AssertionError(f"{phase}: served artifact probabilities "
                             f"disagree with the live path")

    full = images(batch)
    times = {"live": [], "artifact": []}
    for which in ("live", "artifact", "artifact", "live"):
        p = live if which == "live" else exported
        times[which].append(cuda_median_ms(lambda: p._fwd(full), repeats=10,
                                           warmup=2))
    live_ms = statistics.mean(times["live"])
    art_ms = statistics.mean(times["artifact"])
    log(phase, f"a batch of {batch} (uint8 to probs on the card, "
               f"CUDA-event medians of 10, in turns live, artifact, artifact, "
               f"live): live {times['live']} ms, artifact "
               f"{times['artifact']} ms; artifact / live "
               f"{art_ms / live_ms:.4f}")
    del live, exported
    torch.cuda.empty_cache()
    return {"launches": launches, "live_ms": live_ms, "artifact_ms": art_ms}


def phase_export_fused() -> int:
    """The export phase for ViT-B/16 with the fused short-S attention on
    (K3's eval forward through ``favit::fused_mha_fwd``)."""
    cpu_model = E1_FUSED.build(
        generator=torch.Generator().manual_seed(7)).eval()
    with _environ(E1_FUSED.env):
        out = phase_export(E1_FUSED, cpu_model)
    return out["launches"]


# --- train-flags -------------------------------------------------------------

# The bf16 first moment against the f32 one over a few steps from the same
# state and batches: mean CE losses within this (the moment's rounding,
# 2^-9 relative, moves each update by about as much).
MU_LOSS_TOL = 1e-2


def _opt_state_bytes(state) -> int:
    return sum(t.numel() * t.element_size()
               for st in state.tx.adamw.state.values()
               for k, t in st.items() if k != "step")


def _flags_step(path, remat, policy, u8, y, steps=3, mu_dtype=None,
                **model_kw):
    """A fresh model of ``path`` (seed 8) with ``remat``/``remat_policy``:
    ``steps`` bf16-autocast train steps on one batch after a warm-up step.
    Returns the first step's loss, grads and launches, and the steady
    step's ms, peak memory and optimizer-state bytes."""
    kw = dict(model_kw)
    if remat:
        kw["remat"] = True
    if policy:
        kw["remat_policy"] = policy
    model = path.build(device="cuda",
                       generator=torch.Generator().manual_seed(8), **kw)
    state = train.create_train_state(model, train.make_adamw(
        1e-4, mu_dtype=mu_dtype))
    step = train.make_train_step(224, compute_dtype=torch.bfloat16)
    path.reset_counts()
    _, m = step(state, u8, y, 11)
    torch.cuda.synchronize()
    launches = {k: path.op.launch_count(k) for k in path.op.LAUNCH_KINDS}
    out = {"loss": float(m["loss_sum"]) / len(y),
           "grads": _leaf_grads(model), "launches": launches}
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for j in range(steps):
        _, m = step(state, u8, y, 12 + j)
        losses.append(float(m["loss_sum"]) / len(y))
    torch.cuda.synchronize()
    out.update(ms=(time.perf_counter() - t0) / steps * 1e3,
               peak=torch.cuda.max_memory_allocated() / 2**30,
               losses=losses, opt_bytes=_opt_state_bytes(state))
    del model, state
    torch.cuda.empty_cache()
    return out


def _grad_parity(ref: dict, got: dict):
    worst, name = 0.0, ""
    for n, r in ref.items():
        bound = PARITY_GRAD_REL * float(r.abs().max()) + PARITY_GRAD_ABS
        err = float((got[n] - r).abs().max()) / bound
        if err > worst:
            worst, name = err, n
    return worst, name


def phase_train_flags(path: ModelPath, policies, profile: bool) -> dict:
    """``path``'s model (12 blocks, batch 32, bf16 autocast, dropout 0.1,
    and attention dropout 0.1 where the op drops in its kernel) trained
    without remat, with full remat and with each of ``policies``: the
    first step's loss and gradients agree with the no-remat step (the
    train-parity tolerances), the training forward launches once a block a
    step without remat, twice under full remat, once under
    ``band_weights``, and the backward once; step time and peak memory of
    each. Then the bf16 first moment against the f32 one: the optimizer's
    state bytes and the losses over four steps. With ``profile``, one
    ``utils.profiling.trace`` of a step, whose file must name the op's
    kernels. Returns the launch counts of the remat runs."""
    from focused_attention_vit_tpu_torch.utils import profiling

    phase = path.phase("train-flags")
    rng = np.random.default_rng(9)
    u8 = _images(rng, TRAIN_BATCH)
    y = rng.integers(0, 10, size=TRAIN_BATCH)
    model_kw = dict(dropout=TRAIN_DROPOUT)
    if path is MHLA:
        model_kw["attn_dropout"] = TRAIN_DROPOUT
    kind = path.train_fwd_kind
    runs = {"no remat": (False, None, 1)}
    runs["remat"] = (True, None, 2)
    for policy in policies:
        runs[f"remat {policy}"] = (True, policy, 1)
    base, total = None, dict.fromkeys(path.op.LAUNCH_KINDS, 0)
    for label, (remat, policy, fwd_per_block) in runs.items():
        r = _flags_step(path, remat, policy, u8, y, **model_kw)
        for k, c in r["launches"].items():
            if label != "no remat":
                total[k] += c
        want = dict.fromkeys(path.op.LAUNCH_KINDS, 0)
        want[kind] = DEPTH * fwd_per_block
        want["bwd"] = DEPTH
        msg = (f"{path.name}, {label}: {r['ms']:.2f} ms a step (host clock, "
               f"mean of 3 after a warm-up), peak memory {r['peak']:.2f} GiB "
               f"(max_memory_allocated); first step's launches "
               f"{r['launches']}")
        if base is None:
            base = r
        else:
            worst, name = _grad_parity(base["grads"], r["grads"])
            d_loss = abs(r["loss"] - base["loss"])
            msg += (f"; against no remat: loss |d| {d_loss:.3g} (tol "
                    f"{PARITY_LOSS_TOL}), worst gradient leaf "
                    f"{name or '(all equal)'} at {worst:.3f} of its "
                    f"tolerance")
            if d_loss > PARITY_LOSS_TOL or worst > 1.0:
                raise AssertionError(f"{phase}: {label} disagrees with the "
                                     f"step without remat")
        log(phase, msg)
        if r["launches"] != want:
            raise AssertionError(f"{phase}: {label}: launches "
                                 f"{r['launches']} != {want}")
        path.check_idle(phase)
        del r

    ref = _flags_step(path, False, None, u8, y, **model_kw)
    bf16 = _flags_step(path, False, None, u8, y, mu_dtype=torch.bfloat16,
                       **model_kw)
    d = max(abs(a - b) for a, b in zip(ref["losses"], bf16["losses"]))
    ratio = bf16["opt_bytes"] / ref["opt_bytes"]
    log(phase, f"{path.name}, AdamW state: f32 first moment "
               f"{ref['opt_bytes']} bytes, bf16 first moment "
               f"{bf16['opt_bytes']} bytes ({ratio:.4f} of it); losses over "
               f"steps 2-4 f32 {[round(x, 5) for x in ref['losses']]}, bf16 "
               f"{[round(x, 5) for x in bf16['losses']]}, max |d| {d:.3g} "
               f"(tol {MU_LOSS_TOL}); step {ref['ms']:.2f} / "
               f"{bf16['ms']:.2f} ms, peak {ref['peak']:.2f} / "
               f"{bf16['peak']:.2f} GiB")
    if not (np.isfinite(bf16["losses"]).all() and d <= MU_LOSS_TOL
            and abs(ratio - 0.75) < 1e-3):
        raise AssertionError(f"{phase}: the bf16 first moment's run is off")

    if profile:
        with tempfile.TemporaryDirectory() as tmp:
            model = path.build(depth=2, device="cuda",
                               generator=torch.Generator().manual_seed(8),
                               **model_kw)
            state = train.create_train_state(model, train.make_adamw(1e-4))
            step = train.make_train_step(224, compute_dtype=torch.bfloat16)
            step(state, u8, y, 1)
            with profiling.trace(tmp):
                step(state, u8, y, 2)
                torch.cuda.synchronize()
            trace_path = os.path.join(tmp, profiling.TRACE_FILE)
            text = open(trace_path).read()
            names = ("band_fwd_kernel", "band_bwd_query_kernel",
                     "band_bwd_key_kernel")
            found = {n: text.count(n) for n in names}
            log(phase, f"utils.profiling.trace of one 2-block step: "
                       f"{os.path.getsize(trace_path)} bytes, kernel names "
                       f"found {found}")
            if not all(found.values()):
                raise AssertionError(f"{phase}: the trace does not name the "
                                     f"band kernels: {found}")
            del model, state
        torch.cuda.empty_cache()
    return total


# --- ViT-H/14 at 518x518: the band and flash kernels' range on a main path --

# ViT-H/14 (Dosovitskiy et al., "An Image is Worth 16x16 Words", Table 1):
# D = 1280, 32 blocks, 16 heads of d = 80, MLP 5120, patch 14, at 518x518,
# the resolution the paper fine-tunes H/14 at: S = 37^2 + 1 = 1370. At
# batch 8 the band is B*h = 128 rows of [80, 1370] (S-minor) and the flash
# op 128 heads of [1370, 80].
H14_IMG, H14_PATCH, H14_DIM, H14_DEPTH, H14_HEADS = 518, 14, 1280, 32, 16
H14_HEAD_DIM = H14_DIM // H14_HEADS
H14_S = (H14_IMG // H14_PATCH) ** 2 + 1
H14_BATCH = 8
H14_BAND_SHAPE = (H14_BATCH, H14_HEADS, H14_HEAD_DIM, H14_S)
H14_FLASH_SHAPE = (H14_BATCH, H14_HEADS, H14_S, H14_HEAD_DIM)
# The model's window, both sides of the slot groups (16 | 17), an even
# window and JAX's roll-band limit.
H14_WINDOWS = (7, 17, 64, 129)
H14_WIDE_W = 129
# A padded head dim (24 -> 32), ViT-H/14's, and the widest.
H14_FLASH_DIMS = (24, 80, 256)
# The default ViT-H/14 models (K1/K2, K5) run cut to 8 of the 32 blocks, to
# hold the smoke's time as the later paths joined it; the opt-in ones
# (K3/K4, K6/K7) run all 32. Their kernels run at full width either way.
H14_DEFAULT_DEPTH = 8
H14_STEPS = 3
H14_SIZES = (1, 8, 12)  # requests; 12 takes two batches of 8


def _wide_bwd_worst(got, ref, dtype, f32_tol):
    """``_worst`` for the band's gradients past 16 slots: f32 within
    ``f32_tol``; bf16 entry by entry within BF16_ULPS ulps or ``f32_tol``
    abs. Each gradient sums up to W = 129 slot terms, in another order than
    the plain version's, so the two sides' f32 sums differ by up to about
    1e-4 before the one rounding (the f32 rows of kernel-h14); past 2 ulps
    of an entry that cancels to near 0 that difference shows. This is the
    bf16 backward's rule of tests/test_torch_gpu.py (absolute bound
    1e-4)."""
    if dtype == torch.float32:
        return _worst(got, ref, dtype, f32_tol)
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(BF16_ULP_FLOOR))) - 7)
    ulps = float((err / ulp).max())
    ok = not bool((err > torch.clamp_min(BF16_ULPS * ulp, f32_tol)).any())
    return float(err.max()), ok, (f"{float(err.max()):.3g} ({ulps:.2f} "
                                  f"ulps; within {BF16_ULPS} ulps or "
                                  f"{f32_tol} abs)")


def _h14_times(fns: dict, reps: int = 30) -> dict:
    """CUDA-event medians of the kernels (``reps``) and of the plain
    versions (5: they take tens of ms here)."""
    return {name: cuda_median_ms(fn, 5, 1) if name.endswith("plain")
            else cuda_median_ms(fn, reps) for name, fn in fns.items()}


def phase_kernel_h14() -> dict:
    """K1 (eval, training at dropout 0 and 0.1), K2 and the dropout words at
    the ViT-H/14 band shape for each window of H14_WINDOWS, and K5's three
    forms at d in H14_FLASH_DIMS, against their plain versions in f32 and
    bf16 by the rules of the kernel, kernel-train and kernel-flash phases;
    each bf16 form timed beside its plain version, its bound and PyTorch's
    fused attention. Returns {"band": {W: forms}, "flash": {d: forms}}."""
    import torch.nn.functional as F  # the library call, timed as a yardstick

    phase = "kernel-h14"
    gen = torch.Generator(device="cuda").manual_seed(19)

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(4)]

    def check(where, res):
        bad = [f"{n} {t}" for n, (_, ok, t) in res.items() if not ok]
        if bad:
            raise AssertionError(f"{phase}: kernels disagree with the plain "
                                 f"versions at {where}: {bad}")

    b, h, d, s = H14_BAND_SHAPE
    seed = 2**41 + 19
    result = {"band": {}, "flash": {}}
    for w in H14_WINDOWS:
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            q, k, v, g = inputs(H14_BAND_SHAPE, dtype)
            res = {"eval": _worst(band.roll_banded_attention(q, k, v, w),
                                  band.plain_banded_attention(q, k, v, w),
                                  dtype, F32_TOL)}
            for rate, sd in ((0.0, None), (TRAIN_DROPOUT, seed)):
                for n, r in _compare_train(
                        q, k, v, g, w, rate, sd,
                        _wide_bwd_worst if w > 16 else None).items():
                    res[f"{n}@{rate}"] = r
            check(f"{H14_BAND_SHAPE} W={w} {dt}", res)
            log(phase, f"band B,h,d,S={H14_BAND_SHAPE} W={w} {dt}, dropout 0 "
                       f"and {TRAIN_DROPOUT}: max abs err " + ", ".join(
                           f"{n} {t}" for n, (_, _, t) in res.items()))
            if dtype == torch.float32:
                continue
            out, wts = band.band_forward_train(q, k, v, w, TRAIN_DROPOUT,
                                               seed)
            library = band_library_call(s, w, dtype)
            times = _h14_times({
                "fwd": lambda: band.roll_banded_attention(q, k, v, w),
                "fwd_plain": lambda: band.plain_banded_attention(q, k, v, w),
                "fwd_train": lambda: band.band_forward_train(
                    q, k, v, w, TRAIN_DROPOUT, seed),
                "fwd_train_plain": lambda: band.plain_band_forward_train(
                    q, k, v, w, TRAIN_DROPOUT, seed),
                "bwd": lambda: band.band_backward(q, k, v, g, wts, w,
                                                  TRAIN_DROPOUT, seed),
                "bwd_plain": lambda: band.plain_band_backward(
                    q, k, v, g, wts, w, TRAIN_DROPOUT, seed),
            })
            with torch.no_grad():
                times["fwd_library"] = cuda_median_ms(lambda: library(q, k, v))
                times["fwd_train_library"] = cuda_median_ms(
                    lambda: library(q, k, v, TRAIN_DROPOUT))
            times["bwd_library"] = backward_ms(
                lambda *a: library(*a, TRAIN_DROPOUT), (q, k, v),
                g.transpose(-1, -2).contiguous())
            one = q.numel() * q.element_size()
            pairs = b * h * s * w * d
            errs = {n: e for n, (e, _, _) in res.items()}
            result["band"][w] = dict(
                fwd=dict(max_abs_err=errs["eval"], ms=times["fwd"],
                         plain_ms=times["fwd_plain"],
                         library_ms=times["fwd_library"],
                         **least_time(4 * one, 4 * pairs)),
                fwd_train=dict(
                    max_abs_err=max(errs[f"{n}@{r}"] for n in ("out", "wts")
                                    for r in (0.0, TRAIN_DROPOUT)),
                    ms=times["fwd_train"], plain_ms=times["fwd_train_plain"],
                    library_ms=times["fwd_train_library"],
                    **least_time(4 * one + wts.numel() * 4, 4 * pairs)),
                bwd=dict(
                    max_abs_err=max(errs[f"{n}@{r}"]
                                    for n in ("dq", "dk", "dv")
                                    for r in (0.0, TRAIN_DROPOUT)),
                    ms=times["bwd"], plain_ms=times["bwd_plain"],
                    library_ms=times["bwd_library"],
                    **least_time(7 * one + wts.numel() * 4, 10 * pairs)),
            )
            log(phase, f"band W={w} bf16, kernel / plain / PyTorch's fused "
                       f"attention with the band's mask, ms (CUDA-event "
                       f"medians of 30, plain of 5; dropout "
                       f"{TRAIN_DROPOUT} in the training forms): " + "; ".join(
                           f"{kind} {r['ms']:.4f} / {r['plain_ms']:.4f} / "
                           f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                           f"({r['bound_by']})"
                           for kind, r in result["band"][w].items()))
            del q, k, v, g, out, wts
            torch.cuda.empty_cache()
        if w > 16:
            bits = band.keep_bits(b * h, w, s, seed, "cuda").cpu()
            if not torch.equal(bits, band.keep_bits(b * h, w, s, seed,
                                                    "cpu")):
                raise AssertionError(f"{phase}: the kernels' dropout words "
                                     f"differ from the plain generator's at "
                                     f"W={w}")
            log(phase, f"dropout words at B*h={b * h}, W={w}, S={s}: "
                       f"identical to the plain generator's "
                       f"({bits.numel()} words)")
            del bits

    fb, fh, fs, _ = H14_FLASH_SHAPE
    for fd in H14_FLASH_DIMS:
        shape = (fb, fh, fs, fd)
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            q, k, v, g = inputs(shape, dtype)
            res = _compare_flash(q, k, v, g)
            check(f"flash {shape} {dt}", res)
            log(phase, f"flash B,h,S,d={shape} {dt}: max abs err " + ", ".join(
                f"{n} {t}" for n, (_, _, t) in res.items()))
            if dtype == torch.float32:
                continue
            out, lse = flash.flash_forward_train(q, k, v)
            again = [flash.flash_backward(q, k, v, out, lse, g)
                     for _ in range(2)]
            if not all(torch.equal(a, b_) for a, b_ in zip(*again)):
                raise AssertionError(f"{phase}: two flash backward runs "
                                     f"differ at d={fd}")
            del again
            times = _h14_times({
                "fwd": lambda: flash.flash_attention(q, k, v),
                "fwd_train": lambda: flash.flash_forward_train(q, k, v),
                "bwd": lambda: flash.flash_backward(q, k, v, out, lse, g),
                "fwd_plain": lambda: flash.plain_flash_forward(q, k, v),
                "bwd_plain": lambda: flash.plain_flash_backward(
                    q, k, v, out, lse, g),
            })
            with torch.no_grad():
                times["fwd_library"] = cuda_median_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v))
            lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
            times["fwd_train_library"] = cuda_median_ms(
                lambda: F.scaled_dot_product_attention(lq, lk, lv))
            times["bwd_library"] = backward_ms(
                F.scaled_dot_product_attention, (q, k, v), g)
            del lq, lk, lv
            errs = {n: e for n, (e, _, _) in res.items()}
            one = q.numel() * q.element_size()
            pairs = fb * fh * fs * fs * fd
            result["flash"][fd] = dict(
                fwd=dict(max_abs_err=errs["out_eval"], ms=times["fwd"],
                         plain_ms=times["fwd_plain"],
                         library_ms=times["fwd_library"],
                         **least_time(4 * one, 4 * pairs)),
                fwd_train=dict(max_abs_err=max(errs["out"], errs["lse"]),
                               ms=times["fwd_train"],
                               plain_ms=times["fwd_plain"],
                               library_ms=times["fwd_train_library"],
                               **least_time(4 * one + lse.numel() * 4,
                                            4 * pairs)),
                bwd=dict(max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
                         ms=times["bwd"], plain_ms=times["bwd_plain"],
                         library_ms=times["bwd_library"],
                         **least_time(8 * one + lse.numel() * 4,
                                      10 * pairs)),
            )
            log(phase, f"flash d={fd} bf16, kernel / plain / PyTorch's fused "
                       f"attention, ms (CUDA-event medians of 30, plain of "
                       f"5; two backward runs bit-identical): " + "; ".join(
                           f"{kind} {r['ms']:.4f} / {r['plain_ms']:.4f} / "
                           f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                           f"({r['bound_by']}), "
                           f"{r['bound_ms'] / r['ms']:.3f} of it"
                           for kind, r in result["flash"][fd].items()))
            del q, k, v, g, out, lse
            torch.cuda.empty_cache()
    return result


# --- ViT-H/14 through the opt-in kernels (K3/K4, K6/K7/K8) at JAX's range --

# K3/K4 at B*h = 128 (batch 8 x 16 heads), S = 65 and 257 (ViT-H/14 at
# 224^2): the whole-row kernel at S = 65 up to D = 128 and the flash blocks
# with the mask past it and at 257; S = 64 at d = 256 takes the whole-row
# kernel there. K6/K7/K8 at MHLA-H/14's band, B*h = 128, S = 1370, at the
# four windows of kernel-h14 (JAX's halo 16, 32, 64, 64). Head dims: a padded
# one (24 -> 32), ViT-H/14's and the widest.
H14_OPTIN_DIMS = (24, 80, 256)
H14_FUSED_SEQS = (65, 257)
H14_FUSED_IMG = 224
H14_FUSED_S = (H14_FUSED_IMG // H14_PATCH) ** 2 + 1


def _optin_check(failures, where, res):
    """Record the forms of ``res`` that missed their rule."""
    bad = [f"{n} {t}" for n, (_, ok, t) in res.items() if not ok]
    if bad:
        failures.append(f"{where}: {bad}")


def _window_inputs(q, k, v, w):
    """K8's window tiles of [B*h, S, d] q, k, v at JAX's tile length, and
    the band as a boolean mask over them: (qt, ke, ve, mask, t)."""
    bh, s, d = q.shape
    hw = w // 2
    halo = tile._halo(tile.DEFAULT_BLOCK, hw)
    t = max(2 * halo, min(tile.DEFAULT_BLOCK, -(-s // 8) * 8))
    sp = -(-s // t) * t
    ke, ve = (tile._window_tiles(x, t, halo, sp) for x in (k, v))
    qt = tile._pad_seq(q, 0, sp - s).reshape(bh, sp // t, t, d).contiguous()
    mask = tile._band_mask(t, t + 2 * halo, halo, hw, "cuda")
    return qt, ke, ve, mask, t


def _tile_times(q, k, v, g, w, gen, reps=10):
    """bf16 K6, K7 and K8 (on prebuilt window tiles) beside their plain
    versions and PyTorch's fused attention on the window tiles with the band
    as a boolean mask (and its backward for K7), CUDA-event medians; with
    the window tiles' bytes for K8's bound."""
    import torch.nn.functional as F  # the library call, timed as a yardstick

    bh, s, d = q.shape
    hw = w // 2
    qt, ke, ve, mask, t = _window_inputs(q, k, v, w)
    with torch.no_grad():
        times = {
            "fwd": cuda_median_ms(lambda: tile.tile_band_forward(q, k, v, w),
                                  reps),
            "bwd": cuda_median_ms(
                lambda: tile.tile_band_backward(q, k, v, g, w), reps),
            "fwd_b": cuda_median_ms(
                lambda: tile.window_tile_band(qt, ke, ve, w), reps),
            "fwd_plain": cuda_median_ms(
                lambda: tile.plain_tile_band_forward(q, k, v, w), 3, 1),
            "bwd_plain": cuda_median_ms(
                lambda: tile.plain_bwd_rule(q, k, v, g, w), 3, 1),
            "fwd_b_plain": cuda_median_ms(
                lambda: tile.plain_window_tile_band(qt, ke, ve, w), 3, 1),
            "library": cuda_median_ms(lambda: F.scaled_dot_product_attention(
                qt, ke, ve, attn_mask=mask), reps),
        }
    gt = torch.randn(qt.shape, device="cuda", generator=gen).to(q.dtype)
    times["library_bwd"] = backward_ms(
        lambda *a: F.scaled_dot_product_attention(*a, attn_mask=mask),
        (qt, ke, ve), gt)
    tile_bytes = sum(x.numel() * x.element_size() for x in (qt, ke, ve, qt))
    tile_pairs = qt.numel() // d * (2 * hw + 1) * d
    return times, tile_bytes, tile_pairs, t


def phase_kernel_h14_optin() -> dict:
    """The opt-in kernels at ViT-H/14's shapes and JAX's range: K3 (eval,
    training at dropout 0 and 0.1) and K4 at B*h = 128, S in H14_FUSED_SEQS
    (and 64 at d = 256), d in H14_OPTIN_DIMS, with the dropout words
    against the plain generator; K6, K7 (folded) and K8 at B*h = 128,
    S = 1370, d in H14_OPTIN_DIMS, W in H14_WINDOWS; each in f32 and bf16
    against its plain version by the rules of kernel-fused and
    kernel-tileband, and each bf16 form timed beside its plain version, its
    bound and PyTorch's fused attention. Returns {"fused": {(d, S): forms},
    "tile": {(d, W): forms}, "fwd_b_launches": K8's launches}."""
    import torch.nn.functional as F  # the library call, timed as a yardstick

    phase = "kernel-h14-optin"
    gen = torch.Generator(device="cuda").manual_seed(20)
    failures = []

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(4)]

    seed = 2**41 + 20
    rate = TRAIN_DROPOUT
    result = {"fused": {}, "tile": {}}
    cases = [(d, s) for d in H14_OPTIN_DIMS for s in H14_FUSED_SEQS]
    for d, s in cases + [(256, 64)]:
        shape = (H14_BATCH, H14_HEADS, s, d)
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            q, k, v, g = inputs(shape, dtype)
            # kernel-fused's rule for its loose cases: FUSED_LOOSE_ULPS entry
            # by entry (a 10^6-entry bf16 tensor's worst entry lies in the
            # tail of the weights' rounding noise) and the rms bound.
            res = {}
            for r, sd in ((0.0, None), (rate, seed)):
                for n, x in _compare_fused(q, k, v, g, r, sd,
                                           FUSED_LOOSE_ULPS).items():
                    res[f"{n}@{r}"] = x
            _optin_check(failures, f"fused {shape} {dt}", res)
            log(phase, f"fused B,h,S,d={shape} {dt}, dropout 0 and {rate}: "
                       f"max abs err " + ", ".join(
                           f"{n} {t}" for n, (_, _, t) in res.items()))
            if dtype == torch.float32 or (d, s) not in cases:
                continue
            out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
            again = [fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
                     for _ in range(2)]
            if not all(torch.equal(a, b_) for a, b_ in zip(*again)):
                raise AssertionError(f"{phase}: two fused backward runs "
                                     f"differ at {shape}")
            del again
            with torch.no_grad():
                times = {
                    "fwd": cuda_median_ms(
                        lambda: fused.fused_multi_head_attention(q, k, v),
                        30, batch=10),
                    "fwd_train": cuda_median_ms(
                        lambda: fused.fused_mha_forward_train(q, k, v, rate,
                                                              seed),
                        30, batch=10),
                    "bwd": cuda_median_ms(
                        lambda: fused.fused_mha_backward(
                            q, k, v, out, lse, g, rate, seed), 30, batch=10),
                    "fwd_plain": cuda_median_ms(
                        lambda: fused.plain_fused_mha_forward(q, k, v), 5, 1),
                    "fwd_train_plain": cuda_median_ms(
                        lambda: fused.plain_fused_mha_forward(q, k, v, rate,
                                                              seed), 5, 1),
                    "bwd_plain": cuda_median_ms(
                        lambda: fused.plain_fused_mha_backward(
                            q, k, v, g, rate, seed, out=out), 5, 1),
                    "fwd_library": cuda_median_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v), 30,
                        batch=10),
                }
            times.update(_fused_library_times(q, k, v, g, rate, 30, 10))
            errs = {n: e for n, (e, _, _) in res.items()}
            one = q.numel() * q.element_size()
            pairs = H14_BATCH * H14_HEADS * s * s * d
            # The bounds of kernel-fused: q, k, v in and out back, two
            # products forward; q, k, v, g in and dq, dk, dv back, five
            # backward.
            result["fused"][(d, s)] = dict(
                fwd=dict(max_abs_err=errs["out_eval@0.0"], ms=times["fwd"],
                         plain_ms=times["fwd_plain"],
                         library_ms=times["fwd_library"],
                         **least_time(4 * one, 4 * pairs)),
                fwd_train=dict(
                    max_abs_err=max(errs[f"{n}@{r}"] for n in ("out", "lse")
                                    for r in (0.0, rate)),
                    ms=times["fwd_train"], plain_ms=times["fwd_train_plain"],
                    library_ms=times["fwd_train_library"],
                    **least_time(4 * one, 4 * pairs)),
                bwd=dict(
                    max_abs_err=max(errs[f"{n}@{r}"]
                                    for n in ("dq", "dk", "dv")
                                    for r in (0.0, rate)),
                    ms=times["bwd"], plain_ms=times["bwd_plain"],
                    library_ms=times["bwd_library"],
                    **least_time(7 * one, 10 * pairs)),
            )
            log(phase, f"fused d={d} S={s} bf16, kernel / plain / PyTorch's "
                       f"fused attention, ms (CUDA-event medians of 30 "
                       f"batches of 10, plain of 5; dropout {rate} in the "
                       f"training forms; two backward runs bit-identical): "
                       + "; ".join(
                           f"{kind} {r['ms']:.4f} / {r['plain_ms']:.4f} / "
                           f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                           f"({r['bound_by']})"
                           for kind, r in result["fused"][(d, s)].items()))
            if (d, s) == (H14_HEAD_DIM, H14_FUSED_S):
                # K3 at dense ViT-H/14's 224^2 shape on the device alone
                # (the profiler's ms a call, summed over its kernels): is its
                # time over the library's in batches of calls the kernel's
                # or the host's?
                try:
                    with torch.no_grad():
                        dev = {n: sum(profile_device_ms(fn).values())
                               for n, fn in (
                                   ("K3 eval", lambda: (
                                       fused.fused_multi_head_attention(
                                           q, k, v))),
                                   ("K3 training", lambda: (
                                       fused.fused_mha_forward_train(
                                           q, k, v, rate, seed))),
                                   ("library", lambda: (
                                       F.scaled_dot_product_attention(
                                           q, k, v))),
                                   ("library with dropout", lambda: (
                                       F.scaled_dot_product_attention(
                                           q, k, v, dropout_p=rate))))}
                    log(phase, f"fused d={d} S={s} bf16, device ms a call "
                               f"(torch.profiler, 20 calls): " + ", ".join(
                                   f"{n} {t:.4f}" for n, t in dev.items()))
                except NoDeviceTime:
                    log(phase, f"fused d={d} S={s}: the profiler recorded "
                               f"no device time")
            del q, k, v, g, out, lse
            torch.cuda.empty_cache()
    for s in H14_FUSED_SEQS:
        rows = H14_BATCH * H14_HEADS
        bits = fused.keep_bits(rows, s, seed, "cuda")
        if not torch.equal(bits, philox.mha_keep_bits(rows, s, seed, "cuda")):
            raise AssertionError(f"{phase}: the fused kernels' dropout words "
                                 f"differ from the plain generator's at S={s}")
        log(phase, f"fused dropout words at B*h={rows}, S={s}: identical to "
                   f"the plain generator's ({bits.numel()} words)")
        del bits

    tile.reset_launch_count()
    bh = H14_BATCH * H14_HEADS
    for d in H14_OPTIN_DIMS:
        for w in H14_WINDOWS:
            for dtype in (torch.float32, torch.bfloat16):
                dt = "f32" if dtype == torch.float32 else "bf16"
                q, k, v, g = inputs((bh, H14_S, d), dtype)
                res = _tile_compare(q, k, v, g, w)
                _optin_check(failures,
                             f"tile ({bh}, {H14_S}, {d}) W={w} {dt}", res)
                log(phase, f"tile band B*h,S,d=({bh}, {H14_S}, {d}) W={w} "
                           f"{dt}: max abs err " + ", ".join(
                               f"{n} {t}" for n, (_, _, t) in res.items()))
                if dtype == torch.float32:
                    continue
                first = tile.tile_band_backward(q, k, v, g, w)
                second = tile.tile_band_backward(q, k, v, g, w)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b_) for a, b_ in zip(first,
                                                               second)):
                    raise AssertionError(f"{phase}: two K7 runs differ at "
                                         f"d={d} W={w}")
                del first, second
                times, tile_bytes, tile_pairs, t = _tile_times(
                    q, k, v, g, w, gen)
                one = q.numel() * q.element_size()
                pairs = bh * H14_S * (2 * (w // 2) + 1) * d
                errs = {n: e for n, (e, _, _) in res.items()}
                # kernel-tileband's bounds: K6 reads q, k, v and writes out
                # (two products of 2 hw + 1 keys a query); K7 reads q, k, v,
                # g and writes dq, dk, dv (five products); K8 reads the q
                # tiles and both window tensors and writes the out tiles.
                result["tile"][(d, w)] = dict(
                    fwd=dict(max_abs_err=errs["fwd"], ms=times["fwd"],
                             plain_ms=times["fwd_plain"],
                             library_ms=times["library"],
                             **least_time(4 * one, 4 * pairs)),
                    bwd=dict(max_abs_err=max(errs[n] for n in ("dq", "dk",
                                                               "dv")),
                             ms=times["bwd"], plain_ms=times["bwd_plain"],
                             library_ms=times["library_bwd"],
                             **least_time(7 * one, 10 * pairs)),
                    fwd_b=dict(max_abs_err=errs["fwd_b"], ms=times["fwd_b"],
                               plain_ms=times["fwd_b_plain"],
                               library_ms=times["library"],
                               **least_time(tile_bytes, 4 * tile_pairs)),
                )
                log(phase, f"tile band d={d} W={w} bf16 (K8 on window tiles "
                           f"of {t} + {2 * tile._halo(0, w // 2)} rows), "
                           f"kernel / plain / PyTorch's fused attention on "
                           f"the window tiles with the band as a mask, ms "
                           f"(CUDA-event medians of 10, plain of 3; two K7 "
                           f"runs bit-identical): " + "; ".join(
                               f"{kind} {r['ms']:.4f} / {r['plain_ms']:.4f} "
                               f"/ {r['library_ms']:.4f}, bound "
                               f"{r['bound_ms']:.4f} ({r['bound_by']})"
                               for kind, r in
                               result["tile"][(d, w)].items()))
                del q, k, v, g
                torch.cuda.empty_cache()
    result["fwd_b_launches"] = tile.launch_count("fwd_b")
    if failures:
        raise AssertionError(f"{phase}: kernels disagree with the plain "
                             f"versions at " + "; ".join(failures))
    return result


def _h14_flax_tree(mhla: bool, depth: int, seed: int,
                   img: int = H14_IMG, dim: int = H14_DIM,
                   h: int = H14_HEADS, patch: int = H14_PATCH) -> dict:
    """A seeded parameter tree in the JAX package's Flax layout (what a JAX
    checkpoint of the model holds): ViT-H/14's widths (or ``dim``, ``h``
    heads and ``patch``), ``depth`` blocks, 10 classes, the position table
    of ``img``; weights N(0, 0.02^2), biases 0, LayerNorm scales 1."""
    gen = torch.Generator().manual_seed(seed)  # torch.randn: all cores
    hd, mlp = dim // h, 4 * dim
    tokens = (img // patch) ** 2 + 1

    def normal(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).numpy()

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def norm():
        return {"scale": np.ones(dim, np.float32),
                "bias": np.zeros(dim, np.float32)}

    tree = {"patch_embed": {"projection": dense(patch ** 2 * 3, dim)},
            "cls_token": normal(1, 1, dim),
            "pos_embed": normal(1, tokens, dim)}
    for i in range(depth):
        attn = {"qkv": {"kernel": normal(dim, 3, h, hd),
                        "bias": np.zeros((3, h, hd), np.float32)},
                "proj": {"kernel": normal(h, hd, dim),
                         "bias": np.zeros(dim, np.float32)}}
        if mhla:
            attn["latent_proj"] = dense(hd, hd)
        tree[f"blocks_{i}"] = {"attn": attn, "norm1": norm(), "norm2": norm(),
                               "mlp": {"fc1": dense(dim, mlp),
                                       "fc2": dense(mlp, dim)}}
    tree["norm"] = norm()
    tree["head"] = dense(dim, 10)
    return tree


def _without_latent(tree: dict) -> dict:
    """The dense ViT's tree from an MHLA tree: the same stem, blocks and
    head without the latent projections (the arrays are shared)."""
    out = dict(tree)
    for key, blk in tree.items():
        if key.startswith("blocks_"):
            attn = {k: v for k, v in blk["attn"].items() if k != "latent_proj"}
            out[key] = {**blk, "attn": attn}
    return out


class _H14:
    """One of the ViT-H/14 paths: label, model class and flag, its window
    (None: dense), the op whose kernels it runs (the default path's band
    and flash op, or an opt-in op with the environment that switches it
    on), the ops that must launch nothing on it, and its resolution. The
    head-count paths (phase_headdims) give another width, head count and
    patch."""

    def __init__(self, label, w, op=None, env=None, idle=(), img=H14_IMG,
                 depth=H14_DEPTH, dim=H14_DIM, heads=H14_HEADS,
                 patch=H14_PATCH, prefix="h14"):
        self.label, self.w, self.img, self.depth = label, w, img, depth
        self.dim, self.heads, self.patch = dim, heads, patch
        self.prefix = prefix  # of its phases' labels
        self.mhla = w is not None
        self.cls = VisionTransformerMHLA if self.mhla else VisionTransformer
        self.flag = "vit_mhla" if self.mhla else "vit"
        self.op = op or (band if self.mhla else flash)
        self.env, self.idle = env or {}, idle
        self.path = (TILE if self.op is tile else MHLA if self.mhla
                     else DENSE)
        self.to_sd = (flax_vit_mhla_to_state_dict if self.mhla
                      else flax_vit_to_state_dict)
        # The kind its training forward counts under (K6 counts both).
        self.train_kind = "fwd" if self.op is tile else "fwd_train"
        self.s = (img // patch) ** 2 + 1

    def build(self, depth, device, **kw):
        if self.mhla:
            kw["window_size"] = self.w
        return self.cls(img_size=self.img, patch_size=self.patch,
                        num_classes=10, embed_dim=self.dim, depth=depth,
                        num_heads=self.heads, device=device, **kw)

    def tree(self, depth: int, seed: int) -> dict:
        """The path's seeded Flax-layout tree (_h14_flax_tree)."""
        tree = _h14_flax_tree(True, depth, seed, self.img, self.dim,
                              self.heads, self.patch)
        return tree if self.mhla else _without_latent(tree)

    def check_idle(self, phase: str) -> None:
        busy = {op.__name__: _counts(op) for op in self.idle}
        if any(any(c.values()) for c in busy.values()):
            raise AssertionError(f"{phase}: ops that {self.label} must not "
                                 f"run were launched: {busy}")

    def flags(self):
        return ["--embed_dim", str(self.dim), "--depth", str(self.depth),
                "--num_heads", str(self.heads),
                *(("--window_size", str(self.w)) if self.mhla
                              else ())]


H14_PATHS = (_H14("MHLA-H/14 W=7", 7, depth=H14_DEFAULT_DEPTH),
             _H14(f"MHLA-H/14 W={H14_WIDE_W}", H14_WIDE_W,
                  depth=H14_DEFAULT_DEPTH),
             _H14("dense ViT-H/14", None, depth=H14_DEFAULT_DEPTH))
# The opt-in paths: dense ViT-H/14 at 224^2 (S = 257, d = 80) through K3/K4
# with FAVIT_FUSED_MHA=1 (the flash kernels launch nothing), and MHLA-H/14
# at 518^2 through the tile band (K6/K7; K1/K2 launch nothing) at the
# model's window, at JAX's roll-band limit, where the halo is 64, and at
# W = 257 (JAX's halo of 128, the wgmma kernels). They run cut to the
# default paths' 8 blocks, to hold the smoke's time, and the last to 4: the
# exact edge rows in plain PyTorch (ops/window.py) keep f32
# [B, h, 2 hw, W, d] slabs of K and V a block for the backward, 2.7 GB each
# at W = 257, batch 8.
H14_STREAM_W = 257
H14_STREAM_DEPTH = 4
H14_OPTIN_PATHS = (
    _H14("dense ViT-H/14 fused", None, fused, {"FAVIT_FUSED_MHA": "1"},
         (flash, band), H14_FUSED_IMG, depth=H14_DEFAULT_DEPTH),
    _H14("MHLA-H/14 W=7 tile band", 7, tile, TILE_ENV, (band,),
         depth=H14_DEFAULT_DEPTH),
    _H14(f"MHLA-H/14 W={H14_WIDE_W} tile band", H14_WIDE_W, tile, TILE_ENV,
         (band,), depth=H14_DEFAULT_DEPTH),
    _H14(f"MHLA-H/14 W={H14_STREAM_W} tile band", H14_STREAM_W, tile,
         TILE_ENV, (band,), depth=H14_STREAM_DEPTH),
)


def _counts(op) -> dict:
    return _op_counts()[op.__name__.rsplit(".", 1)[1]]


def phase_h14_parity(p: _H14, tree: dict) -> None:
    """The model cut to 2 blocks at full width, 2 images at the path's
    resolution: f32 on the card against the CPU (the model phase's rule: logits within 1e-3,
    probabilities within 1e-4) and bf16 autocast on the card against the
    f32 CPU (the serve phase's 1e-2 on probabilities); 2 launches a pass."""
    phase = f"{p.prefix}-model"
    sd = p.to_sd(tree)
    cpu_model = p.build(2, "cpu").eval()
    cpu_model.load_state_dict(sd)
    gpu_model = p.build(2, "cuda").eval()
    gpu_model.load_state_dict(sd)
    u8 = _images(np.random.default_rng(19), 2)
    with torch.inference_mode(), _environ(p.env):
        x = prepare_eval_batch(torch.from_numpy(u8), p.img)
        ref = cpu_model(x)
        _reset_ops()
        got = gpu_model(x.to("cuda")).cpu()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got_bf16 = gpu_model(x.to("cuda")).float().cpu()
        torch.cuda.synchronize()
    launches = _counts(p.op)
    p.check_idle(phase)
    ref_p = torch.softmax(ref, -1)
    dl = float((got - ref).abs().max())
    dp = float((torch.softmax(got, -1) - ref_p).abs().max())
    dp16 = float((torch.softmax(got_bf16, -1) - ref_p).abs().max())
    log(phase, f"{p.label} cut to 2 blocks, batch 2 at {p.img}^2 (S="
               f"{p.s}), card vs CPU: f32 max |d logits| {dl:.3g} (tol "
               f"1e-3), max |d probs| {dp:.3g} (tol 1e-4); bf16 autocast max "
               f"|d probs| {dp16:.3g} (tol 1e-2); launches {launches}")
    if not (dl <= 1e-3 and dp <= 1e-4 and dp16 <= 1e-2):
        raise AssertionError(f"{phase}: {p.label} on the card disagrees "
                             f"with the CPU")
    if launches["fwd"] != 2 * 2:
        raise AssertionError(f"{phase}: expected 4 eval launches, got "
                             f"{launches}")


def phase_h14_serve(p: _H14, weights: str) -> dict:
    """``serve.setup`` with ViT-H/14's flags at the path's resolution, bf16,
    batch 8: concurrent requests through ``BatchingServer`` and one ``POST
    /predict`` through ``HTTPFrontend``; the op's eval kernel launched once
    a block a forward pass; a full batch's latency. Returns the launches."""
    phase = f"{p.prefix}-serve"
    rng = np.random.default_rng(20)
    t0 = time.perf_counter()
    args, predictor = serve.setup([
        "--model", p.flag, "--patch_size", str(p.patch), "--img_size",
        str(p.img), "--compute_dtype", "bfloat16", "--batch_size",
        str(H14_BATCH), "--weights", weights, *p.flags()])
    log(phase, f"{p.label}: set-up (weights, model, warm-up batch) "
               f"{time.perf_counter() - t0:.1f} s")
    forwards = [0]
    hook = predictor.model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    _reset_ops()
    reqs = [_images(rng, n) for n in H14_SIZES]
    with serve.BatchingServer(predictor, max_delay_ms=args.max_delay_ms,
                              workers=args.workers) as srv, \
            serve.HTTPFrontend(srv, host="127.0.0.1", port=0) as fe:
        with ThreadPoolExecutor(max_workers=3) as pool:
            outs = list(pool.map(
                lambda r: srv.submit(r).result(timeout=300), reqs))
        for req, out in zip(reqs, outs):
            _check_probs(out, len(req))
        http_req = _images(rng, 4)
        _check_probs(_post(f"http://{fe.host}:{fe.port}", http_req), 4)
    full = _images(rng, H14_BATCH)
    lat = []
    for _ in range(7):
        t0 = time.perf_counter()
        predictor.predict_proba(full)
        lat.append(time.perf_counter() - t0)
    hook.remove()
    launches = _counts(p.op)
    p.check_idle(phase)
    log(phase, f"{p.label}: requests of {list(H14_SIZES)} images and one "
               f"POST /predict of 4: shapes, finite, rows sum to 1; forward "
               f"passes {forwards[0]}, launches {launches}; a batch of "
               f"{H14_BATCH}: median latency "
               f"{statistics.median(lat[2:]) * 1e3:.2f} ms (host clock, 5 "
               f"runs after 2, uint8 in to probs out)")
    if forwards[0] == 0 or launches["fwd"] != p.depth * forwards[0]:
        raise AssertionError(f"{phase}: {p.label} launches {launches} != "
                             f"{p.depth} x {forwards[0]} forward passes")
    del predictor
    torch.cuda.empty_cache()
    return launches


# AdamW's first steps move every weight by about the learning rate; at
# 1e-4 a 32-block model from a random start overshoots by the third step
# (losses 2.80, 1.96, 6.14 at 1e-4 on an H100), so the steps take 1e-5.
H14_LR = 1e-5


def phase_h14_train(p: _H14, sd: dict) -> dict:
    """H14_STEPS train steps of the model at batch 8, bf16 autocast over f32
    parameters, AdamW at H14_LR, dropout 0.1 (and attention dropout 0.1
    where the op's kernels draw it: K1, K3) on one batch: losses finite and
    falling; the training forward and the backward launched once a block a
    step. Returns the launches."""
    phase = f"{p.prefix}-train"
    kw = dict(dropout=TRAIN_DROPOUT)
    # Attention dropout where the op draws it in its kernels (the band's
    # K1, the fused K3): the tile band trains without it, as in JAX, where
    # attention dropout on a long row takes the plain shift band.
    if p.op in (band, fused):
        kw["attn_dropout"] = TRAIN_DROPOUT
    model = p.build(p.depth, "cuda", **kw)
    model.load_state_dict(sd)
    state = train.create_train_state(model, train.make_adamw(H14_LR))
    step = train.make_train_step(p.img, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(21)
    u8 = _images(rng, H14_BATCH)
    y = rng.integers(0, 10, size=H14_BATCH)
    _reset_ops()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(H14_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, u8, y, i)
        losses.append(float(m["loss_sum"]) / H14_BATCH)
        times.append(time.perf_counter() - t0)
    launches = _counts(p.op)
    p.check_idle(phase)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(phase, f"{p.label}: {H14_STEPS} steps at batch {H14_BATCH}, bf16 "
               f"autocast, dropout {kw}: losses "
               f"{[round(x, 5) for x in losses]}"
               f"; ms a step {[round(t * 1e3, 1) for t in times]} (host "
               f"clock, the first with the kernels' first calls), peak "
               f"{peak:.2f} GiB; launches {launches}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: {p.label} losses {losses} are not "
                             f"finite and falling")
    want = p.depth * H14_STEPS
    if launches[p.train_kind] != want or launches["bwd"] != want:
        raise AssertionError(f"{phase}: {p.label} launches {launches}, "
                             f"expected {want} training forwards and "
                             f"backwards")
    del state, model, step
    torch.cuda.empty_cache()
    return launches


def phase_h14() -> dict:
    """The three ViT-H/14 paths end to end, weights carried from seeded
    Flax-layout trees through ``convert/from_jax.py``: each cut to 2 blocks
    against the CPU, then served, trained 3 steps, and MHLA-H/14 at W=7
    exported and served from its artifact. Returns the launches by op."""
    total = {"band": dict.fromkeys(band.LAUNCH_KINDS, 0),
             "flash": dict.fromkeys(flash.LAUNCH_KINDS, 0)}

    def add(op, counts):
        for k, n in counts.items():
            total["band" if op is band else "flash"][k] += n

    t0 = time.perf_counter()
    trees = {True: _h14_flax_tree(True, H14_DEFAULT_DEPTH, 19)}
    trees[False] = _without_latent(trees[True])
    small = {True: _h14_flax_tree(True, 2, 21)}
    small[False] = _without_latent(small[True])
    sds = {m: flax_vit_mhla_to_state_dict(t) if m else
           flax_vit_to_state_dict(t) for m, t in trees.items()}
    del trees
    n_params = sum(x.numel() for x in sds[True].values())
    log("h14", f"seeded Flax-layout trees of MHLA-H/14 and ViT-H/14 through "
               f"convert/from_jax.py in {time.perf_counter() - t0:.1f} s: "
               f"MHLA-H/14 {n_params / 1e6:.1f}M parameters")
    with tempfile.TemporaryDirectory() as tmp:
        for p in H14_PATHS:
            phase_h14_parity(p, small[p.mhla])
            weights = os.path.join(tmp, f"{p.flag}_h14.pt")
            if not os.path.exists(weights):
                torch.save(sds[p.mhla], weights)
            add(p.op, phase_h14_serve(p, weights))
            if p.w == 7:
                exported = phase_export(
                    p.path, None, state_dict=sds[True],
                    geom_flags=p.flags(), img=H14_IMG, batch=H14_BATCH,
                    sizes=H14_SIZES, depth=p.depth, patch=H14_PATCH,
                    name=p.label)
                add(band, {"fwd": exported["launches"]})
                log("h14-export", f"{p.label}: artifact {exported}")
            torch.cuda.empty_cache()
            add(p.op, phase_h14_train(p, sds[p.mhla]))
    return total


def phase_h14_optin() -> dict:
    """The opt-in ViT-H/14 paths (H14_OPTIN_PATHS) end to end, each in its
    environment, weights carried from seeded Flax-layout trees through
    ``convert/from_jax.py``: cut to 2 blocks against the CPU, the model cut
    to H14_DEFAULT_DEPTH blocks (4 at W=257) served, 3 train steps (the
    kernels run at full width either way); MHLA-H/14 at W=129
    through the tile band also exported and served from its artifact,
    bit-equal to the live path. Returns the launches by op and path."""
    total = {}
    t0 = time.perf_counter()
    sds = {}
    for p in H14_OPTIN_PATHS:
        if (p.mhla, p.img, p.depth) not in sds:
            sds[(p.mhla, p.img, p.depth)] = p.to_sd(p.tree(p.depth, 19))
    small = {True: _h14_flax_tree(True, 2, 21)}
    small[False] = _without_latent(_h14_flax_tree(True, 2, 21,
                                                  H14_FUSED_IMG))
    log("h14-optin", f"seeded Flax-layout trees through convert/from_jax.py "
                     f"in {time.perf_counter() - t0:.1f} s: MHLA-H/14 at "
                     f"{H14_IMG}^2, dense ViT-H/14 at {H14_FUSED_IMG}^2")
    with tempfile.TemporaryDirectory() as tmp:
        for p in H14_OPTIN_PATHS:
            counts = total.setdefault(p.label, {})
            with _environ(p.env):
                phase_h14_parity(p, small[p.mhla])
                sd = sds[(p.mhla, p.img, p.depth)]
                weights = os.path.join(tmp, f"{p.flag}_{p.img}_{p.depth}"
                                            f"_h14.pt")
                if not os.path.exists(weights):
                    torch.save(sd, weights)
                counts["serve"] = phase_h14_serve(p, weights)
                if p.op is tile and p.w == H14_WIDE_W:
                    exported = phase_export(
                        p.path, None, state_dict=sd,
                        geom_flags=p.flags(), img=H14_IMG, batch=H14_BATCH,
                        sizes=H14_SIZES, depth=p.depth, patch=H14_PATCH,
                        name=p.label, bit_equal=True)
                    counts["export"] = exported["launches"]
                    log("h14-export", f"{p.label}: artifact {exported}")
                torch.cuda.empty_cache()
                counts["train"] = phase_h14_train(p, sd)
                del sd
    return total


# --- every head count the CLI takes: head dims off the grid of 8, past 256 --

# At ViT-B's width (D = 768) --num_heads h gives the head dim 768 / h: 1, 2
# and 64 heads are d = 768, 384 and 12 (the paper's E7 and E8 compare one
# head with several). The kernels take a head dim off the grid of 8 padded
# with zero columns (12 -> 16; ops/flash_attention.pad_head_dim) and one
# past 256 through the wide blocks of csrc/flash_wide.cuh (K5, K3/K4) or
# more channel chunks (K1/K2). kernel-headdims holds each at the main
# paths' shapes (batch 8; f32 at batch 1): K5 at d = 768 and 12 (dense
# ViT-B/4, S = 3137), K1/K2 at d = 384 and 12 (MHLA-B/4, W = 7), K3/K4 at
# d = 384 (ViT-B/16, S = 197); each also at ViT-H's D = 1280 in one head (K5
# and K1/K2 at S = 1370, K3/K4 at S = 197; K5 and K3/K4 timed there too);
# and K6/K7/K8 at d = 4, 12, 36 (S = 3137, W = 7 and 129).
HD_DIM, HD_IMG, HD_BATCH = 768, 224, 8
HD_S = (HD_IMG // 4) ** 2 + 1
HD_FUSED_S = (HD_IMG // 16) ** 2 + 1
HD_H = H14_DIM  # ViT-H's width, one head
# K5 at d = 256 and 192 (3 and 4 heads: csrc/flash_block256.cuh's blocks)
# and at 136 (4 heads of a width of 544: the tile width 192 with 56 zero
# columns), and K3/K4 at 256 and 192 at S = 197 (past the whole-row
# kernel's 64 keys).
HD_FLASH = ((768, 1, HD_S), (12, 64, HD_S), (HD_H, 1, H14_S),
            (256, 3, HD_S), (192, 4, HD_S), (136, 4, HD_S))  # d, h, S
HD_BAND = ((384, 2, HD_S), (12, 64, HD_S), (HD_H, 1, H14_S))
HD_FUSED = ((384, 2), (HD_H, 1), (256, 3), (192, 4))  # d, h at S = 197
HD_TILE_DIMS = (4, 12, 36)
HD_TILE_WINDOWS = (7, 129)
HD_TILE_ROWS = 16
HD_W = 7
HD_REPS = 10  # CUDA-event medians of the kernels; the plain versions of 3
# K3/K4 and their library calls at S = 197 in batches of calls, as
# kernel-fused times them: a call takes about as long on the host as on
# the card.
HD_FUSED_BATCH = 10
# The paths run cut to 4 of their 12 blocks, to hold the smoke's time; the
# kernels run at full width either way.
HD_DEPTH = 4


def _sdpa_backend(q, k, v, mask=None) -> str:
    """The backend PyTorch's fused attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, attn_mask=mask)).name


def _tile_width(d: int) -> int:
    """The tile width the bf16 kernels run head dim d (up to 256) at: the
    narrowest of TILE_WIDTHS that holds d padded to the grid of 8."""
    padded = -(-d // flash.HEAD_DIM_STEP) * flash.HEAD_DIM_STEP
    return next(w for w in TILE_WIDTHS if padded <= w)


def _block256_factor(source: str, backward) -> float:
    """Run ``backward`` once at a tile width of BLOCK256_WIDTHS and return
    its matrix products over the function's 10 S^2 d, from the dkv and dq
    launches the library ``source`` counted on csrc/flash_block256.cuh's
    blocks (ops/flash_attention.block256_launches). Each dkv launch forms
    S^T and dP^T, each dq launch S, dP and dq, and dk and dv are formed once
    in all: 2 S^2 d (2 n_dkv + 2 + 3 n_dq), 1.4x with one dkv launch (1.8x
    with a dk-then-dv pair). Raises unless the call made one of each."""
    flash.block256_launches(source)  # zeroes the counts
    backward()
    torch.cuda.synchronize()
    n = flash.block256_launches(source)
    if n != {"dkv": 1, "dq": 1}:
        raise AssertionError(f"{source} launched {n} on the blocks of the "
                             f"tile widths 192 and 256, not one dkv and one "
                             f"dq")
    return 2 * (2 * n["dkv"] + 2 + 3 * n["dq"]) / 10


def _recompute(rows: int, s: int, d: int, factor: float | None = None) -> str:
    """The wide blocks' slice plan and recomputation at this shape
    (ops/flash_attention.wide_plan, csrc/flash_wide.cuh): each slice forms
    the logits (and dP) over all of d once; up to 256 the blocks hold whole
    rows, and ``factor`` (_block256_factor) is the backward's products over
    its 10 S^2 d where it was counted."""
    if d <= 256:
        return (f"none (whole rows at tile width {_tile_width(d)})"
                + ("" if factor is None else
                   f"; backward {factor:.2f}x its 10 S^2 d (this run's dkv "
                   f"and dq launches)"))
    plan = {k: flash.wide_plan(rows, s, d, k) for k in ("fwd", "dkv", "dq")}
    return ("plan " + ", ".join(
        f"{k} {p.slices} slices of {1 if k == 'dkv' else 2} x {p.cols} "
        f"columns" for k, p in plan.items())
        + f"; forward {flash.wide_factor(rows, s, d, 'fwd'):.2f}x its "
          f"4 S^2 d operations, backward "
          f"{flash.wide_factor(rows, s, d, 'bwd'):.2f}x its 10 S^2 d")


def _pad_ms(x, d: int, dim: int) -> float:
    """The pad's extra copies in one eval call: q, k and v padded to the
    grid of 8 along ``dim``, the output sliced back (CUDA-event median)."""
    def run():
        qp, kp, vp = (flash.pad_head_dim(t, dim) for t in x[:3])
        return flash.unpad_head_dim(qp, d, dim)
    return cuda_median_ms(run, HD_REPS)


def _sliced_library_ms(library, tensors, form: str, rate: float):
    """The library call's ``form`` (band_library_call's eval, dropout or
    backward) over the batch cut into the fewest equal slices that fit the
    card (halving from 2), each slice timed (CUDA-event medians) and the
    times summed. Returns (ms, slices)."""
    q, k, v, g = tensors
    b = q.shape[0]
    parts = 2
    while True:
        rows = -(-b // parts)
        total = 0.0
        try:
            for i in range(0, b, rows):
                sl = [x[i:i + rows] for x in (q, k, v, g)]
                if form == "bwd_library":
                    total += backward_ms(
                        lambda *a: library(*a, rate), sl[:3],
                        sl[3].transpose(-1, -2).contiguous(), HD_REPS)
                else:
                    drop = rate if form == "fwd_train_library" else 0.0
                    with torch.no_grad():
                        total += cuda_median_ms(
                            lambda: library(*sl[:3], drop), HD_REPS)
            return total, parts
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if rows == 1:
                raise
            parts *= 2


def phase_kernel_headdims() -> dict:
    """K5 (eval, training forward, backward) at HD_FLASH, K1 (eval, training
    at dropout 0 and 0.1) and K2 at HD_BAND, K3 (eval, training at dropout 0
    and 0.1) and K4 at HD_FUSED, K6/K7/K8 at HD_TILE_DIMS: in f32 (batch 1)
    and bf16 (batch 8) against their plain versions by the rules of
    kernel-flash, kernel-train, kernel-fused's loose cases and
    kernel-tileband; each bf16 form at the main paths' d timed beside its
    plain version, its bound and PyTorch's fused attention (the backend it
    picks named), with the pad's copies timed at d = 12. Returns {"flash":
    {d: forms}, "band": {d: forms}, "fused": {d: forms}}."""
    import torch.nn.functional as F  # the library call, timed as a yardstick

    phase = "kernel-headdims"
    gen = torch.Generator(device="cuda").manual_seed(21)
    failures = []
    seed = 2**41 + 21
    rate = TRAIN_DROPOUT

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(4)]

    def times_of(fns, batch=1):
        return {n: cuda_median_ms(fn, 3, 1) if n.endswith("plain")
                else cuda_median_ms(fn, HD_REPS, batch=batch)
                for n, fn in fns.items()}

    def show(kind, d, r, rows=0, s=0, factor=None):
        log(phase, f"{kind} d={d} bf16, kernel / plain / PyTorch's fused "
                   f"attention ({r.pop('backend')}), ms (CUDA-event "
                   f"medians of {HD_REPS}"
                   + (f" of batches of {HD_FUSED_BATCH} calls"
                      if kind.startswith("fused") else "")
                   + ", plain of 3): " + "; ".join(
                       f"{n} {x['ms']:.4f} / {x['plain_ms']:.4f} / "
                       f"{x['library_ms'] if x['library_ms'] is None else round(x['library_ms'], 4)}"
                       f", bound {x['bound_ms']:.4f} ({x['bound_by']}), "
                       f"{x['bound_ms'] / x['ms']:.3f} of it"
                       for n, x in r.items())
            + ("" if kind == "band" else
               f"; recomputation {_recompute(rows, s, d, factor)}"))

    result = {"flash": {}, "band": {}, "fused": {}}
    for d, h, s in HD_FLASH:
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            shape = (1 if dtype == torch.float32 else HD_BATCH, h, s, d)
            q, k, v, g = inputs(shape, dtype)
            res = _compare_flash(q, k, v, g)
            _optin_check(failures, f"flash {shape} {dt}", res)
            log(phase, f"flash B,h,S,d={shape} {dt}: max abs err " + ", ".join(
                f"{n} {t}" for n, (_, _, t) in res.items()))
            if dtype == torch.float32:
                continue
            out, lse = flash.flash_forward_train(q, k, v)
            again = [flash.flash_backward(q, k, v, out, lse, g)
                     for _ in range(2)]
            if not all(torch.equal(a, b_) for a, b_ in zip(*again)):
                raise AssertionError(f"{phase}: two flash backward runs "
                                     f"differ at d={d}")
            del again
            factor = (_block256_factor(
                "flash_attention_bwd",
                lambda: flash.flash_backward(q, k, v, out, lse, g))
                if d <= 256 and _tile_width(d) in BLOCK256_WIDTHS else None)
            t = times_of({
                "fwd": lambda: flash.flash_attention(q, k, v),
                "fwd_train": lambda: flash.flash_forward_train(q, k, v),
                "bwd": lambda: flash.flash_backward(q, k, v, out, lse, g),
                "fwd_plain": lambda: flash.plain_flash_forward(q, k, v),
                "bwd_plain": lambda: flash.plain_flash_backward(
                    q, k, v, out, lse, g),
            })
            with torch.no_grad():
                t["fwd_library"] = cuda_median_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v), HD_REPS)
            lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
            t["fwd_train_library"] = cuda_median_ms(
                lambda: F.scaled_dot_product_attention(lq, lk, lv), HD_REPS)
            del lq, lk, lv
            t["bwd_library"] = backward_ms(F.scaled_dot_product_attention,
                                           (q, k, v), g)
            errs = {n: e for n, (e, _, _) in res.items()}
            one = q.numel() * q.element_size()
            pairs = HD_BATCH * h * s * s * d
            r = result["flash"][d] = dict(
                fwd=dict(max_abs_err=errs["out_eval"], ms=t["fwd"],
                         plain_ms=t["fwd_plain"],
                         library_ms=t["fwd_library"],
                         **least_time(4 * one, 4 * pairs)),
                fwd_train=dict(max_abs_err=max(errs["out"], errs["lse"]),
                               ms=t["fwd_train"], plain_ms=t["fwd_plain"],
                               library_ms=t["fwd_train_library"],
                               **least_time(4 * one + lse.numel() * 4,
                                            4 * pairs)),
                bwd=dict(max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
                         ms=t["bwd"], plain_ms=t["bwd_plain"],
                         library_ms=t["bwd_library"],
                         **least_time(8 * one + lse.numel() * 4,
                                      10 * pairs)))
            show("flash", d, dict(r, backend=_sdpa_backend(q, k, v)),
                 HD_BATCH * h, s, factor)
            if d % 8:
                log(phase, f"flash d={d}: the pad's copies (q, k, v to "
                           f"{-(-d // 8) * 8} columns, out back) "
                           f"{_pad_ms((q, k, v), d, 3):.4f} ms of the eval "
                           f"call's {t['fwd']:.4f}")
            del q, k, v, g, out, lse
            torch.cuda.empty_cache()

    for d, h, s in HD_BAND:
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            shape = (1 if dtype == torch.float32 else HD_BATCH, h, d, s)
            q, k, v, g = inputs(shape, dtype)
            res = {"eval": _worst(band.roll_banded_attention(q, k, v, HD_W),
                                  band.plain_banded_attention(q, k, v, HD_W),
                                  dtype, F32_TOL)}
            for r_, sd in ((0.0, None), (rate, seed)):
                for n, x in _compare_train(q, k, v, g, HD_W, r_, sd).items():
                    res[f"{n}@{r_}"] = x
            _optin_check(failures, f"band {shape} {dt}", res)
            log(phase, f"band B,h,d,S={shape} W={HD_W} {dt}, dropout 0 and "
                       f"{rate}: max abs err " + ", ".join(
                           f"{n} {t}" for n, (_, _, t) in res.items()))
            if dtype == torch.float32 or d == HD_H:
                continue
            out, wts = band.band_forward_train(q, k, v, HD_W, rate, seed)
            t = times_of({
                "fwd": lambda: band.roll_banded_attention(q, k, v, HD_W),
                "fwd_plain": lambda: band.plain_banded_attention(q, k, v,
                                                                 HD_W),
                "fwd_train": lambda: band.band_forward_train(
                    q, k, v, HD_W, rate, seed),
                "fwd_train_plain": lambda: band.plain_band_forward_train(
                    q, k, v, HD_W, rate, seed),
                "bwd": lambda: band.band_backward(q, k, v, g, wts, HD_W, rate,
                                                  seed),
                "bwd_plain": lambda: band.plain_band_backward(
                    q, k, v, g, wts, HD_W, rate, seed),
            })
            # PyTorch's memory-efficient backend, which the band's mask
            # needs, takes head dims that are multiples of 8 only; off that
            # grid the call takes the backend PyTorch picks (the math one,
            # which forms the [B*h, S, S] weights), named in the row.
            # That backend may not fit the card: a form that runs out of
            # memory there is timed over slices of the batch that fit,
            # halved until one does, the slices' times summed, and the
            # allocation that failed is logged.
            library = band_library_call(s, HD_W, dtype, forced=d % 8 == 0)
            backend = library.backend(q, k, v)
            free0 = torch.cuda.mem_get_info()[0]
            torch.cuda.reset_peak_memory_stats()
            forms = {
                "fwd_library": lambda: library(q, k, v),
                "fwd_train_library": lambda: library(q, k, v, rate),
                "bwd_library": lambda: backward_ms(
                    lambda *a: library(*a, rate), (q, k, v),
                    g.transpose(-1, -2).contiguous())}
            for n, fn in forms.items():
                timed = (fn if n == "bwd_library"
                         else lambda fn=fn: cuda_median_ms(fn, HD_REPS))
                try:
                    with torch.set_grad_enabled(n == "bwd_library"):
                        t[n] = timed()
                except torch.cuda.OutOfMemoryError as e:
                    if d % 8 == 0:
                        raise
                    torch.cuda.empty_cache()
                    log(phase, f"band d={d} library {n}: out of memory on "
                               f"the card at batch {q.shape[0]}: "
                               f"{str(e).splitlines()[0]}")
                    t[n], parts = _sliced_library_ms(
                        library, (q, k, v, g), n, rate)
                    backend += f", {n} over {parts} slices of the batch"
                    log(phase, f"band d={d} library {n}: {t[n]:.4f} ms, the "
                               f"sum over {parts} slices of the batch")
            backend += (f", peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
                        f" GiB of {free0 / 2**30:.1f} free")
            del library
            one = q.numel() * q.element_size()
            pairs = HD_BATCH * h * s * HD_W * d
            errs = {n: e for n, (e, _, _) in res.items()}
            r = result["band"][d] = dict(
                fwd=dict(max_abs_err=errs["eval"], ms=t["fwd"],
                         plain_ms=t["fwd_plain"],
                         library_ms=t["fwd_library"],
                         **least_time(4 * one, 4 * pairs)),
                fwd_train=dict(
                    max_abs_err=max(errs[f"{n}@{r_}"] for n in ("out", "wts")
                                    for r_ in (0.0, rate)),
                    ms=t["fwd_train"], plain_ms=t["fwd_train_plain"],
                    library_ms=t["fwd_train_library"],
                    **least_time(4 * one + wts.numel() * 4, 4 * pairs)),
                bwd=dict(
                    max_abs_err=max(errs[f"{n}@{r_}"]
                                    for n in ("dq", "dk", "dv")
                                    for r_ in (0.0, rate)),
                    ms=t["bwd"], plain_ms=t["bwd_plain"],
                    library_ms=t["bwd_library"],
                    **least_time(7 * one + wts.numel() * 4, 10 * pairs)))
            show("band", d, dict(r, backend=backend))
            if d % 8:
                log(phase, f"band d={d}: the pad's copies (q, k, v to "
                           f"{-(-d // 8) * 8} channels, out back) "
                           f"{_pad_ms((q, k, v), d, 2):.4f} ms of the eval "
                           f"call's {t['fwd']:.4f}")
            del q, k, v, g, out, wts
            torch.cuda.empty_cache()

    for d, h in HD_FUSED:
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            shape = (1 if dtype == torch.float32 else HD_BATCH, h,
                     HD_FUSED_S, d)
            q, k, v, g = inputs(shape, dtype)
            # kernel-fused's rule for its loose cases (FUSED_LOOSE_ULPS entry
            # by entry and the rms bound), as kernel-h14-optin holds them;
            # the bf16 gradients by the rule at HEADDIM_OWN_MARGIN.
            res = {}
            for r_, sd in ((0.0, None), (rate, seed)):
                for n, x in _compare_fused(q, k, v, g, r_, sd,
                                           FUSED_LOOSE_ULPS,
                                           rounded=True).items():
                    res[f"{n}@{r_}"] = x
            _optin_check(failures, f"fused {shape} {dt}", res)
            log(phase, f"fused B,h,S,d={shape} {dt}, dropout 0 and {rate}: "
                       f"max abs err " + ", ".join(
                           f"{n} {t}" for n, (_, _, t) in res.items()))
            if dtype == torch.float32:
                continue
            out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
            again = [fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
                     for _ in range(2)]
            if not all(torch.equal(a, b_) for a, b_ in zip(*again)):
                raise AssertionError(f"{phase}: two fused backward runs "
                                     f"differ at d={d}")
            del again
            factor = (_block256_factor(
                "fused_mha_bwd", lambda: fused.fused_mha_backward(
                    q, k, v, out, lse, g, rate, seed))
                if d <= 256 and _tile_width(d) in BLOCK256_WIDTHS else None)
            with torch.no_grad():
                t = times_of({
                    "fwd": lambda: fused.fused_multi_head_attention(q, k, v),
                    "fwd_train": lambda: fused.fused_mha_forward_train(
                        q, k, v, rate, seed),
                    "bwd": lambda: fused.fused_mha_backward(
                        q, k, v, out, lse, g, rate, seed),
                    "fwd_plain": lambda: fused.plain_fused_mha_forward(
                        q, k, v),
                    "fwd_train_plain": lambda: fused.plain_fused_mha_forward(
                        q, k, v, rate, seed),
                    "bwd_plain": lambda: fused.plain_fused_mha_backward(
                        q, k, v, g, rate, seed, out=out),
                }, HD_FUSED_BATCH)
                t["fwd_library"] = cuda_median_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v), HD_REPS,
                    batch=HD_FUSED_BATCH)
            t.update(_fused_library_times(q, k, v, g, rate, HD_REPS,
                                          HD_FUSED_BATCH))
            errs = {n: e for n, (e, _, _) in res.items()}
            one = q.numel() * q.element_size()
            pairs = HD_BATCH * h * HD_FUSED_S * HD_FUSED_S * d
            r = result["fused"][d] = dict(
                fwd=dict(max_abs_err=errs["out_eval@0.0"], ms=t["fwd"],
                         plain_ms=t["fwd_plain"],
                         library_ms=t["fwd_library"],
                         **least_time(4 * one, 4 * pairs)),
                fwd_train=dict(
                    max_abs_err=max(errs[f"{n}@{r_}"] for n in ("out", "lse")
                                    for r_ in (0.0, rate)),
                    ms=t["fwd_train"], plain_ms=t["fwd_train_plain"],
                    library_ms=t["fwd_train_library"],
                    **least_time(4 * one, 4 * pairs)),
                bwd=dict(
                    max_abs_err=max(errs[f"{n}@{r_}"]
                                    for n in ("dq", "dk", "dv")
                                    for r_ in (0.0, rate)),
                    ms=t["bwd"], plain_ms=t["bwd_plain"],
                    library_ms=t["bwd_library"],
                    **least_time(7 * one, 10 * pairs)))
            show(f"fused S={HD_FUSED_S}", d,
                 dict(r, backend=_sdpa_backend(q, k, v)), HD_BATCH * h,
                 HD_FUSED_S, factor)
            del q, k, v, g, out, lse
            torch.cuda.empty_cache()

    tile.reset_launch_count()
    for d in HD_TILE_DIMS:
        for w in HD_TILE_WINDOWS:
            for dtype in (torch.float32, torch.bfloat16):
                dt = "f32" if dtype == torch.float32 else "bf16"
                q, k, v, g = inputs((HD_TILE_ROWS, HD_S, d), dtype)
                res = _tile_compare(q, k, v, g, w)
                _optin_check(failures, f"tile ({HD_TILE_ROWS}, {HD_S}, {d}) "
                                       f"W={w} {dt}", res)
                log(phase, f"tile band B*h,S,d=({HD_TILE_ROWS}, {HD_S}, {d}) "
                           f"W={w} {dt}: max abs err " + ", ".join(
                               f"{n} {t}" for n, (_, _, t) in res.items()))
                del q, k, v, g
    if failures:
        raise AssertionError(f"{phase}: kernels disagree with the plain "
                             f"versions at " + "; ".join(failures))
    return result


# --- the tile band past the staged kernels' range: the wgmma kernels --------

# K6, K7 and K8 past W = 129 or d = 256 run the wgmma kernels of
# csrc/mhla_tile_band_{fwd,bwd}.cu on csrc/tile_band_sm90.cuh (Q kept, K and
# V tiles by TMA through a deep ring, wgmma; K7 through its p/ds scratch).
# The grid (W, d, B*h, S), f32 and
# bf16 against the plain versions: JAX's halo 80, 128 and 352 (W = 131, 257,
# 683) at MHLA-H/14's d = 80 and at d = 16; the head dims 264, 384 and 768
# at the model's W = 7 and at wide windows; S = W + 1 and just past 2W
# among them.
TR_GRID = ((131, 80, 4, 300), (257, 80, 4, 600), (683, 80, 2, H14_S),
           (683, 16, 2, 684), (7, 264, 4, 197), (7, 384, 4, HD_S),
           (7, 768, 2, HD_S), (257, 384, 2, 520), (683, 768, 1, H14_S))
# The paths' shapes, timed in bf16 (d, W, B*h, S): MHLA-B/4 with 2 and 1
# heads (d = 384 and 768 at W = 7, batch 8), MHLA-H/14 at W = 257 (d = 80,
# B*h = 128) and at W = 683 (JAX's halo of 352, no path).
TR_TIMED = ((384, HD_W, 2 * HD_BATCH, HD_S), (768, HD_W, HD_BATCH, HD_S),
            (80, 257, H14_BATCH * H14_HEADS, H14_S),
            (80, 683, H14_BATCH * H14_HEADS, H14_S))
TR_REPS = 10  # CUDA-event medians of the kernels; the plain versions of 3
# One head of d = 1024, 1280 (ViT-H's width) and 2048 at W = 7, B*h = 8,
# S = 1370 (utils/band_ab.py --tile times K6, K7 and K8 there): the library
# call they are held against, timed alone, its backend named.
TR_LIBRARY = ((1024, 7, 8, H14_S), (1280, 7, 8, H14_S), (2048, 7, 8, H14_S))


def phase_kernel_tileband_range() -> dict:
    """K6, K7 (folded) and K8 on the wgmma kernels: TR_GRID in f32 and
    bf16 against the plain versions by kernel-tileband's rule; at TR_TIMED
    in bf16 against the plain versions, two K7 runs bit-identical, and each
    form timed beside its plain version, its bound (bytes at 3.35 TB/s or
    in-band operations at 989 TFLOP/s) and PyTorch's fused attention on K8's
    window tiles with the band as a boolean mask (its backward for K7).
    Returns {"tile": {(d, W): forms}, "fwd_b_launches": K8's launches}."""
    phase = "kernel-tileband-range"
    gen = torch.Generator(device="cuda").manual_seed(22)
    failures = []

    def inputs(shape, dtype):
        return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
                for _ in range(4)]

    tile.reset_launch_count()
    for w, d, bh, s in TR_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            dt = "f32" if dtype == torch.float32 else "bf16"
            q, k, v, g = inputs((bh, s, d), dtype)
            res = _tile_compare(q, k, v, g, w)
            _optin_check(failures, f"tile ({bh}, {s}, {d}) W={w} {dt}", res)
            log(phase, f"tile band B*h,S,d=({bh}, {s}, {d}) W={w} {dt}: max "
                       f"abs err " + ", ".join(
                           f"{n} {t}" for n, (_, _, t) in res.items()))
            del q, k, v, g
    result = {"tile": {}}
    for d, w, bh, s in TR_TIMED:
        torch.cuda.empty_cache()
        q, k, v, g = inputs((bh, s, d), torch.bfloat16)
        res = _tile_compare(q, k, v, g, w)
        _optin_check(failures, f"tile ({bh}, {s}, {d}) W={w} bf16", res)
        first = tile.tile_band_backward(q, k, v, g, w)
        second = tile.tile_band_backward(q, k, v, g, w)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(first, second)):
            raise AssertionError(f"{phase}: two K7 runs differ at d={d} "
                                 f"W={w}")
        del first, second
        times, tile_bytes, tile_pairs, t = _tile_times(q, k, v, g, w, gen,
                                                       TR_REPS)
        one = q.numel() * q.element_size()
        pairs = bh * s * (2 * (w // 2) + 1) * d
        errs = {n: e for n, (e, _, _) in res.items()}
        # kernel-tileband's bounds (kernel-h14-optin's at these shapes).
        result["tile"][(d, w)] = dict(
            fwd=dict(max_abs_err=errs["fwd"], ms=times["fwd"],
                     plain_ms=times["fwd_plain"], library_ms=times["library"],
                     **least_time(4 * one, 4 * pairs)),
            bwd=dict(max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
                     ms=times["bwd"], plain_ms=times["bwd_plain"],
                     library_ms=times["library_bwd"],
                     **least_time(7 * one, 10 * pairs)),
            fwd_b=dict(max_abs_err=errs["fwd_b"], ms=times["fwd_b"],
                       plain_ms=times["fwd_b_plain"],
                       library_ms=times["library"],
                       **least_time(tile_bytes, 4 * tile_pairs)),
        )
        log(phase, f"tile band B*h,S,d=({bh}, {s}, {d}) W={w} bf16: max abs "
                   f"err " + ", ".join(f"{n} {t_}" for n, (_, _, t_) in
                                       res.items()))
        log(phase, f"tile band d={d} W={w} bf16 (B*h={bh}, S={s}; K8 on "
                   f"window tiles of {t} + {2 * tile._halo(0, w // 2)} "
                   f"rows), kernel / plain / PyTorch's fused attention on "
                   f"the window tiles with the band as a mask, ms "
                   f"(CUDA-event medians of {TR_REPS}, plain of 3; two K7 "
                   f"runs bit-identical): " + "; ".join(
                       f"{kind} {r['ms']:.4f} / {r['plain_ms']:.4f} / "
                       f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
                       f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} "
                       f"of it" for kind, r in result["tile"][(d, w)].items()))
        del q, k, v, g
    import torch.nn.functional as F  # the library call, timed as a yardstick

    for d, w, bh, s in TR_LIBRARY:
        torch.cuda.empty_cache()
        q, k, v, g = inputs((bh, s, d), torch.bfloat16)
        qt, ke, ve, mask, _ = _window_inputs(q, k, v, w)
        with torch.no_grad():
            fwd = cuda_median_ms(lambda: F.scaled_dot_product_attention(
                qt, ke, ve, attn_mask=mask), TR_REPS)
        gt = torch.randn(qt.shape, device="cuda", generator=gen).to(q.dtype)
        bwd = backward_ms(
            lambda *a: F.scaled_dot_product_attention(*a, attn_mask=mask),
            (qt, ke, ve), gt)
        backend = _sdpa_backend(qt, ke, ve, mask)
        result["library"] = {**result.get("library", {}),
                             d: dict(fwd=fwd, bwd=bwd, backend=backend)}
        log(phase, f"tile band d={d} W={w} B*h={bh} S={s} bf16: PyTorch's "
                   f"fused attention on the window tiles with the band as a "
                   f"mask ({backend}), ms (CUDA-event medians of {TR_REPS}): "
                   f"forward {fwd:.4f} (K6's and K8's yardstick), backward "
                   f"{bwd:.4f} (K7's)")
        del q, k, v, g, qt, ke, ve, gt
    result["fwd_b_launches"] = tile.launch_count("fwd_b")
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{phase}: kernels disagree with the plain "
                             f"versions at " + "; ".join(failures))
    return result


# The head-count paths at D = 768, each cut to HD_DEPTH blocks: MHLA-B/4
# (S = 3137, W = 7) with 2 and 64 heads through K1/K2, dense ViT-B/4 with 1
# and 64 heads through K5, ViT-B/16 (S = 197) with 2 heads and the fused
# switch through K3/K4's wide blocks with the mask (the flash and band
# kernels launch nothing there), and MHLA-B/4 with 2 and 1 heads (d = 384,
# 768) through the tile band's wgmma kernels under the tile-band
# variables (K1/K2 launch nothing there). Then the tile widths 256 and 192
# (csrc/flash_block256.cuh): dense ViT-B/4 with 3 heads at all 12 blocks
# and with 4 heads, ViT-B/16 with 3 heads and the fused switch (K3/K4 past
# 64 keys, attention dropout 0.1).
HD_TILE_2 = "MHLA-B/4 2 heads (d=384) tile band"
HD_TILE_1 = "MHLA-B/4 1 head (d=768) tile band"
HD_DENSE_3 = "dense ViT-B/4 3 heads (d=256)"
HD_DENSE_4 = "dense ViT-B/4 4 heads (d=192)"
HD_FUSED_3 = "ViT-B/16 fused 3 heads (d=256)"
HD_PATHS = tuple(
    _H14(label, w, op, env or None, idle, HD_IMG, depth, HD_DIM, heads,
         patch, "headdims")
    for label, w, op, env, idle, heads, patch, depth in (
        ("MHLA-B/4 2 heads (d=384)", HD_W, None, {}, (tile,), 2, 4,
         HD_DEPTH),
        ("MHLA-B/4 64 heads (d=12)", HD_W, None, {}, (tile,), 64, 4,
         HD_DEPTH),
        ("dense ViT-B/4 1 head (d=768)", None, None, {}, (fused,), 1, 4,
         HD_DEPTH),
        ("dense ViT-B/4 64 heads (d=12)", None, None, {}, (fused,), 64, 4,
         HD_DEPTH),
        ("ViT-B/16 fused 2 heads (d=384)", None, fused,
         {"FAVIT_FUSED_MHA": "1"}, (flash, band), 2, 16, HD_DEPTH),
        (HD_TILE_2, HD_W, tile, TILE_ENV, (band,), 2, 4, HD_DEPTH),
        (HD_TILE_1, HD_W, tile, TILE_ENV, (band,), 1, 4, HD_DEPTH),
        (HD_DENSE_3, None, None, {}, (fused,), 3, 4, DEPTH),
        (HD_DENSE_4, None, None, {}, (fused,), 4, 4, HD_DEPTH),
        (HD_FUSED_3, None, fused, {"FAVIT_FUSED_MHA": "1"}, (flash, band),
         3, 16, HD_DEPTH)))


def phase_headdims() -> dict:
    """The head-count paths (HD_PATHS) end to end, weights carried from
    seeded Flax-layout trees through ``convert/from_jax.py``: each cut to 2
    blocks against the CPU, then served through ``BatchingServer`` and
    HTTP and trained 3 steps with its launches checked; MHLA-B/4 with 2
    heads also exported and served bit-equal from its artifact, on K1 and
    on the tile band (``favit::tile_band_fwd``). Returns the launches by
    path."""
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, p in enumerate(HD_PATHS):
            counts = total.setdefault(p.label, {})
            t0 = time.perf_counter()
            sd = p.to_sd(p.tree(p.depth, 30 + i))
            log("headdims", f"{p.label}: {p.depth} blocks, S={p.s}, a "
                            f"seeded Flax-layout tree through "
                            f"convert/from_jax.py in "
                            f"{time.perf_counter() - t0:.1f} s")
            with _environ(p.env):
                phase_h14_parity(p, p.tree(2, 40 + i))
                weights = os.path.join(tmp, f"{i}.pt")
                torch.save(sd, weights)
                counts["serve"] = phase_h14_serve(p, weights)
                if i == 0 or p.label == HD_TILE_2:
                    exported = phase_export(
                        p.path, None, state_dict=sd, geom_flags=p.flags(),
                        img=p.img, batch=H14_BATCH, sizes=H14_SIZES,
                        depth=p.depth, patch=p.patch, name=p.label,
                        bit_equal=True)
                    counts["export"] = exported["launches"]
                    log("headdims-export", f"{p.label}: artifact {exported}")
                torch.cuda.empty_cache()
                counts["train"] = phase_h14_train(p, sd)
            torch.cuda.empty_cache()
    return total


def main() -> None:
    t0 = time.perf_counter()

    def mark(done: str) -> None:
        log("time", f"{done} done at {time.perf_counter() - t0:.1f} s")

    name = phase_device()
    phase_build()
    mark("build")
    timing = phase_kernel()
    mark("kernel")
    train_timing = phase_kernel_train()
    mark("kernel-train")
    # ViT-H/14: the kernels at d = 80 and W up to 129, then the
    # three H/14 paths end to end.
    h14_timing = phase_kernel_h14()
    mark("kernel-h14")
    h14 = phase_h14()
    torch.cuda.empty_cache()
    mark("h14")
    # The opt-in kernels (K3/K4, K6/K7/K8) at JAX's head dims and windows,
    # then dense ViT-H/14 through K3/K4 and MHLA-H/14 through the tile band.
    optin_timing = phase_kernel_h14_optin()
    mark("kernel-h14-optin")
    # The tile band past W = 129 and d = 256 (the wgmma kernels), then
    # its paths: MHLA-H/14 at W = 257 below, MHLA-B/4 with 2 and 1 heads in
    # the head-count paths.
    range_timing = phase_kernel_tileband_range()
    mark("kernel-tileband-range")
    optin = phase_h14_optin()
    torch.cuda.empty_cache()
    mark("h14-optin")
    # Every head count the CLI takes at D = 768 (1, 2 and 64 heads): the
    # kernels at head dims off the grid of 8 and past 256, then the paths.
    hd_timing = phase_kernel_headdims()
    mark("kernel-headdims")
    headdims = phase_headdims()
    torch.cuda.empty_cache()
    mark("headdims")

    rng = np.random.default_rng(0)
    image = _images(rng, 1)
    launches, train_launches = {}, {}
    exports, flags_launches = {}, {}
    for path, attn_dropout_launches in ((MHLA, True), (DENSE, False)):
        if path is DENSE:
            flash_timing = phase_kernel_flash()
            mark("kernel-flash")
        cpu_model = path.build(
            generator=torch.Generator().manual_seed(0)).eval()
        ref_probs = phase_model(path, cpu_model, image)
        torch.cuda.empty_cache()
        launches[path] = phase_serve(path, cpu_model, image, ref_probs)
        mark(f"{path.name} model, serve")
        exports[path] = phase_export(path, cpu_model)
        del cpu_model
        torch.cuda.empty_cache()
        mark(f"{path.name} export")
        phase_train_parity(path)
        train_launches[path] = phase_train(path, attn_dropout_launches)
        torch.cuda.empty_cache()
        mark(f"{path.name} train-parity, train")
        flags_launches[path] = phase_train_flags(
            path, ("band_weights",) if path is MHLA else (),
            profile=path is MHLA)
        mark(f"{path.name} train-flags")

    phase_mhla_mask()
    mark("mhla-mask")
    with tempfile.TemporaryDirectory() as tmp:
        parallel_launches = phase_parallel(tmp)
        torch.cuda.empty_cache()
        mark("parallel")
        with _world_one(tmp):
            phase_sequence(CARD)
            pipeline_launches = phase_pipeline(tmp, CARD)
            mesh_serve_launches = phase_mesh_serve(CARD)
    torch.cuda.empty_cache()
    mark("sequence, pipeline, mesh-serve")

    fused_timing = phase_kernel_fused()
    mark("kernel-fused")
    e1_launches = phase_e1()
    mark("e1")
    phase_e1_parity()
    fused_export_launches = phase_export_fused()
    mark("e1-train-parity, e1-fused-export")

    # The fixture's directory lives until the checkpoint phases have run.
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    fixture = phase_pretrained_fixture(tmp)
    e3_launches = phase_e3(tmp, fixture)
    mark("pretrained-fixture, e3")
    e5_launches = phase_e5(tmp, fixture)
    mark("e5")
    pmhla_launches = phase_pretrained_mhla(image)
    mark("pretrained-mhla")
    phase_slic()
    phase_sppp_model()
    mark("slic, sppp-model")
    e6_launches = phase_sppp_experiments(tmp, fixture)
    del fixture
    mark("e2, e4, e6")
    psppp_launches = phase_pretrained_sppp_mhla()
    mark("pretrained-sppp-mhla")

    tile_timing = phase_kernel_tileband()
    mark("kernel-tileband")
    with _environ(TILE.env):
        cpu_model = TILE.build(
            generator=torch.Generator().manual_seed(0)).eval()
        ref_probs = phase_model(TILE, cpu_model, image)
        torch.cuda.empty_cache()
        launches[TILE] = phase_serve(TILE, cpu_model, image, ref_probs)
        exports[TILE] = phase_export(TILE, cpu_model)
        del cpu_model
        launches[TILE] += phase_tile_serve_b16()
        torch.cuda.empty_cache()
        phase_train_parity(TILE)
        train_launches[TILE] = phase_train(TILE, False)
        torch.cuda.empty_cache()
    mark("tile band")

    # Checkpoint, resume and preemption, and the cross-attention suites:
    # last, and without the profiler, whose later sessions in one process
    # record fewer and fewer launches (profile_device_ms).
    phase_e7_e8(tmp)
    mark("e7-e8")
    preempt_launches, ckpt, resumed = phase_preempt(tmp)
    phase_serve_checkpoint(ckpt, resumed)
    del resumed
    tmp_dir.cleanup()
    mark("preempt, serve-checkpoint")
    ckpt_launches = phase_checkpoint()
    mark("checkpoint")

    log("export", "a batch of 32 from the artifact against the live path "
                  "(ms, CUDA-event medians), and the kernel launches of the "
                  "artifacts (counted inside the favit:: ops, included in "
                  "the kernels line): " + "; ".join(
                      f"{p.name} {e['artifact_ms']:.2f} against "
                      f"{e['live_ms']:.2f}, {p.op_name} {e['launches']}"
                      for p, e in exports.items())
        + f"; ViT-B/16 fused {fused_export_launches}")

    tpu = "focused_attention_vit_tpu/ops/mhla_band_roll.py"
    tpu_flash = "focused_attention_vit_tpu/ops/flash_attention_pallas.py"
    tpu_fused = "focused_attention_vit_tpu/ops/mha_kernel.py"
    tpu_tile = "focused_attention_vit_tpu/ops/mhla_kernel_v4.py"
    kernels = [
        # K1 also serves PretrainedViTWithMHLA (S = 3137) and, under
        # FAVIT_MHLA_IMPL=roll, PretrainedSPPPViTWithMHLA (S = 17), at W = 4.
        # The eval forwards also run from the serving artifacts (export
        # phases; counted inside the favit:: ops), and the training forms
        # and backwards in the train-flags phases (remat).
        ("mhla_band_fwd", band.KERNEL_SOURCE, f"{tpu}:158",
         launches[MHLA] + pmhla_launches + psppp_launches
         + exports[MHLA]["launches"] + mesh_serve_launches
         + h14["band"]["fwd"], timing["bf16"]),
        # K1's training form and K2 also run in the checkpoint phase's steps,
        # inside DDP, FSDP2 and tensor parallelism (parallel phase) and in
        # each stage of the pipeline (pipeline phase).
        ("mhla_band_fwd_train", band.KERNEL_SOURCE, f"{tpu}:158",
         train_launches[MHLA]["fwd_train"] + ckpt_launches["fwd_train"]
         + flags_launches[MHLA]["fwd_train"]
         + parallel_launches["fwd_train"] + pipeline_launches["fwd_train"]
         + h14["band"]["fwd_train"], train_timing["bf16"]["fwd_train"]),
        ("mhla_band_bwd", band.BWD_KERNEL_SOURCE, f"{tpu}:199",
         train_launches[MHLA]["bwd"] + ckpt_launches["bwd"]
         + flags_launches[MHLA]["bwd"] + parallel_launches["bwd"]
         + pipeline_launches["bwd"] + h14["band"]["bwd"],
         train_timing["bf16"]["bwd"]),
        # K5 also serves and trains dense ViT-H/14 (d = 80, S = 1370).
        ("flash_attention_fwd", flash.FWD_KERNEL_SOURCE, f"{tpu_flash}:73",
         launches[DENSE] + exports[DENSE]["launches"] + h14["flash"]["fwd"],
         flash_timing["bf16"]["fwd"]),
        ("flash_attention_fwd_train", flash.FWD_KERNEL_SOURCE,
         f"{tpu_flash}:73", train_launches[DENSE]["fwd_train"]
         + flags_launches[DENSE]["fwd_train"] + h14["flash"]["fwd_train"],
         flash_timing["bf16"]["fwd_train"]),
        ("flash_attention_bwd", flash.BWD_KERNEL_SOURCE, f"{tpu_flash}:73",
         train_launches[DENSE]["bwd"] + flags_launches[DENSE]["bwd"]
         + h14["flash"]["bwd"], flash_timing["bf16"]["bwd"]),
        # K3/K4 run in E1, E3 and E1 resumed after preemption, with the
        # fused switch on; K3's eval forward also from the ViT-B/16
        # artifact.
        ("fused_mha_fwd", fused.FWD_KERNEL_SOURCE, f"{tpu_fused}:59",
         e1_launches["fwd"] + e3_launches["fwd"] + preempt_launches["fwd"]
         + fused_export_launches, fused_timing["bf16"]["fwd"]),
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
         + e6_launches["fwd"] + exports[TILE]["launches"],
         tile_timing["fwd"]),
        ("mhla_tile_band_bwd", tile.BWD_KERNEL_SOURCE, f"{tpu_tile}:104",
         train_launches[TILE]["bwd"] + e5_launches["bwd"]
         + e6_launches["bwd"], tile_timing["bwd"]),
        ("mhla_tile_band_fwd_tiles", tile.KERNEL_SOURCE, f"{tpu_tile}:383",
         tile_timing["fwd_b_launches"], tile_timing["fwd_b"]),
    ]
    # The new widths on the ViT-H/14 paths: K3/K4 at d = 80, S = 257 (dense
    # ViT-H/14 at 224^2 with the fused switch); K6/K7 at d = 80 (the wide
    # kernels) at W = 7 and 129 (MHLA-H/14 through the tile band, W = 129
    # also from its artifact); K8 at d = 80, W = 129, launched by
    # kernel-h14-optin.
    fz = optin["dense ViT-H/14 fused"]
    t7 = optin["MHLA-H/14 W=7 tile band"]
    t129 = optin[f"MHLA-H/14 W={H14_WIDE_W} tile band"]
    f80 = optin_timing["fused"][(80, H14_FUSED_S)]
    kernels += [
        ("fused_mha_fwd@d80", fused.FWD_KERNEL_SOURCE, f"{tpu_fused}:59",
         fz["serve"]["fwd"], f80["fwd"]),
        ("fused_mha_fwd_train@d80", fused.FWD_KERNEL_SOURCE,
         f"{tpu_fused}:59", fz["train"]["fwd_train"], f80["fwd_train"]),
        ("fused_mha_bwd@d80", fused.BWD_KERNEL_SOURCE, f"{tpu_fused}:83",
         fz["train"]["bwd"], f80["bwd"]),
        ("mhla_tile_band_fwd@d80,W7", tile.KERNEL_SOURCE, f"{tpu_tile}:66",
         t7["serve"]["fwd"] + t7["train"]["fwd"],
         optin_timing["tile"][(80, 7)]["fwd"]),
        ("mhla_tile_band_bwd@d80,W7", tile.BWD_KERNEL_SOURCE,
         f"{tpu_tile}:104", t7["train"]["bwd"],
         optin_timing["tile"][(80, 7)]["bwd"]),
        (f"mhla_tile_band_fwd@d80,W{H14_WIDE_W}", tile.KERNEL_SOURCE,
         f"{tpu_tile}:66", t129["serve"]["fwd"] + t129["export"]
         + t129["train"]["fwd"],
         optin_timing["tile"][(80, H14_WIDE_W)]["fwd"]),
        (f"mhla_tile_band_bwd@d80,W{H14_WIDE_W}", tile.BWD_KERNEL_SOURCE,
         f"{tpu_tile}:104", t129["train"]["bwd"],
         optin_timing["tile"][(80, H14_WIDE_W)]["bwd"]),
        (f"mhla_tile_band_fwd_tiles@d80,W{H14_WIDE_W}", tile.KERNEL_SOURCE,
         f"{tpu_tile}:383", optin_timing["fwd_b_launches"],
         optin_timing["tile"][(80, H14_WIDE_W)]["fwd_b"]),
    ]
    # The head-count paths' widths (phase_headdims): K5 at d = 768, 12, 256
    # and 192 (dense ViT-B/4, 1, 64, 3 and 4 heads), K1/K2 at d = 384 and 12
    # (MHLA-B/4, 2 and 64 heads; d = 384 also from its artifact), K3/K4 at
    # d = 384 and 256 (ViT-B/16, 2 and 3 heads, the fused switch on).
    hd_rows = (
        ("flash_attention", "flash", flash.FWD_KERNEL_SOURCE,
         flash.BWD_KERNEL_SOURCE, f"{tpu_flash}:73", f"{tpu_flash}:73",
         ((768, "dense ViT-B/4 1 head (d=768)"),
          (12, "dense ViT-B/4 64 heads (d=12)"), (256, HD_DENSE_3),
          (192, HD_DENSE_4))),
        ("mhla_band", "band", band.KERNEL_SOURCE, band.BWD_KERNEL_SOURCE,
         f"{tpu}:158", f"{tpu}:199",
         ((384, "MHLA-B/4 2 heads (d=384)"),
          (12, "MHLA-B/4 64 heads (d=12)"))),
        ("fused_mha", "fused", fused.FWD_KERNEL_SOURCE,
         fused.BWD_KERNEL_SOURCE, f"{tpu_fused}:59", f"{tpu_fused}:83",
         ((384, "ViT-B/16 fused 2 heads (d=384)"), (256, HD_FUSED_3))),
    )
    for stem, key, fwd_src, bwd_src, fwd_at, bwd_at, cases in hd_rows:
        for d, label in cases:
            c, t = headdims[label], hd_timing[key][d]
            kernels += [
                (f"{stem}_fwd@d{d}", fwd_src, fwd_at,
                 c["serve"]["fwd"] + c.get("export", 0), t["fwd"]),
                (f"{stem}_fwd_train@d{d}", fwd_src, fwd_at,
                 c["train"]["fwd_train"], t["fwd_train"]),
                (f"{stem}_bwd@d{d}", bwd_src, bwd_at, c["train"]["bwd"],
                 t["bwd"]),
            ]
    # The wgmma tile band on its paths: K6/K7 at d = 384 and 768
    # (MHLA-B/4 with 2 and 1 heads, W = 7; d = 384 also from its artifact)
    # and at d = 80, W = 257 (MHLA-H/14); K8 there, launched by
    # kernel-tileband-range.
    rt = range_timing["tile"]
    for d, label in ((384, HD_TILE_2), (768, HD_TILE_1)):
        c = headdims[label]
        kernels += [
            (f"mhla_tile_band_fwd@d{d}", tile.KERNEL_SOURCE,
             f"{tpu_tile}:66",
             c["serve"]["fwd"] + c["train"]["fwd"] + c.get("export", 0),
             rt[(d, HD_W)]["fwd"]),
            (f"mhla_tile_band_bwd@d{d}", tile.BWD_KERNEL_SOURCE,
             f"{tpu_tile}:104", c["train"]["bwd"], rt[(d, HD_W)]["bwd"]),
        ]
    t257 = optin[f"MHLA-H/14 W={H14_STREAM_W} tile band"]
    r257 = rt[(80, H14_STREAM_W)]
    kernels += [
        (f"mhla_tile_band_fwd@d80,W{H14_STREAM_W}", tile.KERNEL_SOURCE,
         f"{tpu_tile}:66", t257["serve"]["fwd"] + t257["train"]["fwd"],
         r257["fwd"]),
        (f"mhla_tile_band_bwd@d80,W{H14_STREAM_W}", tile.BWD_KERNEL_SOURCE,
         f"{tpu_tile}:104", t257["train"]["bwd"], r257["bwd"]),
        (f"mhla_tile_band_fwd_tiles@d80,W{H14_STREAM_W}", tile.KERNEL_SOURCE,
         f"{tpu_tile}:383", range_timing["fwd_b_launches"], r257["fwd_b"]),
    ]
    for name_, _, _, count, _ in kernels:
        if count <= 0:
            raise AssertionError(f"{name_} was launched no time on its path")
    log("h14", "ViT-H/14 paths' launches (included in the kernels line): "
               f"{h14}; bf16 times at the H/14 shapes (ms: kernel, plain, "
               f"library, bound): " + json.dumps(h14_timing))
    log("h14-optin", "opt-in ViT-H/14 paths' launches (the new-width rows "
                     f"of the kernels line): {optin}; bf16 times at the H/14 "
                     f"shapes (ms: kernel, plain, library, bound): "
        + json.dumps({f"{kind} {key}": forms
                      for kind in ("fused", "tile")
                      for key, forms in optin_timing[kind].items()}))
    log("headdims", "head-count paths' launches (the @d rows of the kernels "
                    f"line): {headdims}")
    log("kernel-tileband-range", "bf16 times of the wgmma tile band (ms: "
                                 "kernel, plain, library, bound): "
        + json.dumps({f"d={d} W={w}": forms for (d, w), forms in
                      range_timing["tile"].items()}))
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
