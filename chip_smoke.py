#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Drives the serving path and the training path of
``focused_attention_vit_tpu_torch`` at MHLA-B/4 (D=768, 12 blocks, 12 heads
of d=64, W=7, patch 4 on 224x224, S=3137, 10 classes, seeded random weights)
and checks every CUDA kernel on them. Phases, one or more lines each; any
failure raises and exits non-zero:

1. device: requires CUDA and compute capability 9.0; prints the card's name
   and ``nvidia-smi`` name and power limit;
2. build: compiles both kernel sources from ``csrc/`` with nvcc, in
   parallel;
3. kernel: the eval band kernel against its plain PyTorch version on the
   card (f32 within 1e-5 abs, bf16 within 2 bf16 ulps) over a grid of
   shapes and at the serving shape, with CUDA-event timings of both;
4. kernel-train: the training forward (output, saved weights, dropout mask
   bit for bit) and the backward kernel against their plain versions over a
   grid of shapes and at the training shape, at dropout 0 and 0.1, with
   CUDA-event timings;
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

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

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

import numpy as np
import torch

from focused_attention_vit_tpu_torch import serve, train
from focused_attention_vit_tpu_torch.data.datasets import load_dataset
from focused_attention_vit_tpu_torch.data.pipeline import prepare_eval_batch
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
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
LIBRARIES = ("mhla_band_fwd", "mhla_band_bwd")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    mag = ref.abs().clamp_min(BF16_ULP_FLOOR)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # 8-bit significand
    return float(((got.float() - ref).abs() / ulp).max())


def cuda_median_ms(fn, repeats: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    libs = kernel_build.build_many(LIBRARIES)
    for name in LIBRARIES:
        kernel_build.load(name)
    log("build", f"{', '.join(str(p.relative_to(REPO)) for p in libs)} "
                 f"ready in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        text = (lib.parent / "build.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log("build", f"ptxas {lib.name}: {len(regs)} kernels, registers "
                     f"{min(regs)}-{max(regs)}, spill stores up to "
                     f"{max(spills, default=0)} bytes")


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
            for w in (1, 3, 5, 7):
                # 1000 is not a multiple of the kernel's 128-query tile.
                for s in (2 * w + 1, 197, 577, 1000, 3137):
                    compare((2, 3, d, s), w, dtype)

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        err, (q, k, v) = compare(SERVE_SHAPE, SERVE_W, dtype)
        ms = cuda_median_ms(lambda: band.roll_banded_attention(q, k, v,
                                                               SERVE_W))
        plain_ms = cuda_median_ms(
            lambda: band.plain_banded_attention(q, k, v, SERVE_W))
        nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; out written
        dt = "f32" if dtype == torch.float32 else "bf16"
        log("kernel", f"serving shape {SERVE_SHAPE} W={SERVE_W} {dt}: kernel "
                      f"{ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s of q,k,v,out"
                      f"), plain {plain_ms:.4f} ms (median of 30, CUDA events)")
        result[dt] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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
                for s in (2 * w + 1, 197, 1000, 3137):
                    q, k, v, g = inputs((2, 3, d, s), dtype)
                    for rate, seed in ((0.0, None), (TRAIN_DROPOUT, 1234567)):
                        res = _compare_train(q, k, v, g, w, rate, seed)
                        check(f"{(2, 3, d, s)} W={w} {dt} rate {rate}", res)
                        for n, (e, _, _) in res.items():
                            worst[n] = max(worst.get(n, 0.0), e)
            log("kernel-train", f"{dt} d={d}, W in 1,3,4,5,7, S in 2W+1,197,"
                                f"1000,3137, rate 0 and {TRAIN_DROPOUT}: max "
                                f"abs err " + ", ".join(
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
        log("kernel-train", f"training shape {dt}: training forward "
                            f"{times['fwd_train']:.4f} ms (plain "
                            f"{times['fwd_train_plain']:.4f}), backward "
                            f"{times['bwd']:.4f} ms (plain "
                            f"{times['bwd_plain']:.4f}); median of 30, CUDA "
                            f"events")
        result[dt] = dict(
            fwd_train=dict(max_abs_err=max(res["out"][0], res["wts"][0]),
                           ms=times["fwd_train"],
                           plain_ms=times["fwd_train_plain"]),
            bwd=dict(max_abs_err=max(res[n][0] for n in ("dq", "dk", "dv")),
                     ms=times["bwd"], plain_ms=times["bwd_plain"]),
        )
    return result


def _images(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)


def phase_model(cpu_model: torch.nn.Module, image: np.ndarray) -> np.ndarray:
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    with torch.inference_mode():
        x = prepare_eval_batch(torch.from_numpy(image), 224)
        ref_logits = cpu_model(x)
        band.reset_launch_count()
        logits = gpu_model(x.to("cuda")).cpu()
        launches = band.launch_count()
    ref_probs = torch.softmax(ref_logits, -1)
    probs = torch.softmax(logits, -1)
    dl = float((logits - ref_logits).abs().max())
    dp = float((probs - ref_probs).abs().max())
    log("model", f"MHLA-B/4 f32 batch 1, card vs CPU: max |d logits| {dl:.3g} "
                 f"(tol 1e-3), max |d probs| {dp:.3g} (tol 1e-4), band "
                 f"launches {launches}")
    if not (dl <= 1e-3 and dp <= 1e-4):
        raise AssertionError("MHLA-B/4 on the card disagrees with the CPU")
    if launches != DEPTH:
        raise AssertionError(f"expected {DEPTH} band launches, got {launches}")
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


def phase_serve(cpu_model, image, ref_probs) -> int:
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "mhla_b4.pt")
        torch.save(cpu_model.state_dict(), weights)
        t0 = time.perf_counter()
        args, predictor = serve.setup([
            "--model", "vit_mhla", "--patch_size", "4", "--img_size", "224",
            "--compute_dtype", "bfloat16", "--batch_size", "32",
            "--weights", weights,
        ])
    log("serve", f"set-up (weights, model, warm-up batch) "
                 f"{time.perf_counter() - t0:.1f} s")
    forwards = [0]
    hook = predictor.model.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    band.reset_launch_count()

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
        log("serve", f"{len(reqs)} concurrent requests of {sizes} images and "
                     f"one POST /predict of {len(http_req)}: shapes, finite, "
                     f"rows sum to 1; /stats {stats}")
        if stats["requests"] != len(reqs) + 1:
            raise AssertionError(f"/stats counted {stats['requests']} requests")
        # The served bf16 probabilities of the phase-4 image against the f32
        # reference: bf16 rounding through 12 blocks, so 1e-2 abs.
        dp = float(np.abs(http_out[0] - ref_probs[0]).max())
        log("serve", f"bf16 served probs vs f32 CPU reference: max abs diff "
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
        log("serve", f"full batch of {args.batch_size}: median latency "
                     f"{lat_ms:.2f} ms (host clock, 10 runs, uint8 in to "
                     f"probs out); burst of {len(burst)} x "
                     f"{args.batch_size} through the server: "
                     f"{n_img / wall:.1f} images/s")
    hook.remove()
    launches = band.launch_count()
    log("serve", f"forward passes {forwards[0]}, band launches {launches}")
    if launches != DEPTH * forwards[0] or forwards[0] == 0:
        raise AssertionError(f"band launches {launches} != {DEPTH} x "
                             f"{forwards[0]} forward passes")
    return launches


def _leaf_grads(model: torch.nn.Module) -> dict:
    return {n: p.grad.detach().float().cpu()
            for n, p in model.named_parameters()}


def phase_train_parity() -> None:
    """One train step, card against CPU, f32 with TF32 off (phase_device)."""
    cpu_model = VisionTransformerMHLA(
        img_size=224, patch_size=4, num_classes=10, depth=2,
        generator=torch.Generator().manual_seed(1),
    )
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(2)
    u8, y = _images(rng, 2), rng.integers(0, 10, size=2)
    step = train.make_train_step(224, augment=False)
    metrics = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        state = train.create_train_state(model, train.make_adamw(1e-4))
        band.reset_launch_count()
        _, m = step(state, u8, y, 0)
        metrics[name] = float(m["loss_sum"]) / 2
        if name == "cuda":
            torch.cuda.synchronize()
            counts = [band.launch_count(k) for k in band.LAUNCH_KINDS]
    d_loss = abs(metrics["cuda"] - metrics["cpu"])
    g_gpu, g_cpu = _leaf_grads(gpu_model), _leaf_grads(cpu_model)
    worst, worst_name, worst_err = 0.0, "", 0.0
    for n, ref in g_cpu.items():
        err = float((g_gpu[n] - ref).abs().max())
        bound = PARITY_GRAD_REL * float(ref.abs().max()) + PARITY_GRAD_ABS
        if err / bound > worst:
            worst, worst_name, worst_err = err / bound, n, err
    log("train-parity", f"MHLA-B/4 at depth 2, f32, batch 2, one step: loss "
                        f"card {metrics['cuda']:.6f} CPU {metrics['cpu']:.6f}"
                        f" (|d| {d_loss:.3g}, tol {PARITY_LOSS_TOL}); worst "
                        f"gradient leaf {worst_name}: |d| {worst_err:.3g} = "
                        f"{worst:.3f} of its tolerance ({PARITY_GRAD_REL} x "
                        f"leaf max + {PARITY_GRAD_ABS}); launches (eval fwd, "
                        f"train fwd, bwd) {counts}")
    if d_loss > PARITY_LOSS_TOL or worst > 1.0:
        raise AssertionError("the train step on the card disagrees with the "
                             "CPU")
    if counts != [0, 2, 2]:
        raise AssertionError(f"expected 0 eval, 2 training-forward and 2 "
                             f"backward launches, got {counts}")


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
    for i, block in enumerate(model.blocks):
        for name, p in (("qkv", block.attn.qkv.weight),
                        ("latent_proj", block.attn.latent_proj.weight)):
            if p.grad is None or not bool(
                    torch.isfinite(p.grad).all() & (p.grad.abs().max() > 0)):
                raise AssertionError(f"{what}: blocks.{i}.attn.{name} got no "
                                     f"finite non-zero gradient")


def phase_train() -> dict:
    data = load_dataset(
        "cifar10", data_dir=str(REPO / "build" / "no-cifar"),
        subset_size=6 * TRAIN_BATCH, synthetic_sizes=(1024, 256))
    if not data["synthetic"]:
        raise AssertionError("expected the synthetic CIFAR stand-in")
    band.reset_launch_count()
    lines, passes = [], {"train": 0, "eval": 0}
    runs = (
        # (label, model kwargs, microbatch, data)
        ("dropout 0.1", dict(dropout=TRAIN_DROPOUT), None, data),
        (f"attn_dropout {TRAIN_DROPOUT}, microbatch 16",
         dict(dropout=TRAIN_DROPOUT, attn_dropout=TRAIN_DROPOUT), 16,
         {**data, "train_images": data["train_images"][:2 * TRAIN_BATCH],
          "train_labels": data["train_labels"][:2 * TRAIN_BATCH]}),
    )
    main_state = None
    for i, (label, kwargs, microbatch, run_data) in enumerate(runs):
        model = VisionTransformerMHLA(
            img_size=224, patch_size=4, num_classes=10, depth=DEPTH,
            device="cuda", generator=torch.Generator().manual_seed(3 + i),
            **kwargs)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        t0 = time.perf_counter()
        result, run_passes = _train_run(model, run_data, microbatch, lines)
        for line in lines:
            log("train", f"{label}: {line}")
        lines.clear()
        log("train", f"{label}: {len(run_data['train_images'])} train and "
                     f"{len(run_data['test_images'])} val images in "
                     f"{time.perf_counter() - t0:.1f} s; forward passes "
                     f"{run_passes}")
        _check_trained(model, before, result, label)
        for k in passes:
            passes[k] += run_passes[k]
        if i == 0:
            main_state = result["state"]
        del model, before
    launches = {k: band.launch_count(k) for k in band.LAUNCH_KINDS}
    log("train", f"launches {launches} for {passes} forward passes (each "
                 f"train forward has one backward)")
    expect = {"fwd": DEPTH * passes["eval"],
              "fwd_train": DEPTH * passes["train"],
              "bwd": DEPTH * passes["train"]}
    if launches != expect or passes["train"] == 0 or passes["eval"] == 0:
        raise AssertionError(f"band launches {launches} != {expect}")

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
    log("train", f"MHLA-B/4 train step, bf16 autocast, batch {TRAIN_BATCH}, "
                 f"dropout {TRAIN_DROPOUT}: {ms:.2f} ms per step, "
                 f"{TRAIN_BATCH / ms * 1e3:.1f} images/s (host clock, mean "
                 f"of {n} steps after a warm-up), peak memory {peak:.2f} GiB "
                 f"(max_memory_allocated); last loss "
                 f"{float(m['loss_sum']) / TRAIN_BATCH:.4f}")
    return launches


def main() -> None:
    name = phase_device()
    phase_build()
    timing = phase_kernel()
    train_timing = phase_kernel_train()

    rng = np.random.default_rng(0)
    image = _images(rng, 1)
    cpu_model = VisionTransformerMHLA(
        img_size=224, patch_size=4, num_classes=10, depth=DEPTH,
        generator=torch.Generator().manual_seed(0),
    ).eval()
    ref_probs = phase_model(cpu_model, image)
    torch.cuda.empty_cache()
    launches = phase_serve(cpu_model, image, ref_probs)
    del cpu_model
    torch.cuda.empty_cache()
    phase_train_parity()
    train_launches = phase_train()

    tpu = "focused_attention_vit_tpu/ops/mhla_band_roll.py"
    kernels = [
        ("mhla_band_fwd", band.KERNEL_SOURCE, f"{tpu}:158", launches,
         timing["bf16"]),
        ("mhla_band_fwd_train", band.KERNEL_SOURCE, f"{tpu}:158",
         train_launches["fwd_train"], train_timing["bf16"]["fwd_train"]),
        ("mhla_band_bwd", band.BWD_KERNEL_SOURCE, f"{tpu}:199",
         train_launches["bwd"], train_timing["bf16"]["bwd"]),
    ]
    print(json.dumps({"kernels": [{
        "name": name_,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": count,
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
    } for name_, source, replaces, count, t in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
