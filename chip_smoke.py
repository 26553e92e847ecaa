#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Drives the serving path of ``focused_attention_vit_tpu_torch`` at MHLA-B/4
(D=768, 12 blocks, 12 heads of d=64, W=7, patch 4 on 224x224, S=3137,
10 classes, seeded random weights) and checks every CUDA kernel on it.
Phases, one or more lines each; any failure raises and exits non-zero:

1. device: requires CUDA and compute capability 9.0; prints the card's name
   and ``nvidia-smi`` name and power limit;
2. build: compiles the kernels from ``csrc/`` with nvcc;
3. kernel: the band kernel against its plain PyTorch version on the card
   (f32 within 1e-5 abs, bf16 within 2 bf16 ulps) over a grid of shapes and
   at the serving shape, with CUDA-event timings of both;
4. model: MHLA-B/4 in f32 on the card against the same weights on the CPU;
5. serve: the ``serve`` module's set-up, ``BatchingServer`` and
   ``HTTPFrontend`` answer concurrent requests in bf16; the launch counter
   must equal 12 x the forward passes run.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import copy
import io
import json
import os
import statistics
import subprocess
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from focused_attention_vit_tpu_torch import serve
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
    lib = kernel_build.build("mhla_band_fwd")
    kernel_build.load("mhla_band_fwd")
    log("build", f"{lib.relative_to(REPO)} ready in "
                 f"{time.perf_counter() - t0:.1f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())


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


def main() -> None:
    name = phase_device()
    phase_build()
    timing = phase_kernel()

    rng = np.random.default_rng(0)
    image = _images(rng, 1)
    cpu_model = VisionTransformerMHLA(
        img_size=224, patch_size=4, num_classes=10, depth=DEPTH,
        generator=torch.Generator().manual_seed(0),
    ).eval()
    ref_probs = phase_model(cpu_model, image)
    torch.cuda.empty_cache()
    launches = phase_serve(cpu_model, image, ref_probs)

    bf16 = timing["bf16"]
    print(json.dumps({"kernels": [{
        "name": "mhla_band_fwd",
        "route": "cuda",
        "source": band.KERNEL_SOURCE,
        "replaces": "focused_attention_vit_tpu/ops/mhla_band_roll.py:158",
        "launches": launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
