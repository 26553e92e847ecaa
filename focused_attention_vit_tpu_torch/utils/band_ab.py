"""The S-minor window band's kernels of several checkouts, in turns on one
card.

Times K1 (``csrc/mhla_band_fwd.cu``: the eval forward, and the training
forward at dropout 0.1) and K2 (``csrc/mhla_band_bwd.cu``) at MHLA-B/4's
band shape (B*h=384, S=3137, W=7, d=64, bf16) in each checkout given, each in
a process of its own that imports that checkout's package, in turns: the
order given, then the reverse. Every checkout's kernels are built first, all
at once. With ``--steps`` it then profiles MHLA-B/4's S-minor serving forward
and train step (``utils/step_profile.py``, batch 32) in the same turns. Each
run prints one JSON line: CUDA-event medians of 30 calls, the profiler's
device ms a call by kernel, the largest error against the plain version.
From the repository root, with the parent commit unpacked into an ignored
directory::

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python -m focused_attention_vit_tpu_torch.utils.band_ab build/parent . \\
        --steps

It needs CUDA and raises without it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SHAPE = (32, 12, 64, 3137)  # B, h, d, S of the band at MHLA-B/4, batch 32
WINDOW = 7
RATE = 0.1
SEED = 1234
LIBRARIES = ["mhla_band_fwd", "mhla_band_bwd"]


def turns(trees: list) -> list:
    """The order the runs take: as given, then reversed."""
    return list(trees) + list(reversed(trees))


def _median_ms(fn, repeats: int = 30) -> float:
    for _ in range(3):
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


def _device_ms(fn, calls: int = 20) -> dict:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+)[<(]", e.key)
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0.0) + (
                e.self_device_time_total / 1e3 / calls)
    return out


def time_kernels() -> dict:
    """K1 and K2 of the package on ``sys.path`` at :data:`SHAPE`."""
    from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(SHAPE, device="cuda", generator=gen).bfloat16()
                  for _ in range(4))
    w = WINDOW
    res = {}
    out = band.roll_banded_attention(q, k, v, w)
    res["eval_err"] = float(
        (out.float() - band.plain_banded_attention(q, k, v, w).float())
        .abs().max())
    out, wts = band.band_forward_train(q, k, v, w, RATE, SEED)
    ref, ref_wts = band.plain_band_forward_train(q, k, v, w, RATE, SEED)
    res["train_err"] = float((out.float() - ref.float()).abs().max())
    res["wts_err"] = float((wts - ref_wts).abs().max())
    del ref, ref_wts
    calls = {
        "eval": lambda: band.roll_banded_attention(q, k, v, w),
        "train": lambda: band.band_forward_train(q, k, v, w, RATE, SEED),
        "bwd": lambda: band.band_backward(q, k, v, g, wts, w, RATE, SEED),
    }
    for name, fn in calls.items():
        res[f"{name}_ms"] = _median_ms(fn)
        res[f"{name}_device_ms"] = _device_ms(fn)
    return res


def _run(tree: Path, args: list) -> str:
    proc = subprocess.run(
        [sys.executable, *args], cwd=tree,
        env={**os.environ, "PYTHONPATH": str(tree)},
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(args[:3])} failed in {tree}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trees", nargs="*", type=Path,
                   help="checkouts of the repository (their roots)")
    p.add_argument("--steps", action="store_true",
                   help="also profile the serving forward and train step")
    p.add_argument("--here", action="store_true",
                   help="time the package on sys.path and print one line")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the band A/B runs only on a CUDA device")
    if args.here:
        print(json.dumps(time_kernels()), flush=True)
        return []
    trees = [t.resolve() for t in args.trees]
    build = ("from focused_attention_vit_tpu_torch.utils import kernel_build;"
             f" kernel_build.build_many({LIBRARIES!r})")
    with ThreadPoolExecutor(max(1, len(trees))) as pool:
        list(pool.map(lambda t: _run(t, ["-c", build]), trees))
    rows = []
    for tree in turns(trees):
        line = _run(tree, [__file__, "--here"]).strip().splitlines()[-1]
        rows.append({"tree": str(tree), **json.loads(line)})
        print(json.dumps(rows[-1]), flush=True)
    for mode in ("serve", "train") if args.steps else ():
        for tree in turns(trees):
            out = _run(tree, [
                "-m", "focused_attention_vit_tpu_torch.utils.step_profile",
                "--model", "vit_mhla", "--mode", mode, "--batch_size", "32",
                "--steps", "5"])
            summary = json.loads(out.strip().splitlines()[-1])
            rows.append({"tree": str(tree), "mode": mode,
                         "wall_ms": summary["wall_ms"],
                         "kernel_ms": summary["kernel_ms"],
                         "by_kind_ms": summary["by_kind_ms"]})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
