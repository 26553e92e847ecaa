"""The window band's kernels of several checkouts, in turns on one card.

Times K1 (``csrc/mhla_band_fwd.cu``: the eval forward, and the training
forward at dropout 0.1) and K2 (``csrc/mhla_band_bwd.cu``) at MHLA-B/4's
band shape (B*h=384, S=3137, W=7, d=64, bf16), and on the same shape
token-major the tile band's forward (K6, ``csrc/mhla_tile_band_fwd.cu``),
its window-tile forward on JAX's 256-row tiles (K8, the same source) and
its backward as its autograd Function runs it (K7,
``csrc/mhla_tile_band_bwd.cu``, with whatever edge fold the checkout runs
after it, so that every checkout does the same work), and the fused
short-S attention (K3, ``csrc/fused_mha_fwd.cu``: the eval forward and the
training forward at dropout 0.1; K4, ``csrc/fused_mha_bwd.cu``) at E1's
shape (B*h=1536, S=197, d=64: the whole-row kernels) and past the whole-row
kernels (B*h=384, S=577: the flash blocks with the mask), the dense flash
attention (K5, ``csrc/flash_attention_{fwd,bwd}.cu``: eval forward,
training forward, backward) at dense ViT-B/4's shape (B*h=384, S=3137,
d=64) and ViT-H/14's (B*h=128, S=1370, d=80), K1/K2 at ViT-H/14's band
(B*h=128, d=80, S=1370) and K6/K8/K7 at ViT-H/14's token-major band
(B*h=128, S=1370, d=80, W=7 and 129), K6/K8/K7 at the paths' shapes past
the wide kernels (chip_smoke.py's TR_TIMED: d=384 and 768 at W=7,
S=3137; d=80 at W=257 and 683, B*h=128, S=1370) and at d=80, 136, 192,
256 and W=64, 129 and one head of d=1024, 1280, 2048 at W=7
(TILE_RANGE), in each checkout given, each in a
process of its own that imports that checkout's package, in turns: the order given, then the reverse. Every checkout's kernels are
built first, all at once. With ``--steps`` it then profiles MHLA-B/4's
S-minor serving forward and train step and its tile-band serving forward
and train step (``FAVIT_MHLA_IMPL=shiftband FAVIT_USE_PALLAS_MHLA=1``;
``utils/step_profile.py``, batch 32) in the same turns. Each run prints one
JSON line: CUDA-event medians of 30 calls, the profiler's device ms a call by
kernel, the largest error against the plain version. With ``--tile`` only
the tile band's calls are timed. With ``--wide`` only K5 (eval forward,
training forward, backward) and K3/K4 (eval forward, training forward at
dropout 0.1, backward) past head dim 256 are, at chip_smoke.py's
kernel-headdims shapes (batch 8: K5 at d = 264, 384 and 768 at S = 3137
and d = 1280 at S = 1370; K3/K4 at d = 264, 384, 768 and 1280 at S = 197;
WIDE_FLASH, WIDE_FUSED), with K5 at d = 256 (the widest of the blocks up to
256) beside them; in a checkout that has the slice plan's small-grid rule
(``ops/flash_attention.CARD_SMS``), K3/K4 at d = 384 also at the plan with
the rule off (``..._full``).
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
from types import SimpleNamespace

import torch

SHAPE = (32, 12, 64, 3137)  # B, h, d, S of the band at MHLA-B/4, batch 32
WINDOW = 7
RATE = 0.1
SEED = 1234
LIBRARIES = ["mhla_band_fwd", "mhla_band_bwd", "mhla_tile_band_fwd",
             "mhla_tile_band_bwd", "fused_mha_fwd", "fused_mha_bwd",
             "flash_attention_fwd", "flash_attention_bwd"]
# B, h, S, d of the fused op: E1's (ViT-B/16, batch 128) and a row past the
# whole-row kernels (ViT-B/16 at 384 pixels, batch 32).
FUSED_SHAPES = {"fused": (128, 12, 197, 64), "fused_tiled": (32, 12, 577, 64)}
# B, h, S, d of the flash op at dense ViT-B/4 (batch 32) and ViT-H/14 at
# 518^2 (batch 8); B, h, d, S of the band at MHLA-H/14.
FLASH_SHAPES = {"flash": (32, 12, 3137, 64), "flash_h14": (8, 16, 1370, 80)}
BAND_H14_SHAPE = (8, 16, 80, 1370)
# --wide: B, h, S, d of K5 and of K3/K4 past head dim 256 at the one- and
# two-head paths' shapes (chip_smoke.py HD_FLASH, HD_FUSED; d = 264 the
# first wide head dim), and K5 at d = 256.
WIDE_FLASH = {"flash_d256": (8, 3, 3137, 256), "flash_d264": (8, 1, 3137, 264),
              "flash_d384": (8, 2, 3137, 384), "flash_d768": (8, 1, 3137, 768),
              "flash_d1280": (8, 1, 1370, 1280)}
WIDE_FUSED = {"fused_d264": (8, 1, 197, 264), "fused_d384": (8, 2, 197, 384),
              "fused_d768": (8, 1, 197, 768), "fused_d1280": (8, 1, 197, 1280)}
# B*h, S, d of the tile band at MHLA-H/14 (batch 8), at the model's window
# and at JAX's roll-band limit (the wide kernels).
TILE_H14_SHAPE = (128, 1370, 80)
TILE_H14_WINDOWS = (7, 129)
# (d, W, B*h, S) of the tile band past the ring kernels: the paths' shapes
# of chip_smoke.py's TR_TIMED, inside the wide kernels' range d = 80 at
# W = 64 and d = 136, 192, 256 at W = 64 and 129 (where the sources choose
# between the wide and the wgmma kernels), and one head of d = 1024, 1280
# (ViT-H's width) and 2048 at MHLA-H/14's S, where the wgmma kernels stream
# Q (and G) through their ring.
TILE_RANGE = ((384, 7, 16, 3137), (768, 7, 8, 3137), (80, 257, 128, 1370),
              (80, 683, 128, 1370), (80, 64, 128, 1370),
              (136, 64, 128, 1370), (136, 129, 128, 1370),
              (192, 64, 128, 1370), (192, 129, 128, 1370),
              (256, 64, 128, 1370), (256, 129, 128, 1370),
              (1024, 7, 8, 1370), (1280, 7, 8, 1370), (2048, 7, 8, 1370))
TILE_ENV = {"FAVIT_MHLA_IMPL": "shiftband", "FAVIT_USE_PALLAS_MHLA": "1"}
# --steps: (label, step_profile mode, environment).
STEPS = [("serve", "serve", {}), ("train", "train", {}),
         ("tile-serve", "serve", TILE_ENV), ("tile-train", "train", TILE_ENV)]


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
    """Device ms a call by kernel name: the mean of the launches the
    profiler recorded (it can miss some) times the launches a call."""
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
    return {name: total[name] / 1e3 / count[name]
            * max(1, round(count[name] / calls)) for name in total}


def time_kernels(only_tile: bool = False) -> dict:
    """K1 and K2 of the package on ``sys.path`` at :data:`SHAPE`, and its
    tile band's K6, K8 and backward on the same shape token-major (and
    the rest of the module docstring's calls); only the tile band's with
    ``only_tile``."""
    from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
    from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(SHAPE, device="cuda", generator=gen).bfloat16()
                  for _ in range(4))
    w = WINDOW
    res, calls = {}, {}
    if not only_tile:
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
            "bwd": lambda: band.band_backward(q, k, v, g, wts, w, RATE,
                                              SEED),
        }
    b, h, d, s = SHAPE
    calls.update(_tile_calls(res, "tile", [x.view(b * h, s, d)
                                           for x in (q, k, v, g)], w))
    for w14 in TILE_H14_WINDOWS:
        rows = [torch.randn(TILE_H14_SHAPE, device="cuda", generator=gen)
                .bfloat16() for _ in range(4)]
        calls.update(_tile_calls(res, f"tile_h14_w{w14}", rows, w14))
    for dr, wr, bh, sr in TILE_RANGE:
        rows = [torch.randn((bh, sr, dr), device="cuda", generator=gen)
                .bfloat16() for _ in range(4)]
        calls.update(_tile_calls(res, f"tile_d{dr}_w{wr}", rows, wr))
    if only_tile:
        for name, fn in calls.items():
            res[f"{name}_ms"] = _median_ms(fn)
            res[f"{name}_device_ms"] = _device_ms(fn)
        return res
    calls.update(_fused_calls(res, gen))
    calls.update(_flash_calls(res, gen))
    h14 = [torch.randn(BAND_H14_SHAPE, device="cuda", generator=gen)
           .bfloat16() for _ in range(4)]
    _, wts80 = band.band_forward_train(*h14[:3], w, RATE, SEED)
    calls["band_h14_eval"] = lambda: band.roll_banded_attention(*h14[:3], w)
    calls["band_h14_train"] = lambda: band.band_forward_train(
        *h14[:3], w, RATE, SEED)
    calls["band_h14_bwd"] = lambda: band.band_backward(*h14, wts80, w, RATE,
                                                       SEED)
    for name, fn in calls.items():
        res[f"{name}_ms"] = _median_ms(fn)
        res[f"{name}_device_ms"] = _device_ms(fn)
    return res


def time_wide() -> dict:
    """K5 at :data:`WIDE_FLASH` and K3/K4 at :data:`WIDE_FUSED` of the
    package on ``sys.path`` (and K3/K4 at d = 384 with the small-grid rule
    off, where the package has it)."""
    from focused_attention_vit_tpu_torch.ops import flash_attention as flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    calls = _fused_calls(res, gen, WIDE_FUSED)
    calls.update(_flash_calls(res, gen, WIDE_FLASH))
    if hasattr(flash, "CARD_SMS"):
        def full(fn):
            def run():
                old, flash.CARD_SMS = flash.CARD_SMS, 0
                try:
                    return fn()
                finally:
                    flash.CARD_SMS = old
            return run
        for form in ("eval", "train", "bwd"):
            calls[f"fused_d384_full_{form}"] = full(calls[f"fused_d384_{form}"])
    for name, fn in calls.items():
        res[f"{name}_ms"] = _median_ms(fn)
        res[f"{name}_device_ms"] = _device_ms(fn)
    return res


def _tile_calls(res: dict, key: str, rows: list, w: int) -> dict:
    """The tile band's forward (K6) on ``[B*h, S, d]`` rows, its
    window-tile forward (K8) on them at JAX's tile length (256), built once
    outside the timed calls, and its backward as ``_TileBandFunction`` runs
    it (the cast of g, K7 and the edge fold, in whichever place the checkout
    folds, so that every checkout does the same work); their largest errors
    against the plain versions go into ``res``."""
    from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile

    bh, s, d = rows[0].shape
    ctx = SimpleNamespace(saved_tensors=tuple(rows[:3]), window_size=w)
    got = tile._TileBandFunction.backward(ctx, rows[3])[:3]
    ref = tile.plain_tile_band_backward(*rows, w)
    ref = (ref[0], *tile._edge_fold(*rows, *ref[1:], w))
    res[f"{key}_bwd_err"] = max(float((x.float() - y.float()).abs().max())
                                for x, y in zip(got, ref))
    del got, ref
    ref = tile.plain_tile_band_forward(*rows[:3], w)
    res[f"{key}_fwd_err"] = float(
        (tile.tile_band_forward(*rows[:3], w).float() - ref.float())
        .abs().max())
    halo = tile._halo(tile.DEFAULT_BLOCK, w // 2)
    t = max(2 * halo, min(tile.DEFAULT_BLOCK, -(-s // 8) * 8))
    sp = -(-s // t) * t
    ke, ve = (tile._window_tiles(x, t, halo, sp) for x in rows[1:3])
    qt = tile._pad_seq(rows[0], 0, sp - s).reshape(bh, sp // t, t, d)
    qt = qt.contiguous()
    got = tile.window_tile_band(qt, ke, ve, w).reshape(bh, sp, d)[:, :s]
    res[f"{key}_fwd_b_err"] = float((got.float() - ref.float()).abs().max())
    return {f"{key}_bwd": lambda: tile._TileBandFunction.backward(ctx,
                                                                  rows[3]),
            f"{key}_fwd": lambda: tile.tile_band_forward(*rows[:3], w),
            f"{key}_fwd_b": lambda: tile.window_tile_band(qt, ke, ve, w)}


def _fused_calls(res: dict, gen, shapes: dict = FUSED_SHAPES) -> dict:
    """K3's eval and training forwards and K4 at each of ``shapes``, bf16,
    dropout :data:`RATE` in the training forms; their largest errors
    against the plain versions go into ``res``."""
    from focused_attention_vit_tpu_torch.ops import mha_kernel as fused

    calls = {}
    for key, shape in shapes.items():
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      .bfloat16() for _ in range(4))
        out, lse = fused.fused_mha_forward_train(q, k, v, RATE, SEED)
        ref, _ = fused.plain_fused_mha_forward(q.float(), k.float(),
                                               v.float(), RATE, SEED)
        res[f"{key}_err"] = float((out.float() - ref).abs().max())
        del ref
        # No input requires grad: the eval forward.
        calls[f"{key}_eval"] = (
            lambda q=q, k=k, v=v: fused.fused_multi_head_attention(q, k, v))
        calls[f"{key}_train"] = (
            lambda q=q, k=k, v=v: fused.fused_mha_forward_train(
                q, k, v, RATE, SEED))
        calls[f"{key}_bwd"] = (
            lambda q=q, k=k, v=v, out=out, lse=lse, g=g:
            fused.fused_mha_backward(q, k, v, out, lse, g, RATE, SEED))
    return calls


def _flash_calls(res: dict, gen, shapes: dict = FLASH_SHAPES) -> dict:
    """K5's eval and training forwards and its backward at each of
    ``shapes``, bf16; the training output's largest error against the plain
    version goes into ``res``."""
    from focused_attention_vit_tpu_torch.ops import flash_attention as flash

    calls = {}
    for key, shape in shapes.items():
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      .bfloat16() for _ in range(4))
        out, lse = flash.flash_forward_train(q, k, v)
        ref, _ = flash.plain_flash_forward(q, k, v)
        res[f"{key}_err"] = float((out.float() - ref.float()).abs().max())
        del ref
        calls[f"{key}_eval"] = (
            lambda q=q, k=k, v=v: flash.flash_attention(q, k, v))
        calls[f"{key}_train"] = (
            lambda q=q, k=k, v=v: flash.flash_forward_train(q, k, v))
        calls[f"{key}_bwd"] = (
            lambda q=q, k=k, v=v, out=out, lse=lse, g=g:
            flash.flash_backward(q, k, v, out, lse, g))
    return calls


def _run(tree: Path, args: list, env: dict | None = None) -> str:
    proc = subprocess.run(
        [sys.executable, *args], cwd=tree,
        env={**os.environ, **(env or {}), "PYTHONPATH": str(tree)},
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
                   help="also profile the serving forwards and train steps")
    p.add_argument("--here", action="store_true",
                   help="time the package on sys.path and print one line")
    p.add_argument("--tile", action="store_true",
                   help="time the tile band's calls only")
    p.add_argument("--wide", action="store_true",
                   help="time K5 and K3/K4 past head dim 256 only")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the band A/B runs only on a CUDA device")
    if args.here:
        print(json.dumps(time_wide() if args.wide
                         else time_kernels(args.tile)), flush=True)
        return []
    trees = [t.resolve() for t in args.trees]
    libs = ([n for n in LIBRARIES if "tile" in n] if args.tile
            else [n for n in LIBRARIES if "fused" in n or "flash" in n]
            if args.wide else LIBRARIES)
    mode = ["--tile"] if args.tile else ["--wide"] if args.wide else []
    build = ("from focused_attention_vit_tpu_torch.utils import kernel_build;"
             f" kernel_build.build_many({libs!r})")
    with ThreadPoolExecutor(max(1, len(trees))) as pool:
        list(pool.map(lambda t: _run(t, ["-c", build]), trees))
    rows = []
    for tree in turns(trees):
        line = _run(tree, [__file__, "--here", *mode]).strip().splitlines()[-1]
        rows.append({"tree": str(tree), **json.loads(line)})
        print(json.dumps(rows[-1]), flush=True)
    for label, mode, env in STEPS if args.steps else ():
        for tree in turns(trees):
            out = _run(tree, [
                "-m", "focused_attention_vit_tpu_torch.utils.step_profile",
                "--model", "vit_mhla", "--mode", mode, "--batch_size", "32",
                "--steps", "5"], env)
            summary = json.loads(out.strip().splitlines()[-1])
            rows.append({"tree": str(tree), "mode": label,
                         "wall_ms": summary["wall_ms"],
                         "kernel_ms": summary["kernel_ms"],
                         "by_kind_ms": summary["by_kind_ms"]})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
