"""How far the fused op's bf16 backward lies from the exact function, over
seeds, beside a plain version that makes the kernels' own roundings.

K4 (``csrc/fused_mha_bwd.cu``) rounds ds = p (dp - delta) scale to bf16 for
its products with K and Q (and the weights for dv = p^T g), as the flash
kernels and JAX's kernels do, and rounds each result once. At S = 197 a
gradient entry sums 197 such terms, so those roundings alone move an
entry by a few bf16 ulps of the tensor's scale, more on some draws than
on others. For each case and seed this prints, for dq, dk and dv at
dropout 0 and 0.1, the worst entry in ulps (counted as chip_smoke.py's
kernel-headdims counts them: at max(|ref|, a quarter of the tensor's
largest |ref|)) and the error's rms over the reference's rms of:

- ``kernel``: the kernel against the plain version run in f32 on the same
  bf16 values (the smoke's comparison);
- ``rounded``: the plain version run in bf16 (ds and the weights cast to
  bf16 for their products, each result rounded once) against the same f32
  reference: what the roundings alone give;
- ``kernel_vs_rounded``: the kernel against the bf16 plain version.

The cases are kernel-headdims' fused shapes (batch 8, S = 197: d = 384 on
the wide blocks, 256 and 192 on ``csrc/flash_block256.cuh``'s) and E1's
head dim 64 at that batch (the whole-row kernel). From the repository
root::

    python -m focused_attention_vit_tpu_torch.utils.bwd_rounding --seeds 16

One JSON line per case and seed, then one summary line per case (the
largest readings over the seeds). It needs CUDA and raises without it.
"""

from __future__ import annotations

import argparse
import json

import torch

from focused_attention_vit_tpu_torch.ops import mha_kernel as fused

CASES = ((8, 2, 197, 384), (8, 3, 197, 256), (8, 4, 197, 192),
         (8, 12, 197, 64))  # B, h, S, d
RATES = (0.0, 0.1)
DROP_SEED = 2**41 + 21
ULP_FLOOR_SHARE = 0.25  # chip_smoke.py FLASH_ULP_FLOOR_SHARE
ULP_FLOOR = 2.0 ** -10  # chip_smoke.py BF16_ULP_FLOOR


def worst_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| in bf16 ulps of max(|ref|, a quarter of the
    largest |ref|)."""
    ref = ref.float()
    floor = max(ULP_FLOOR_SHARE * float(ref.abs().max()), ULP_FLOOR)
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(floor))) - 7)
    return float(((got.float() - ref).abs() / ulp).max())


def rms_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((got.float() - ref).pow(2).mean().sqrt()
                 / ref.pow(2).mean().sqrt().clamp_min(1e-30))


def readings(q, k, v, g, rate: float) -> dict:
    """{grad: {kind: (worst ulps, rms share)}} for one draw."""
    seed = DROP_SEED if rate else None
    out, lse = fused.fused_mha_forward_train(q, k, v, rate, seed)
    grads = fused.fused_mha_backward(q, k, v, out, lse, g, rate, seed)
    exact = fused.plain_fused_mha_backward(
        *(x.float() for x in (q, k, v, g)), rate, seed, out=out.float())
    rounded = fused.plain_fused_mha_backward(q, k, v, g, rate, seed, out=out)
    torch.cuda.synchronize()
    res = {}
    for name, got, ref, rnd in zip(("dq", "dk", "dv"), grads, exact, rounded):
        res[name] = {
            "kernel": (worst_ulps(got, ref), rms_share(got, ref)),
            "rounded": (worst_ulps(rnd, ref), rms_share(rnd, ref)),
            "kernel_vs_rounded": (worst_ulps(got, rnd), rms_share(got, rnd)),
        }
    return res


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, default=16)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the rounding study runs only on a CUDA device")
    # cuBLAS's bf16 products of the rounded version sum in f32 throughout.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    summaries = []
    for shape in CASES:
        top = {}
        for s in range(args.seeds):
            gen = torch.Generator(device="cuda").manual_seed(s)
            q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                          .bfloat16() for _ in range(4))
            for rate in RATES:
                res = readings(q, k, v, g, rate)
                print(json.dumps({"shape": shape, "seed": s, "rate": rate,
                                  **res}), flush=True)
                for name, kinds in res.items():
                    for kind, (ulps, rms) in kinds.items():
                        key = f"{name}@{rate} {kind}"
                        u, r = top.get(key, (0.0, 0.0))
                        top[key] = (max(u, ulps), max(r, rms))
        summaries.append({"shape": shape, "seeds": args.seeds,
                          "largest": top})
        print(json.dumps(summaries[-1]), flush=True)
    return summaries


if __name__ == "__main__":
    main()
