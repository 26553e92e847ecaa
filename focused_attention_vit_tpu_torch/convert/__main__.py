"""Checkpoint-conversion CLI (port of
``focused_attention_vit_tpu/convert/__main__.py``): a torch ViT checkpoint
to a state dict of the port's models::

    python -m focused_attention_vit_tpu_torch.convert vit_b_16_weights.pth \\
        vit.pt --format torchvision
    python -m focused_attention_vit_tpu_torch.convert vit.pth mhla.pt \\
        --format reference --to mhla

The output is an f32 state dict of :class:`~..models.VisionTransformer`
(``--to vit``), of :class:`~..models.VisionTransformerMHLA` with
``use_mhla=True`` (``--to mhla``, identity ``latent_proj``) or of
:class:`~..models.SPPPViT` (``--to sppp``, no ``pos_embed``) or of
:class:`~..models.CrossAttentionViT` (``--to cross``: q, k and v split out
of the fused qkv, ``norm1`` in ``norm1_query`` and ``norm1_kv``; with
``--drop_pos_embed``, :class:`~..models.CrossAttentionSPPPViT`'s), written
with ``torch.save``: ``serve --weights OUT.pt --model vit|vit_mhla`` reads
the first two. The JAX CLI writes a Flax msgpack instead. ``--format
reference`` reads the reference repo's ``VisionTransformer`` state dict,
whose keys are already the port's.
"""

from __future__ import annotations

import argparse
import sys

import torch

from focused_attention_vit_tpu_torch.convert import checkpoints as C


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m focused_attention_vit_tpu_torch.convert",
        description="Convert a torch ViT checkpoint to a state dict of the "
                    "port's models.",
    )
    p.add_argument("input", help=".pth/.pt torch state dict")
    p.add_argument("output", help="output .pt path")
    p.add_argument("--format", choices=["torchvision", "reference", "hf"],
                   default="torchvision",
                   help="checkpoint layout (torchvision vit_b_16-family, "
                        "the reference repo's VisionTransformer, or a "
                        "HuggingFace ViTModel state dict)")
    p.add_argument("--to", choices=["vit", "mhla", "sppp", "cross"],
                   default="vit",
                   help="apply the variant surgery after conversion "
                        "(identity latent_proj for mhla, no pos_embed for "
                        "sppp, q/k/v split out of qkv for cross)")
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--embed_dim", type=int, default=768,
                   help="only used to derive head_dim for --to mhla")
    p.add_argument("--num_classes", type=int, default=None,
                   help="keep the checkpoint head only if it matches "
                        "(torchvision/hf formats; reference keeps always)")
    p.add_argument("--drop_pos_embed", action="store_true",
                   help="drop the learned pos_embed (--to mhla and "
                        "--to cross)")
    args = p.parse_args(argv)

    sd = torch.load(args.input, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and not any(
            hasattr(v, "shape") for v in sd.values()):
        sd = sd["state_dict"]

    if args.format == "torchvision":
        state = C.torchvision_vit_to_state_dict(
            sd, depth=args.depth, num_classes=args.num_classes)
    elif args.format == "hf":
        state = C.hf_vit_to_state_dict(
            sd, depth=args.depth, num_classes=args.num_classes)
    else:
        state = C.reference_vit_to_state_dict(sd, depth=args.depth)

    if args.to == "mhla":
        state = C.vit_state_to_mhla(
            state, args.depth, args.embed_dim // args.num_heads,
            keep_pos_embed=not args.drop_pos_embed)
    elif args.to == "sppp":
        state = C.vit_state_to_sppp(state)
    elif args.to == "cross":
        state = C.vit_state_to_cross(
            state, args.depth, keep_pos_embed=not args.drop_pos_embed)

    torch.save(state, args.output)
    n = sum(t.numel() for t in state.values())
    print(f"wrote {args.output} ({n / 1e6:.1f}M params, "
          f"format={args.format}, to={args.to})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
