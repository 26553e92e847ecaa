"""Ops of the port: patch extraction (``patch_embed``), the MHLA window
formulations (``window``) and the band ops with their CUDA kernels
(``mhla_band_roll``, ``mhla_kernel_v4``), the attention ops (``attention``,
``flash_attention``, ``mha_kernel``, ``philox``), and the SPPP ops: SLIC
(``slic``, with its host connectivity pass ``native_connectivity``),
segment pooling (``segment_pool``) and the encodings (``posenc``).

Unlike the JAX package, this package re-exports no function: the function
``segment_pool`` would shadow its module of the same name."""

# Registers the kernels' forwards as ``favit::`` operators (ops/library.py);
# the op modules call them at run time.
from focused_attention_vit_tpu_torch.ops import library  # noqa: E402,F401
