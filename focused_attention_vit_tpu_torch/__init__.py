"""PyTorch/CUDA port of ``focused_attention_vit_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package. This package imports ``torch`` and never
``jax``, ``flax`` or the JAX package. Ported so far: the serving path of the
MHLA ViT (:mod:`.serve`, :mod:`.infer`, :mod:`.models`, :mod:`.ops`), with
the window band as a hand-written CUDA kernel (``csrc/mhla_band_fwd.cu``).
"""
