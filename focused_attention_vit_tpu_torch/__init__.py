"""PyTorch/CUDA port of ``focused_attention_vit_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package. This package imports ``torch`` and never
``jax``, ``flax`` or the JAX package. Ported so far: the dense ViT, the MHLA
ViT and ``PretrainedViTWithMHLA`` (:mod:`.models`), their serving
(:mod:`.serve`, :mod:`.infer`) and training (:mod:`.train`), experiments E1
``traditional``, E3 ``traditional_pretrained`` and E5 ``mhla_pretrained``
(:mod:`.experiments`, :mod:`.cli`) with the pretrained-checkpoint loader
(:mod:`.data.pretrained`, :mod:`.convert`), and every TPU kernel as a
hand-written CUDA kernel (``csrc/``).
"""


class NotPortedError(NotImplementedError):
    """An option of the JAX package that the port does not have yet."""
