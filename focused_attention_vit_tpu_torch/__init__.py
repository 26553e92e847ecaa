"""PyTorch/CUDA port of ``focused_attention_vit_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package. This package imports ``torch`` and never
``jax``, ``flax``, ``msgpack``, ``orbax`` or the JAX package. Ported so far:
the eight model classes (:mod:`.models`: the dense and MHLA ViTs,
``PretrainedViTWithMHLA``, the SPPP family and the cross-attention ViTs),
their serving (:mod:`.serve`, :mod:`.infer`) and training (:mod:`.train`,
with checkpoint, resume and preemption), the eight experiments
(:mod:`.experiments`, :mod:`.cli`) with the pretrained-checkpoint loader
(:mod:`.data.pretrained`, :mod:`.convert`, a Flax msgpack reader), and every
TPU kernel as a hand-written CUDA kernel (``csrc/``).
"""


class NotPortedError(NotImplementedError):
    """An option of the JAX package that the port does not have yet."""
