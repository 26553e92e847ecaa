"""The MHLA layer at 512 < S <= 2W: a window wider than half the sequence at
a long sequence. JAX's roll branch needs S > 2W, and its other branches take
the gather form there (with per-slot dropout in training); the port's layer
takes the same branches. Held against the JAX layer on the CPU in f32, the
weights carried across by ``convert/from_jax.py``; JAX's reference runs once,
in a module fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu.models.layers import (
    MultiHeadLatentAttention as JaxMHLA,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
)
from focused_attention_vit_tpu_torch.models import layers as tlayers
from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band

torch.set_num_threads(2)

# f32 on both sides; the sums run in different orders (ROADMAP's parity
# rule). Gradients within GRAD_TOL absolute and relative, as
# tests/test_torch_tile_band.py holds them: a bias gradient sums B*S = 1040
# terms of size ~1 to about 50, where one f32 ulp is 4e-6.
OUT_TOL = 1e-4
GRAD_TOL = 1e-5
D, HEADS, W, S, B = 16, 2, 301, 520, 2  # 512 < S = 520 <= 2W = 602


def _layer_state_dict(params, grads=False):
    """The port layer's state dict from the JAX layer's parameters (or
    their gradients), through the model converter's block mapping."""
    zeros = np.zeros
    sd = flax_vit_mhla_to_state_dict({
        "patch_embed": {"projection": {"kernel": zeros((3, D)),
                                       "bias": zeros(D)}},
        "cls_token": zeros((1, 1, D)), "pos_embed": zeros((1, 1, D)),
        "blocks_0": {"attn": params,
                     "norm1": {"scale": np.ones(D), "bias": zeros(D)},
                     "norm2": {"scale": np.ones(D), "bias": zeros(D)},
                     "mlp": {"fc1": {"kernel": zeros((D, 4)),
                                     "bias": zeros(4)},
                             "fc2": {"kernel": zeros((4, D)),
                                     "bias": zeros(D)}}},
        "norm": {"scale": np.ones(D), "bias": zeros(D)},
        "head": {"kernel": zeros((D, 1)), "bias": zeros(1)},
    })
    pre = "blocks.0.attn."
    return {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(S)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    ct = rng.normal(size=(B, S, D)).astype(np.float32)
    jlayer = JaxMHLA(embed_dim=D, num_heads=HEADS, window_size=W)
    params = jax.jit(jlayer.init)(jax.random.PRNGKey(1),
                                  jnp.asarray(x))["params"]

    def loss(p, x_):
        return jnp.sum(jlayer.apply({"params": p}, x_) * jnp.asarray(ct))

    out = jax.jit(jlayer.apply)({"params": params}, jnp.asarray(x))
    grads, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                        jnp.asarray(x))
    return x, ct, params, np.asarray(out), grads, np.asarray(dx)


def _port_layer(params, dropout=0.0):
    layer = tlayers.MultiHeadLatentAttention(D, HEADS, window_size=W,
                                             dropout=dropout)
    layer.load_state_dict(_layer_state_dict(params))
    return layer


def _no_sminor(monkeypatch):
    """The S-minor band needs S > 2W: fail if the layer goes there."""
    def refuse(*args, **kwargs):
        raise AssertionError("S <= 2W took the S-minor band")
    monkeypatch.setattr(tlayers.MultiHeadLatentAttention, "_forward_sminor",
                        refuse)


@pytest.mark.parametrize("impl", ["auto", "roll"])
def test_eval_matches_jax_at_long_s_below_2w(ref, monkeypatch, impl):
    """Under the default ``FAVIT_MHLA_IMPL=auto`` and under ``roll`` the
    layer at S = 520, W = 301 takes the gather form, as JAX does: the
    output within 1e-4. Before the repair it raised (the S-minor branch's
    ``.view`` on the gather form's transposed result)."""
    monkeypatch.setenv("FAVIT_MHLA_IMPL", impl)
    _no_sminor(monkeypatch)
    x, _, params, want, _, _ = ref
    layer = _port_layer(params).eval()
    band.reset_launch_count()
    with torch.inference_mode():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [0, 0, 0]


def test_gradients_match_jax_at_rate_zero(ref, monkeypatch):
    """The gradients of ``sum(out * ct)`` with respect to the input and to
    every parameter, in training mode at dropout 0, within 1e-5 (absolute
    and relative) of JAX's."""
    _no_sminor(monkeypatch)
    x, ct, params, _, want_grads, want_dx = ref
    layer = _port_layer(params).train()
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt, tlayers.DropoutRNG(0)) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    want = _layer_state_dict(want_grads)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_training_step_with_dropout(ref, monkeypatch):
    """A training step at dropout 0.1 (the gather form with per-slot
    dropout, JAX's branch at S <= 2W) runs and returns finite gradients;
    the output's own dropout zeroes about a tenth of it, and a seeded rng
    repeats the step. Before the repair it raised ValueError (band dropout
    requires S > 2W)."""
    _no_sminor(monkeypatch)
    x, ct, params, want, _, _ = ref
    layer = _port_layer(params, dropout=0.1).train()
    outs = []
    for _ in range(2):
        layer.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_()
        out = layer(xt, tlayers.DropoutRNG(7))
        (out * torch.from_numpy(ct)).sum().backward()
        assert torch.isfinite(xt.grad).all()
        for name, p in layer.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    assert 0.08 < float((outs[0] == 0).float().mean()) < 0.12
    assert not torch.equal(outs[0], torch.from_numpy(want))
