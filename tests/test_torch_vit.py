"""The port's dense ViT against the JAX package's, on the CPU, in f32: the
dense attention layer, the two dense blocks and the two models, below and
above the length where the flash op takes over; random geometries; the
weights' round trip; serving ``--model vit``; and one train step. Weights
go from JAX to the port through ``convert/from_jax.py``; gradients and
parameters come back to Flax layout through the JAX package's own
``reference_vit_to_flax`` and ``reference_vit_mhla_to_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from focused_attention_vit_tpu import models as jmodels
from focused_attention_vit_tpu.convert.torch_to_jax import (
    reference_vit_mhla_to_flax,
    reference_vit_to_flax,
)
from focused_attention_vit_tpu.models import layers as jlayers
from focused_attention_vit_tpu.train import state as jstate
from focused_attention_vit_tpu.train import steps as jsteps
from focused_attention_vit_tpu_torch import serve as tserve
from focused_attention_vit_tpu_torch import train
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flatten_params,
    flax_vit_mhla_to_state_dict,
    flax_vit_to_state_dict,
    npz_to_state_dict,
)
from focused_attention_vit_tpu_torch.infer import Predictor
from focused_attention_vit_tpu_torch.models import (
    VisionTransformer,
    VisionTransformerMHLA,
    layers,
)
from focused_attention_vit_tpu_torch.models.layers import DropoutRNG
from focused_attention_vit_tpu_torch.ops import flash_attention as flash

torch.set_num_threads(2)

LOGIT_TOL = 1e-4  # eval outputs, f32 (ROADMAP's parity rule)
GRAD_TOL = 1e-5   # gradients, f32, relative to each leaf's largest entry
D, HEADS, DEPTH = 32, 4, 2
# img 32: patch 8 gives S = 17, the materialised form; patch 1 gives
# S = 1025, past FLASH_MIN_SEQ_LEN, the flash op.
PATCHES = [8, 1]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_leaves_close(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k] / scale, w / scale, atol=tol,
                                   rtol=0, err_msg=k)


def _dummy_tree(block):
    """A one-block model tree around ``block``, to reuse the converters on
    a single block's params."""
    ln = {"scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}
    lin = {"kernel": np.zeros((D, D), np.float32),
           "bias": np.zeros(D, np.float32)}
    full = {"norm1": ln, "norm2": ln, "mlp": {"fc1": lin, "fc2": lin}}
    full.update(block)
    return {"patch_embed": {"projection": lin},
            "cls_token": np.zeros((1, 1, D), np.float32),
            "pos_embed": np.zeros((1, 1, D), np.float32),
            "blocks_0": full, "norm": ln, "head": lin}


def _block_state_dict(block, in_proj_names):
    convert = (flax_vit_mhla_to_state_dict if in_proj_names
               else flax_vit_to_state_dict)
    sd = convert(_dummy_tree(block))
    return {k[len("blocks.0."):]: v for k, v in sd.items()
            if k.startswith("blocks.0.")}


def _assert_block_grads_close(module, flax_grads, in_proj_names):
    """The module's parameter gradients against the Flax gradients of the
    same block, carried into the port's layout by the converter (which is
    linear, so it maps gradients as it maps weights)."""
    want = _block_state_dict(flax_grads, in_proj_names)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert sorted(got) == sorted(k for k in want
                                 if k.split(".")[0] in flax_grads)
    for k, g in got.items():
        scale = max(float(want[k].abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale,
                                   want[k].numpy() / scale, atol=GRAD_TOL,
                                   rtol=0, err_msg=k)


def _tokens(s, seed):
    return np.random.default_rng(seed).normal(size=(2, s, D)).astype(
        np.float32)


@pytest.mark.parametrize("s", [17, 1025])
def test_attention_layer_matches_jax(s):
    x = _tokens(s, s)
    jlayer = jlayers.MultiHeadAttention(embed_dim=D, num_heads=HEADS)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jlayer.apply({"params": params}, jnp.asarray(x))
    tlayer = layers.MultiHeadAttention(D, HEADS).eval()
    sd = _block_state_dict({"attn": params}, in_proj_names=False)
    tlayer.load_state_dict({k[len("attn."):]: v for k, v in sd.items()
                            if k.startswith("attn.")})
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tlayer(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)
    # Gradients of sum(out**2) w.r.t. the input and the parameters.
    (got ** 2).sum().backward()
    gx, gp = jax.grad(
        lambda x_, p_: (jlayer.apply({"params": p_}, x_) ** 2).sum(),
        argnums=(0, 1))(jnp.asarray(x), params)
    _assert_leaves_close({"x": xt.grad.numpy()}, {"x": gx}, GRAD_TOL)
    tblock = torch.nn.Module()
    tblock.attn = tlayer
    _assert_block_grads_close(tblock, {"attn": gp}, False)


@pytest.mark.parametrize("s", [17, 1025])
@pytest.mark.parametrize("kind", ["transformer", "switchable"])
def test_dense_blocks_match_jax(kind, s):
    x = _tokens(s, s + 1)
    in_proj = kind == "switchable"
    if in_proj:
        jblock = jlayers.SwitchableTransformerBlock(
            embed_dim=D, num_heads=HEADS, use_mhla=False)
        tblock = layers.SwitchableTransformerBlock(D, HEADS, use_mhla=False)
    else:
        jblock = jlayers.TransformerBlock(embed_dim=D, num_heads=HEADS)
        tblock = layers.TransformerBlock(D, HEADS)
    params = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # Non-trivial LayerNorm parameters and biases.
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), params)
    tblock.load_state_dict(_block_state_dict(params, in_proj))
    tblock.eval()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tblock(xt)
    want = jblock.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)
    (got ** 2).sum().backward()
    gx, gp = jax.grad(
        lambda x_, p_: (jblock.apply({"params": p_}, x_) ** 2).sum(),
        argnums=(0, 1))(jnp.asarray(x), params)
    _assert_leaves_close({"x": xt.grad.numpy()}, {"x": gx}, GRAD_TOL)
    _assert_block_grads_close(tblock, gp, in_proj)


def _model_pair(kind, patch, seed=0, use_flash=None):
    geom = dict(img_size=32, patch_size=patch, num_classes=10, embed_dim=D,
                depth=DEPTH, num_heads=HEADS)
    if kind == "vit":
        jmodel = jmodels.VisionTransformer(use_flash=use_flash, **geom)
        tmodel = VisionTransformer(use_flash=use_flash, **geom)
        to_sd = flax_vit_to_state_dict
    else:
        jmodel = jmodels.VisionTransformerMHLA(
            use_mhla=False, use_flash=use_flash, **geom)
        tmodel = VisionTransformerMHLA(use_mhla=False, use_flash=use_flash,
                                       **geom)
        to_sd = flax_vit_mhla_to_state_dict
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 32, 32, 3)))["params"]
    tmodel.load_state_dict(to_sd(params))
    return jmodel, params, tmodel


def _to_flax(kind, sd):
    sd = {k: v.detach() for k, v in sd.items()}
    if kind == "vit":
        return reference_vit_to_flax(sd, DEPTH, num_heads=HEADS)
    return reference_vit_mhla_to_flax(sd, DEPTH, False, num_heads=HEADS)


def _images_f32(seed, b=2):
    return np.random.default_rng(seed).normal(size=(b, 32, 32, 3)).astype(
        np.float32)


# use_flash=True on the JAX side takes its chunked online softmax, the
# CPU stand-in of its flash kernel, instead of the materialised form.
@pytest.mark.parametrize("patch,use_flash", [(8, None), (1, None), (1, True)])
@pytest.mark.parametrize("kind", ["vit", "vit_mhla_dense"])
def test_model_logits_and_gradients_match_jax(kind, patch, use_flash):
    jmodel, params, tmodel = _model_pair(kind, patch, use_flash=use_flash)
    x = _images_f32(patch)
    y = np.array([3, 7])
    calls = flash.launch_count("fwd") + flash.launch_count("fwd_train")
    tmodel.eval()
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)

    loss = torch.nn.functional.cross_entropy(
        tmodel(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jl, jg = jax.value_and_grad(jloss)(params)
    assert abs(float(loss.detach()) - float(jl)) < 1e-5
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    _assert_leaves_close(_to_flax(kind, grads), jg, GRAD_TOL)
    # CPU tensors launch no kernel.
    assert flash.launch_count("fwd") + flash.launch_count(
        "fwd_train") == calls


def _fuzz_geometries(seed, n, mhla):
    """The seeded random geometries of the reference parity tests
    (tests/test_parity_torch.py), drawn by the same rule."""
    rng = np.random.default_rng(seed)
    geoms = []
    for _ in range(n):
        patch = int(rng.choice([2, 4, 8]))
        grid = int(rng.integers(2, 6))  # S = grid^2 + 1 in [5, 26]
        heads = int(rng.choice([1, 2, 4]))
        head_dim = int(rng.choice([4, 8, 16]))
        cfg = dict(
            img_size=patch * grid, patch_size=patch, in_channels=3,
            num_classes=int(rng.integers(2, 13)),
            embed_dim=heads * head_dim, depth=int(rng.integers(1, 4)),
            num_heads=heads, mlp_ratio=float(rng.choice([1.0, 2.0, 4.0])),
            dropout=0.0, attn_dropout=0.0, embed_dropout=0.0,
        )
        if mhla:
            cfg["window_size"] = int(rng.choice([1, 3, 5, 7, 29]))
            cfg["use_mhla"] = bool(rng.integers(0, 2))
        geoms.append(cfg)
    return geoms


def _fuzz_id(c):
    return (f"img{c['img_size']}p{c['patch_size']}d{c['embed_dim']}"
            f"h{c['num_heads']}x{c['depth']}c{c['num_classes']}"
            + ("A" if "use_mhla" in c else ""))


@pytest.mark.parametrize(
    "cfg",
    _fuzz_geometries(seed=20260819, n=6, mhla=False)
    + [c for c in _fuzz_geometries(seed=20260820, n=6, mhla=True)
       if not c["use_mhla"]],
    ids=_fuzz_id,
)
def test_dense_fuzz_geometries_match_jax(cfg):
    """The dense ViT at the reference parity suite's six random geometries
    and the MHLA ViT with ``use_mhla=False`` at its dense ones."""
    if "use_mhla" in cfg:
        jmodel = jmodels.VisionTransformerMHLA(**cfg)
        tmodel, to_sd = VisionTransformerMHLA(**cfg), flax_vit_mhla_to_state_dict
    else:
        jmodel = jmodels.VisionTransformer(**cfg)
        tmodel, to_sd = VisionTransformer(**cfg), flax_vit_to_state_dict
    size = cfg["img_size"]
    x = np.random.default_rng(12).normal(size=(2, size, size, 3)).astype(
        np.float32)
    params = jmodel.init(jax.random.PRNGKey(12), jnp.asarray(x))["params"]
    tmodel.load_state_dict(to_sd(params))
    with torch.inference_mode():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["vit", "vit_mhla_dense"])
def test_state_dict_round_trip_is_the_identity(kind, tmp_path):
    """Port ``state_dict()`` -> the JAX package's converter -> ``from_jax``
    gives the same tensors back, also through an ``.npz`` file."""
    _, _, tmodel = _model_pair(kind, 8, seed=4)
    sd = tmodel.state_dict()
    flax = _to_flax(kind, sd)
    back = (flax_vit_to_state_dict if kind == "vit"
            else flax_vit_mhla_to_state_dict)(flax)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    path = tmp_path / "w.npz"
    np.savez(path, **flatten_params(flax))
    loaded = npz_to_state_dict(path, in_proj_names=kind != "vit")
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    # Without the hint, params with no latent_proj are the dense ViT's.
    assert ("blocks.0.attn.qkv.weight" in npz_to_state_dict(path))
    pred = Predictor.from_weights(
        type(tmodel)(img_size=32, patch_size=8, num_classes=10, embed_dim=D,
                     depth=DEPTH, num_heads=HEADS,
                     **({} if kind == "vit" else {"use_mhla": False})),
        path, img_size=32, device="cpu", batch_size=2,
        compute_dtype=torch.float32)
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_dense_model_state_dict_keys_are_the_reference_layout():
    vit = VisionTransformer(img_size=32, patch_size=8, num_classes=10,
                            embed_dim=D, depth=1, num_heads=HEADS)
    keys = set(vit.state_dict())
    assert {"patch_embed.projection.1.weight", "cls_token", "pos_embed",
            "blocks.0.attn.qkv.weight", "blocks.0.attn.proj.bias",
            "blocks.0.mlp.fc2.weight", "norm.weight", "head.bias"} <= keys
    assert len(keys) == 4 + 12 + 4
    sd = vit.state_dict()
    assert abs(float(sd["blocks.0.attn.qkv.weight"].std()) - 0.02) < 0.002
    dense = VisionTransformerMHLA(img_size=32, patch_size=8, num_classes=10,
                                  embed_dim=D, depth=1, num_heads=HEADS,
                                  use_mhla=False)
    sd = dense.state_dict()
    assert abs(float(sd["blocks.0.attn.in_proj_weight"].std()) - 0.02) < 0.002
    assert torch.all(sd["blocks.0.attn.in_proj_bias"] == 0)


@pytest.mark.parametrize("patch", PATCHES)
def test_attention_dropout_paths(patch, monkeypatch):
    """Train mode with ``attn_dropout``: the materialised weights below
    FLASH_MIN_SEQ_LEN, the query-chunked form from it on; seeded, and never
    the flash op."""
    model = VisionTransformer(img_size=32, patch_size=patch, num_classes=10,
                              embed_dim=D, depth=1, num_heads=HEADS,
                              attn_dropout=0.2).train()
    chunked = []
    real = layers.dropout_attention_q_chunked
    monkeypatch.setattr(
        layers, "dropout_attention_q_chunked",
        lambda *a, **kw: chunked.append(1) or real(*a, **kw))
    monkeypatch.setattr(flash, "flash_attention", None)  # must not be called
    x = torch.from_numpy(_images_f32(5))
    a = model(x, DropoutRNG(1, "cpu"))
    b = model(x, DropoutRNG(1, "cpu"))
    c = model(x, DropoutRNG(2, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len(chunked) == (3 if patch == 1 else 0)
    a.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def _images_u8(seed, n, hw=32):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, hw, hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("patch", PATCHES)
def test_serve_model_vit_matches_jax_predictor(patch, tmp_path):
    """``serve.setup(["--model", "vit", ...])`` on the CPU answers through
    ``BatchingServer`` with the JAX Predictor's probabilities."""
    from focused_attention_vit_tpu.infer import Predictor as JaxPredictor

    jmodel, params, tmodel = _model_pair("vit", patch, seed=6)
    path = tmp_path / "vit.pt"
    torch.save(tmodel.state_dict(), path)
    args, pred = tserve.setup([
        "--model", "vit", "--weights", str(path), "--img_size", "32",
        "--patch_size", str(patch), "--embed_dim", str(D), "--depth",
        str(DEPTH), "--num_heads", str(HEADS), "--compute_dtype", "float32",
        "--batch_size", "4", "--device", "cpu",
    ])
    assert isinstance(pred.model, VisionTransformer)
    jpred = JaxPredictor(jmodel, params, img_size=32, batch_size=4,
                         compute_dtype=jnp.float32)
    reqs = [_images_u8(i, n) for i, n in enumerate((1, 3, 4))]
    with tserve.BatchingServer(pred, max_delay_ms=args.max_delay_ms,
                               workers=args.workers) as srv:
        futs = [srv.submit(r) for r in reqs]
        for r, f in zip(reqs, futs):
            got = f.result(timeout=120)
            assert got.shape == (len(r), 10)
            np.testing.assert_allclose(got, jpred.predict_proba(r),
                                       atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["vit", "vit_mhla_dense"])
def test_dense_train_step_matches_jax(kind):
    """One ``make_train_step`` step (augment off, dropout 0, AdamW) at
    S = 1025 against JAX's: loss and updated parameters within 1e-5."""
    jmodel, params, tmodel = _model_pair(kind, 1, seed=7)
    u8 = _images_u8(8, 2)
    y = np.array([1, 9], np.int32)
    lr = 1e-3
    jstate_ = jstate.create_train_state(
        jmodel, None, None, jstate.make_adamw(lr), params)
    jstate_, jm = jsteps.make_train_step(32, augment=False)(
        jstate_, jnp.asarray(u8), jnp.asarray(y), jax.random.PRNGKey(0))
    tstate_ = train.create_train_state(tmodel, train.make_adamw(lr),
                                       device="cpu")
    tstate_, tm = train.make_train_step(32, augment=False)(tstate_, u8, y, 0)
    assert abs(float(tm["loss_sum"]) - float(jm["loss_sum"])) < 1e-5
    assert int(tm["count"]) == int(jm["count"]) == 2
    got = _leaves(_to_flax(kind, tstate_.model.state_dict()))
    want = _leaves(jstate_.params)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if k.endswith("['attn']['qkv']['bias']"):
            # The K rows' gradient is zero by analysis (softmax is shift-
            # invariant per query): both sides hold rounding residue there,
            # which Adam's g / (|g| + eps) turns into steps of up to the
            # learning rate in either direction.
            g, w = g[[0, 2]], w[[0, 2]]  # [3, h, d]: q, v
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)


def test_create_train_state_defaults_to_the_card():
    """Training runs on the card unless asked for the CPU: without CUDA the
    default raises instead of training on the CPU."""
    model = VisionTransformer(img_size=32, patch_size=8, num_classes=10,
                              embed_dim=D, depth=1, num_heads=HEADS)
    if torch.cuda.is_available():
        state = train.create_train_state(model, train.make_adamw(1e-3))
        assert next(state.model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.create_train_state(model, train.make_adamw(1e-3))
    state = train.create_train_state(model, train.make_adamw(1e-3),
                                     device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
