"""The port's cross-attention family against the JAX package, on the CPU at a
small size: ``CrossAttention``, ``MultiHeadCrossAttention`` and
``CrossAttentionTransformerBlock`` (with and without a mask, a fully masked
row included; dropout's rate and determinism; f32 logits under bf16
autocast), ``CrossAttentionViT`` and ``CrossAttentionSPPPViT`` single- and
multi-head from JAX params (eval logits within 1e-4, gradients within
1e-5), ``vit_state_to_cross`` against JAX's ``vit_params_to_cross`` through
the converter bridge, ``convert --to cross``, and E7/E8 through the CLI:
the eight CSVs' names, columns and deterministic columns against JAX's
``CrossAttentionExperiment``.

A tiny torchvision variant (D=64, 2 blocks, patch 16) is added to both
packages' variant tables for the pretrained sub-experiments C and D."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu import convert as jconvert
from focused_attention_vit_tpu.data import pretrained as jpre
from focused_attention_vit_tpu.experiments.attention import (
    CrossAttentionExperiment as JaxCrossAttentionExperiment,
)
from focused_attention_vit_tpu.models import (
    CrossAttentionSPPPViT as JaxCrossAttentionSPPPViT,
    CrossAttentionViT as JaxCrossAttentionViT,
)
from focused_attention_vit_tpu.models import layers as jlayers
from focused_attention_vit_tpu_torch import cli
from focused_attention_vit_tpu_torch.convert import checkpoints as C
from focused_attention_vit_tpu_torch.convert.__main__ import (
    main as convert_main,
)
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_to_state_dict_for,
)
from focused_attention_vit_tpu_torch.data import pretrained as tpre
from focused_attention_vit_tpu_torch.experiments import attention as tatt
from focused_attention_vit_tpu_torch.models import (
    CrossAttentionSPPPViT,
    CrossAttentionViT,
    VisionTransformer,
)
from focused_attention_vit_tpu_torch.models import layers

torch.set_num_threads(2)

LOGIT_TOL = 1e-4
GRAD_TOL = 1e-5
D, H = 32, 4
RNG = np.random.default_rng(11)
QUERY = RNG.normal(size=(2, 5, D)).astype(np.float32)
KV = RNG.normal(size=(2, 7, D)).astype(np.float32)
COT = RNG.normal(size=(2, 5, D)).astype(np.float32)
MASK = (RNG.random(size=(2, 5, 7)) > 0.3).astype(np.float32)
MASK[0, 1, :] = 0.0  # a fully masked row: uniform weights, not NaN
MASKS = {"none": None, "mask": MASK}


# --- the three layers ---------------------------------------------------------

def _state_from_flax(tree, prefix=""):
    """A layer's Flax params -> the port's state dict: Dense kernels
    transposed, LayerNorm scales as weights, the MLP's fc1/fc2 as the
    reference block's mlp.0/mlp.3."""
    sd = {}
    for name, val in tree.items():
        key = prefix + {"fc1": "0", "fc2": "3"}.get(name, name)
        if isinstance(val, dict):
            sd.update(_state_from_flax(val, key + "."))
        elif name == "kernel":
            sd[prefix + "weight"] = torch.from_numpy(np.asarray(val).T.copy())
        else:
            sd[prefix + ("weight" if name == "scale" else name)] = (
                torch.from_numpy(np.array(val)))
    return sd


LAYERS = {
    "single": (lambda: jlayers.CrossAttention(D),
               lambda: layers.CrossAttention(D)),
    "multi": (lambda: jlayers.MultiHeadCrossAttention(D, H),
              lambda: layers.MultiHeadCrossAttention(D, H)),
    "block-single": (lambda: jlayers.CrossAttentionTransformerBlock(D, H),
                     lambda: layers.CrossAttentionTransformerBlock(D, H)),
    "block-multi": (
        lambda: jlayers.CrossAttentionTransformerBlock(
            D, H, use_multi_head=True),
        lambda: layers.CrossAttentionTransformerBlock(
            D, H, use_multi_head=True)),
}


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(name, mask):
    jmake, tmake = LAYERS[name]
    jmod = jmake()
    m = None if MASKS[mask] is None else jnp.asarray(MASKS[mask])
    q, kv, cot = (jnp.asarray(a) for a in (QUERY, KV, COT))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), q, kv, m)["params"]

    def loss_fn(p, q, kv):
        out = jmod.apply({"params": p}, q, kv, m)
        return jnp.sum(out * cot), out

    (_, want), (gp, gq, gkv) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(params, q, kv)

    mod = tmake()
    mod.load_state_dict(_state_from_flax(params), strict=True)
    tq = torch.from_numpy(QUERY).requires_grad_()
    tkv = torch.from_numpy(KV).requires_grad_()
    tm = None if MASKS[mask] is None else torch.from_numpy(MASKS[mask])
    out = mod(tq, tkv, tm)
    (out * torch.from_numpy(COT)).sum().backward()
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq),
                               atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(gkv),
                               atol=GRAD_TOL, rtol=0)
    want_g = _state_from_flax(gp)
    for pname, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[pname].numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=pname)


def test_single_head_scale_is_the_full_width():
    """The reference's quirk, kept: ``embed_dim**-0.5``, not a head's."""
    q = torch.randn(1, 3, D, generator=torch.Generator().manual_seed(0))
    eye = torch.eye(3).expand(1, 3, 3)
    got = layers._cross_attention_core(q, q, eye, D ** -0.5, None, 0.0, None)
    want = torch.softmax(q @ q.transpose(-1, -2) * D ** -0.5, dim=-1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_fully_masked_row_is_uniform():
    q = torch.randn(1, 2, 4, 8)
    mask = torch.ones(1, 1, 4, 6)
    mask[..., 2, :] = 0
    eye = torch.eye(6).expand(1, 2, 6, 6)
    w = layers._cross_attention_core(q, torch.randn(1, 2, 6, 8), eye, 1.0,
                                     mask, 0.0, None)
    torch.testing.assert_close(w[..., 2, :], torch.full((1, 2, 6), 1 / 6))


def test_logits_and_softmax_are_f32_under_bf16_autocast():
    """JAX computes the logits with ``preferred_element_type=float32``: the
    bf16 q and k are multiplied in f32, not rounded to bf16 logits."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 4, 9, 16, generator=g).to(torch.bfloat16)
               for _ in range(3))
    scale = 16 ** -0.5
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = layers._cross_attention_core(q, k, v, scale, None, 0.0, None)
    weights = torch.softmax(q.float() @ k.float().transpose(-1, -2) * scale,
                            dim=-1)
    want = weights.to(torch.bfloat16) @ v
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_dropout_rate_and_determinism(multi):
    """Dropout on the weights after the softmax: about ``rate`` of them
    zeroed, the kept ones scaled by 1/(1 - rate); a seed gives the same
    mask, another seed another; eval mode drops nothing."""
    rate = 0.3
    q = torch.randn(4, 8, 64, 16)
    eye = torch.eye(64).expand(4, 8, 64, 64)
    plain = layers._cross_attention_core(q, q, eye, 0.25, None, 0.0, None)
    a, b, c = (layers._cross_attention_core(
        q, q, eye, 0.25, None, rate, layers.DropoutRNG(seed))
        for seed in (5, 5, 6))
    dropped = (a == 0).float().mean().item()
    assert abs(dropped - rate) < 0.01
    torch.testing.assert_close(a[a != 0], plain[a != 0] / (1 - rate))
    assert torch.equal(a, b) and not torch.equal(a, c)

    mod = (layers.MultiHeadCrossAttention(D, H, dropout=rate) if multi
           else layers.CrossAttention(D, dropout=rate))
    x = torch.from_numpy(QUERY)
    with torch.no_grad():
        mod.train()
        t1 = mod(x, x, rng=layers.DropoutRNG(3))
        t2 = mod(x, x, rng=layers.DropoutRNG(3))
        t3 = mod(x, x, rng=layers.DropoutRNG(4))
        mod.eval()
        e = mod(x, x, rng=layers.DropoutRNG(3))
        mod.dropout = 0.0
        e0 = mod(x, x)
    assert torch.equal(t1, t2) and not torch.equal(t1, t3)
    assert torch.equal(e, e0) and not torch.equal(t1, e)


# --- the two models -------------------------------------------------------------

GEOM = dict(img_size=32, patch_size=4, num_classes=10, embed_dim=32, depth=2,
            num_heads=4)
X = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
Y = np.array([2, 5])
MODELS = {
    "vit-single": (JaxCrossAttentionViT, CrossAttentionViT, False),
    "vit-multi": (JaxCrossAttentionViT, CrossAttentionViT, True),
    "sppp-single": (JaxCrossAttentionSPPPViT, CrossAttentionSPPPViT, False),
    "sppp-multi": (JaxCrossAttentionSPPPViT, CrossAttentionSPPPViT, True),
}


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name):
    jcls, cls, multi = MODELS[name]
    model_j = jcls(**GEOM, use_multi_head=multi)
    params = jax.jit(model_j.init)(jax.random.PRNGKey(3),
                                   jnp.asarray(X))["params"]

    def loss_fn(p):
        logits = model_j.apply({"params": p}, jnp.asarray(X))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), Y]), logits

    (loss_j, want), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    params, grads_j = (jax.tree.map(np.asarray, t) for t in (params, grads_j))

    model = cls(**GEOM, use_multi_head=multi)
    assert (model.patch_size, model.use_multi_head) == (4, multi)
    sd = flax_to_state_dict_for(model, params)
    assert set(sd) == set(model.state_dict())
    assert ("pos_embed" in sd) == (cls is CrossAttentionViT)
    model.load_state_dict(sd, strict=True)
    loss = torch.nn.functional.cross_entropy(
        model.train()(torch.from_numpy(X)), torch.from_numpy(Y))
    loss.backward()
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_TOL, rtol=0)
    assert abs(loss.item() - float(loss_j)) < GRAD_TOL
    want_g = flax_to_state_dict_for(model, grads_j)
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[pname].numpy(),
                                   atol=GRAD_TOL, err_msg=pname)


def test_model_defaults_and_keys():
    sppp = CrossAttentionSPPPViT(depth=1, embed_dim=32, num_heads=2)
    assert (sppp.patch_size, sppp.num_superpixels, sppp.pooling_type,
            sppp.slic_connectivity, sppp.use_multi_head) == (
                16, 16, "mean", "auto", False)
    assert not hasattr(sppp, "pos_embed")
    vit = CrossAttentionViT(depth=1, embed_dim=32, num_heads=2,
                            use_multi_head=True)
    assert vit.patch_size == 4
    assert isinstance(vit.blocks[0].attn, layers.MultiHeadCrossAttention)
    keys = {k[len("blocks.0."):] for k in vit.state_dict()
            if k.startswith("blocks.0.")}
    assert keys == {f"{m}.{t}" for t in ("weight", "bias") for m in (
        "norm1_query", "norm1_kv", "attn.q_proj", "attn.k_proj",
        "attn.v_proj", "attn.out_proj", "norm2", "mlp.0", "mlp.3")}


# --- the surgery ---------------------------------------------------------------

@pytest.mark.parametrize("keep_pos_embed", [True, False],
                         ids=["vit", "sppp"])
def test_vit_state_to_cross_matches_jax(keep_pos_embed):
    """Through the converter bridge: the port's surgery then JAX's map of a
    reference cross-attention state dict equals JAX's surgery of the
    reference ViT state dict."""
    depth = 2
    vit = VisionTransformer(**dict(GEOM, depth=depth),
                            generator=torch.Generator().manual_seed(4))
    vit_sd = {k: v.numpy() for k, v in vit.state_dict().items()}
    state = C.vit_state_to_cross(vit.state_dict(), depth,
                                 keep_pos_embed=keep_pos_embed)
    cls = CrossAttentionViT if keep_pos_embed else CrossAttentionSPPPViT
    cls(**dict(GEOM, depth=depth)).load_state_dict(state, strict=True)
    got = jconvert.reference_cross_vit_to_flax(
        {k: v.numpy() for k, v in state.items()}, depth, conv_patch=False)
    want = jconvert.vit_params_to_cross(
        jconvert.reference_vit_to_flax(vit_sd, depth, GEOM["num_heads"]),
        depth, keep_pos_embed=keep_pos_embed)
    flat_g, tree_g = jax.tree.flatten(got)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_g == tree_w
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_convert_cli_to_cross(tmp_path, capsys):
    vit = VisionTransformer(img_size=224, patch_size=16, num_classes=1000,
                            embed_dim=64, depth=2, num_heads=4)
    src = tmp_path / "vit.pt"
    torch.save(vit.state_dict(), src)
    for extra, cls in (((), CrossAttentionViT),
                       (("--drop_pos_embed",), CrossAttentionSPPPViT)):
        out = tmp_path / "cross.pt"
        assert convert_main([str(src), str(out), "--format", "reference",
                             "--to", "cross", "--depth", "2", *extra]) == 0
        state = torch.load(out, weights_only=True)
        cls(img_size=224, patch_size=16, num_classes=1000, embed_dim=64,
            depth=2, num_heads=4).load_state_dict(state, strict=True)
        qkv = vit.state_dict()["blocks.1.attn.qkv.weight"]
        assert torch.equal(state["blocks.1.attn.v_proj.weight"], qkv[128:])
    assert "to=cross" in capsys.readouterr().out


# --- E7 and E8 through the CLI against JAX -------------------------------------

TINY = dict(patch_size=16, embed_dim=64, depth=2, num_heads=4)
CLI_GEOM = ["--img_size", "32", "--patch_size", "16", "--embed_dim", "64",
            "--depth", "2", "--num_heads", "4", "--batch_size", "16",
            "--epochs", "1", "--subset_size", "32", "--dropout", "0.0",
            "--pretrained_model_variant", "tiny", "--no_detailed_metrics",
            "--device", "cpu"]
KW = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
          num_classes=10, pretrained_model_variant="tiny")
DETERMINISTIC = [
    "model", "use_pretrained", "pretrained_source",
    "pretrained_model_variant", "freeze_layers", "img_size", "patch_size",
    "embed_dim", "depth", "num_heads", "use_multi_head", "total_parameters",
    "trainable_parameters", "frozen_parameters", "flops", "time_complexity",
    "space_complexity_mb", "model_size_mb", "num_superpixels",
    "traditional_tokens", "sppp_tokens", "token_reduction_factor",
]
CONFIGS = [(multi, cfg) for multi in (False, True) for _, cfg in tatt.SUITE]


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    """Both suites through ``cli.main`` in one directory, with the tiny
    variant's fixture as ``./pretrained_weights`` and a tiny CIFAR-10 in
    the python format (80 training and 16 test images: the synthetic
    stand-in takes seconds to build); returns the results directory."""
    import pickle

    tmp = tmp_path_factory.mktemp("e7e8")
    cifar = tmp / "data" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (16, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 16))}, f)
    with pytest.MonkeyPatch.context() as mp:
        for table in (jpre.TORCHVISION_VARIANTS, tpre.TORCHVISION_VARIANTS):
            mp.setitem(table, "tiny", TINY)
        mp.chdir(tmp)
        tpre.write_fixture("pretrained_weights", "tiny")
        for name in ("cross_attention", "multihead_cross_attention"):
            assert cli.main(["--experiment", name, *CLI_GEOM,
                             "--results_dir", str(tmp / "results"),
                             "--data_dir", str(tmp / "data")]) is None
        yield tmp / "results"


def _jax_row(multi, cfg):
    """JAX's experiment of the same configuration: its CSV name and its
    results row, with the run's measured metrics at 0 and the parameter
    counts of its model's param tree."""
    je = JaxCrossAttentionExperiment(**KW, use_multi_head=multi, **cfg)
    je.metrics = {}
    theory = je.theoretical_metrics()
    shapes = jax.eval_shape(je.build_model().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    je.param_counts = {"total_params": n, "trainable_params": n,
                       "frozen_params": 0}
    je.metrics.update(
        theoretical=theory, model_size={"size_mb": n * 4 / 1024 / 1024},
        training={"avg_epoch_time": 0.0, "total_training_time": 0.0,
                  "final_val_acc": 0.0, "final_val_loss": 0.0,
                  "memory_usage": []},
        evaluation={"test_acc": 0.0, "test_loss": 0.0,
                    "avg_inference_time_per_image": 0.0})
    return je.csv_filename, je.results_row()


def _same(got: str, want) -> bool:
    if isinstance(want, (bool, str)):
        return got == str(want)
    return np.isclose(float(got), float(want), rtol=1e-12, atol=0)


@pytest.mark.parametrize("multi,cfg", CONFIGS, ids=[
    f"{'e8' if m else 'e7'}-{'sppp' if c['use_sppp'] else 'vit'}"
    f"{'-pretrained' if c['use_pretrained'] else ''}" for m, c in CONFIGS])
def test_suite_csv_matches_jax(suites, multi, cfg):
    name, want = _jax_row(multi, cfg)
    with open(suites / name, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == list(want) and len(rows) == 2
    got = dict(zip(*rows))
    for col in DETERMINISTIC:
        if col in want:
            assert _same(got[col], want[col]), (col, got[col], want[col])
    assert np.isfinite([float(got[c]) for c in ("test_loss",
                                                "final_val_loss")]).all()


def test_suites_write_eight_csvs(suites):
    names = sorted(p for p in os.listdir(suites) if p.endswith(".csv"))
    assert names == sorted(_jax_row(m, c)[0] for m, c in CONFIGS)
