"""Properties of the PyTorch port as a package: it never imports JAX, its
CPU path launches no kernel, and its kernel build never skips."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band
from focused_attention_vit_tpu_torch.utils import kernel_build

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "focused_attention_vit_tpu_torch",
    "focused_attention_vit_tpu_torch.cli",
    "focused_attention_vit_tpu_torch.convert.from_jax",
    "focused_attention_vit_tpu_torch.data.datasets",
    "focused_attention_vit_tpu_torch.data.pipeline",
    "focused_attention_vit_tpu_torch.experiments",
    "focused_attention_vit_tpu_torch.experiments.base",
    "focused_attention_vit_tpu_torch.experiments.traditional",
    "focused_attention_vit_tpu_torch.infer",
    "focused_attention_vit_tpu_torch.models",
    "focused_attention_vit_tpu_torch.models.layers",
    "focused_attention_vit_tpu_torch.models.vit",
    "focused_attention_vit_tpu_torch.models.vit_mhla",
    "focused_attention_vit_tpu_torch.ops.attention",
    "focused_attention_vit_tpu_torch.ops.flash_attention",
    "focused_attention_vit_tpu_torch.ops.mha_kernel",
    "focused_attention_vit_tpu_torch.ops.mhla_band_roll",
    "focused_attention_vit_tpu_torch.ops.mhla_kernel_v4",
    "focused_attention_vit_tpu_torch.ops.philox",
    "focused_attention_vit_tpu_torch.ops.patch_embed",
    "focused_attention_vit_tpu_torch.ops.window",
    "focused_attention_vit_tpu_torch.serve",
    "focused_attention_vit_tpu_torch.train",
    "focused_attention_vit_tpu_torch.utils.kernel_build",
    "focused_attention_vit_tpu_torch.utils.metrics",
    "focused_attention_vit_tpu_torch.utils.step_profile",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'focused_attention_vit_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_port_module_is_in_the_import_guard():
    """A module added to the port must be added to PORT_MODULES (packages
    are covered by their modules)."""
    pkg = REPO / "focused_attention_vit_tpu_torch"
    found = {
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py"
    }
    listed = set(PORT_MODULES)
    covered = {m for m in found
               if m in listed or m.rsplit(".", 1)[0] in listed}
    assert found == covered, sorted(found - covered)


def _port_sources():
    pkg = REPO / "focused_attention_vit_tpu_torch"
    return sorted(str(p.relative_to(REPO)) for p in pkg.rglob("*.py")) + [
        "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources())
def test_source_names_no_jax_import(path):
    """No source of the port, nor the smoke script, has an import statement
    of jax, flax, optax or the JAX package (docstrings may name them)."""
    import ast

    banned = ("jax", "jaxlib", "flax", "optax", "focused_attention_vit_tpu")
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in banned, f"{path}: {name}"


def test_port_never_calls_a_library_attention():
    """The dense attention is the port's own: no source of the package
    calls PyTorch's fused attention or its attention module."""
    import re

    pat = re.compile(r"(F|functional)\.scaled_dot_product_attention"
                     r"|nn\.MultiheadAttention\(")
    pkg = REPO / "focused_attention_vit_tpu_torch"
    hits = [str(p.relative_to(REPO)) for p in pkg.rglob("*.py")
            if pat.search(p.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::flash_fwd_mma<64, false>(...)",
     "flash kernels"),
    ("void (anonymous namespace)::flash_bwd_dkv_mma<64>(...)",
     "flash kernels"),
    ("void (anonymous namespace)::band_bwd_key_kernel<__nv_bfloat16, 64>",
     "band kernels"),
    ("void (anonymous namespace)::tile_band_fwd_mma<64, false>(...)",
     "tile band kernels"),
    ("void (anonymous namespace)::tile_band_bwd_mma<64>(...)",
     "tile band kernels"),
    ("void (anonymous namespace)::fused_fwd_mma<64, true, true>(...)",
     "fused attention kernels"),
    ("void (anonymous namespace)::fused_bwd_dkv_mma<64, true>(...)",
     "fused attention kernels"),
    # The shared row-sum kernel is booked under the op that launched it.
    ("void flash::flash_delta<__nv_bfloat16, 64, flash::for_fused_bwd>(...)",
     "fused attention kernels"),
    ("void flash::flash_delta<__nv_bfloat16, 64, flash::for_flash_bwd>(...)",
     "flash kernels"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "GEMMs"),
    ("void at::native::vectorized_layer_norm_kernel<float, float>",
     "LayerNorm"),
    ("void at::native::elementwise_kernel<128, 4, "
     "at::native::direct_copy_kernel_cuda", "copies and casts"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::GeluCUDAKernelImpl", "GELU"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>", "other elementwise"),
    ("something_else", "other"),
])
def test_step_profile_sorts_kernels_by_kind(name, kind):
    from focused_attention_vit_tpu_torch.utils import step_profile

    assert step_profile.categorize(name) == kind


def test_step_profile_raises_without_cuda():
    from focused_attention_vit_tpu_torch.utils import step_profile

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        step_profile.main(["--depth", "1"])


def test_cpu_tensors_launch_no_kernel():
    from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA

    band.reset_launch_count()
    q, k, v = (torch.randn(1, 2, 16, 40) for _ in range(3))
    band.roll_banded_attention(q, k, v, 7)
    model = VisionTransformerMHLA(img_size=96, patch_size=4, num_classes=3,
                                  embed_dim=32, depth=1, num_heads=2)
    with torch.inference_mode():
        model(torch.zeros(1, 96, 96, 3))  # S = 577: the band op's branch
    assert band.launch_count() == 0


def test_cpu_training_launches_no_kernel():
    from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
    from focused_attention_vit_tpu_torch.models.layers import DropoutRNG

    band.reset_launch_count()
    model = VisionTransformerMHLA(img_size=96, patch_size=4, num_classes=3,
                                  embed_dim=32, depth=1, num_heads=2,
                                  attn_dropout=0.1).train()
    model(torch.zeros(1, 96, 96, 3), DropoutRNG(0, "cpu")).sum().backward()
    assert model.blocks[0].attn.qkv.weight.grad is not None
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [0, 0, 0]


def test_cpu_fused_attention_launches_no_kernel(monkeypatch):
    """With the fused switch on, a CPU ViT runs the fused op's plain
    versions, eval and training, and launches nothing."""
    from focused_attention_vit_tpu_torch.models import VisionTransformer
    from focused_attention_vit_tpu_torch.models.layers import DropoutRNG
    from focused_attention_vit_tpu_torch.ops import mha_kernel as fused

    monkeypatch.setenv("FAVIT_FUSED_MHA", "1")
    fused.reset_launch_count()
    model = VisionTransformer(img_size=16, patch_size=4, num_classes=3,
                              embed_dim=32, depth=1, num_heads=2,
                              attn_dropout=0.1)
    with torch.inference_mode():
        model.eval()(torch.zeros(1, 16, 16, 3))
    model.train()(torch.zeros(1, 16, 16, 3),
                  DropoutRNG(0, "cpu")).sum().backward()
    assert model.blocks[0].attn.qkv.weight.grad is not None
    assert [fused.launch_count(k) for k in fused.LAUNCH_KINDS] == [0, 0, 0]


def test_cpu_tile_band_launches_no_kernel(monkeypatch):
    """With the tile-band variables set, a CPU MHLA ViT runs the plain
    versions, eval and training, at short and long S, and launches
    nothing."""
    from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
    from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile

    monkeypatch.setenv("FAVIT_MHLA_IMPL", "shiftband")
    monkeypatch.setenv("FAVIT_USE_PALLAS_MHLA", "1")
    tile.reset_launch_count()
    band.reset_launch_count()
    for img in (16, 96):  # S = 17 and S = 577
        model = VisionTransformerMHLA(img_size=img, patch_size=4,
                                      num_classes=3, embed_dim=32, depth=1,
                                      num_heads=2)
        with torch.inference_mode():
            model.eval()(torch.zeros(1, img, img, 3))
        model.train()(torch.zeros(1, img, img, 3)).sum().backward()
        assert model.blocks[0].attn.qkv.weight.grad is not None
    assert [tile.launch_count(k) for k in tile.LAUNCH_KINDS] == [0, 0, 0]
    assert [band.launch_count(k) for k in band.LAUNCH_KINDS] == [0, 0, 0]


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernel_build, "BUILD_ROOT", tmp_path / "kernels")
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at its default location")
    with pytest.raises(kernel_build.KernelCompileError, match="nvcc not found"):
        kernel_build.build("mhla_band_fwd")
    assert not (tmp_path / "kernels").exists()


def test_library_path_is_keyed_by_source_and_ignored_by_git():
    lib = kernel_build.library_path("mhla_band_fwd")
    assert lib.parent.parent == kernel_build.BUILD_ROOT
    assert lib.parent.name.startswith("mhla_band_fwd-")
    assert (REPO / band.KERNEL_SOURCE).is_file()
    assert (REPO / band.BWD_KERNEL_SOURCE).is_file()
    from focused_attention_vit_tpu_torch.ops import flash_attention as flash

    assert (REPO / flash.FWD_KERNEL_SOURCE).is_file()
    assert (REPO / flash.BWD_KERNEL_SOURCE).is_file()
    from focused_attention_vit_tpu_torch.ops import mha_kernel as fused

    assert (REPO / fused.FWD_KERNEL_SOURCE).is_file()
    assert (REPO / fused.BWD_KERNEL_SOURCE).is_file()
    from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile

    assert (REPO / tile.KERNEL_SOURCE).is_file()
    assert (REPO / tile.BWD_KERNEL_SOURCE).is_file()
    assert kernel_build.BUILD_ROOT == REPO / "build" / "kernels"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()


def test_library_path_changes_with_a_shared_header(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_build.CSRC_DIR, csrc)
    monkeypatch.setattr(kernel_build, "CSRC_DIR", csrc)
    before = [kernel_build.library_path(n)
              for n in ("mhla_band_fwd", "mhla_band_bwd")]
    (csrc / "philox.cuh").write_text(
        (csrc / "philox.cuh").read_text() + "\n// edited\n")
    after = [kernel_build.library_path(n)
             for n in ("mhla_band_fwd", "mhla_band_bwd")]
    assert before[0] != after[0] and before[1] != after[1]
