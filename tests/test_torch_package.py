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
    "focused_attention_vit_tpu_torch.convert.from_jax",
    "focused_attention_vit_tpu_torch.data.datasets",
    "focused_attention_vit_tpu_torch.data.pipeline",
    "focused_attention_vit_tpu_torch.infer",
    "focused_attention_vit_tpu_torch.models",
    "focused_attention_vit_tpu_torch.models.layers",
    "focused_attention_vit_tpu_torch.ops.mhla_band_roll",
    "focused_attention_vit_tpu_torch.ops.philox",
    "focused_attention_vit_tpu_torch.ops.patch_embed",
    "focused_attention_vit_tpu_torch.ops.window",
    "focused_attention_vit_tpu_torch.serve",
    "focused_attention_vit_tpu_torch.train",
    "focused_attention_vit_tpu_torch.utils.kernel_build",
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
