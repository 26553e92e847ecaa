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
    "focused_attention_vit_tpu_torch.convert.__main__",
    "focused_attention_vit_tpu_torch.convert.checkpoints",
    "focused_attention_vit_tpu_torch.convert.flax_msgpack",
    "focused_attention_vit_tpu_torch.convert.from_jax",
    "focused_attention_vit_tpu_torch.data.datasets",
    "focused_attention_vit_tpu_torch.data.imagenet",
    "focused_attention_vit_tpu_torch.data.native",
    "focused_attention_vit_tpu_torch.data.pipeline",
    "focused_attention_vit_tpu_torch.data.pretrained",
    "focused_attention_vit_tpu_torch.experiments",
    "focused_attention_vit_tpu_torch.experiments.attention",
    "focused_attention_vit_tpu_torch.experiments.base",
    "focused_attention_vit_tpu_torch.experiments.mhla_pretrained",
    "focused_attention_vit_tpu_torch.experiments.pretrained_common",
    "focused_attention_vit_tpu_torch.experiments.sppp",
    "focused_attention_vit_tpu_torch.experiments.sppp_mhla_pretrained",
    "focused_attention_vit_tpu_torch.experiments.sppp_pretrained",
    "focused_attention_vit_tpu_torch.experiments.traditional",
    "focused_attention_vit_tpu_torch.experiments.traditional_pretrained",
    "focused_attention_vit_tpu_torch.export",
    "focused_attention_vit_tpu_torch.infer",
    "focused_attention_vit_tpu_torch.models",
    "focused_attention_vit_tpu_torch.models.attention",
    "focused_attention_vit_tpu_torch.models.layers",
    "focused_attention_vit_tpu_torch.models.mhla_models",
    "focused_attention_vit_tpu_torch.models.sppp",
    "focused_attention_vit_tpu_torch.models.sppp_common",
    "focused_attention_vit_tpu_torch.models.sppp_mhla",
    "focused_attention_vit_tpu_torch.models.vit",
    "focused_attention_vit_tpu_torch.models.vit_mhla",
    "focused_attention_vit_tpu_torch.ops.attention",
    "focused_attention_vit_tpu_torch.ops.flash_attention",
    "focused_attention_vit_tpu_torch.ops.library",
    "focused_attention_vit_tpu_torch.ops.mha_kernel",
    "focused_attention_vit_tpu_torch.ops.mhla_band_roll",
    "focused_attention_vit_tpu_torch.ops.mhla_kernel_v4",
    "focused_attention_vit_tpu_torch.ops.native_connectivity",
    "focused_attention_vit_tpu_torch.ops.philox",
    "focused_attention_vit_tpu_torch.ops.patch_embed",
    "focused_attention_vit_tpu_torch.ops.posenc",
    "focused_attention_vit_tpu_torch.ops.segment_pool",
    "focused_attention_vit_tpu_torch.ops.slic",
    "focused_attention_vit_tpu_torch.ops.window",
    "focused_attention_vit_tpu_torch.parallel",
    "focused_attention_vit_tpu_torch.parallel.launch",
    "focused_attention_vit_tpu_torch.parallel.mesh",
    "focused_attention_vit_tpu_torch.parallel.multihost",
    "focused_attention_vit_tpu_torch.parallel.sharding",
    "focused_attention_vit_tpu_torch.serve",
    "focused_attention_vit_tpu_torch.train",
    "focused_attention_vit_tpu_torch.train.checkpoint",
    "focused_attention_vit_tpu_torch.train.resilience",
    "focused_attention_vit_tpu_torch.utils.band_ab",
    "focused_attention_vit_tpu_torch.utils.bwd_rounding",
    "focused_attention_vit_tpu_torch.utils.kernel_build",
    "focused_attention_vit_tpu_torch.utils.metrics",
    "focused_attention_vit_tpu_torch.utils.patchify",
    "focused_attention_vit_tpu_torch.utils.profiling",
    "focused_attention_vit_tpu_torch.utils.step_profile",
    "focused_attention_vit_tpu_torch.utils.viz",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'orbax', "
        "'focused_attention_vit_tpu'))\n"
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
    of jax, flax, optax, msgpack, orbax or the JAX package (docstrings may
    name them)."""
    import ast

    banned = ("jax", "jaxlib", "flax", "optax", "msgpack", "orbax",
              "focused_attention_vit_tpu")
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
    ("void (anonymous namespace)::flash_fwd_wgmma<64, true>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, __nv_bfloat16*, float*, int, int, float)",
     "flash kernels"),
    ("void (anonymous namespace)::flash_bwd_dkv_wgmma<64>(...)",
     "flash kernels"),
    ("void (anonymous namespace)::flash_bwd_dq_wgmma<64>(...)",
     "flash kernels"),
    ("void (anonymous namespace)::band_bwd_key_kernel<__nv_bfloat16, 64>",
     "band kernels"),
    ("void (anonymous namespace)::tile_band_fwd_mma<64, false>(...)",
     "tile band kernels"),
    ("void (anonymous namespace)::tile_band_bwd_mma<64>(...)",
     "tile band kernels"),
    ("void (anonymous namespace)::fused_fwd_tiled_wgmma<64, true>(...)",
     "fused attention kernels"),
    ("void (anonymous namespace)::fused_bwd_dkv_tiled_wgmma<64>(...)",
     "fused attention kernels"),
    ("void (anonymous namespace)::fused_fwd_row_wgmma<64, 13>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, __nv_bfloat16*, float*, long, int, float, "
     "(anonymous namespace)::Dropout, int)", "fused attention kernels"),
    ("void (anonymous namespace)::fused_bwd_row_wgmma<64, 13>(...)",
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


def test_band_ab_runs_in_turns_and_raises_without_cuda():
    from focused_attention_vit_tpu_torch.utils import band_ab

    assert band_ab.turns(["a", "b"]) == ["a", "b", "b", "a"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        band_ab.main(["."])


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


# --- the flash and fused kernels' sources ---------------------------------------

CSRC = REPO / "focused_attention_vit_tpu_torch" / "csrc"
FLASH_SOURCES = ["flash_attention_fwd.cu", "flash_attention_bwd.cu"]
WGMMA_SOURCES = FLASH_SOURCES + ["fused_mha_bwd.cu", "fused_mha_fwd.cu"]
# Headers of shared pieces; any other csrc header a source includes holds
# kernel code of its own (the flash blocks that the fused sources share).
SHARED_HEADERS = {"flash_common.cuh", "hopper_common.cuh", "philox.cuh"}
# The blocks past head dim 256, which all four sources include (tested on
# their own below, and with the sources' kernel code above).
WIDE_HEADER = "flash_wide.cuh"


def _kernel_code(name: str, skip=()) -> str:
    """A source and the kernel code it includes (its block headers but
    those in ``skip``)."""
    import re

    text = (CSRC / name).read_text()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        if header not in SHARED_HEADERS and header not in skip:
            text += (CSRC / header).read_text()
    return text


def _with_headers(name: str) -> str:
    """A source and the text of the ``csrc`` headers it includes."""
    import re

    text = (CSRC / name).read_text()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        text += (CSRC / header).read_text()
    return text


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_flash_sources_use_wgmma_and_asynchronous_copies(name):
    """Every product of the bf16 flash kernels and of the fused short-S
    kernels (whole-row, tiled on the flash blocks, and the wide blocks past
    head dim 256 of ``flash_wide.cuh``) is a warpgroup product and the tiles
    arrive by an asynchronous copy that completes on an mbarrier; their code
    calls none of the mma.sync fragment helpers."""
    import re

    own = _kernel_code(name)
    text = _with_headers(name)
    assert "wgmma.mma_async" in text
    assert "cp.async.bulk.tensor" in text
    assert "mbarrier::complete_tx" in text and "mbarrier.try_wait" in text
    assert re.search(r"Wgmma<\w+>::ss\(", own)
    # Register-A products: Wgmma<N>::rs, or hopper_common's rs_cols, which
    # issues them over a tile of more columns than one product takes.
    assert re.search(r"Wgmma<\w+>::rs\(|rs_cols<", own)
    assert "load_tile<" in own and "mbar_wait(" in own
    for old in ("mma_bf16", "ldsm_x4", "load_b_trans", "flash::load_tile<",
                "mma.sync"):
        assert old not in own, old


_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p",
            "long long": "c_longlong", "int": "c_int", "float": "c_float",
            "unsigned": "c_uint", "unsigned int": "c_uint"}


def _entry_types(src: str, entry: str) -> list:
    """The ctypes types of the argument list of ``extern "C"`` entry point
    ``entry``, parsed from a source."""
    import ctypes
    import re

    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [re.sub(r"\s*\w+$", "", p).replace(" *", "*") for p in params]
    return [getattr(ctypes, _C_TYPES[t]) for t in types]


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_flash_entry_points_match_the_wrapper_signatures(name):
    """The argument list of each ``extern "C"`` entry point that a wrapper
    declares, parsed from the source, is the one the ctypes wrapper
    declares (for a fused source: every entry of ``mha_kernel._SIGNATURES``
    it holds)."""
    from focused_attention_vit_tpu_torch.ops import flash_attention as flash
    from focused_attention_vit_tpu_torch.ops import mha_kernel as fused

    src = (CSRC / name).read_text()
    if name in FLASH_SOURCES:
        entries = {name[:-3]: flash._SIGNATURES[name[:-3]]}
    else:
        entries = {fn: sig for (lib, fn), sig in fused._SIGNATURES.items()
                   if lib == name[:-3]}
        assert name[:-3] in entries
    for entry, declared in entries.items():
        assert _entry_types(src, entry) == declared, entry


def _band_entries():
    from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band

    return sorted(band._SIGNATURES)


@pytest.mark.parametrize("lib,entry", _band_entries())
def test_band_entry_points_match_the_wrapper_signatures(lib, entry):
    """The argument list of each band entry point (K1's two, K2's), parsed
    from its source, is the one ``mhla_band_roll._SIGNATURES`` declares."""
    from focused_attention_vit_tpu_torch.ops import mhla_band_roll as band

    src = (CSRC / f"{lib}.cu").read_text()
    assert _entry_types(src, entry) == band._SIGNATURES[(lib, entry)]


BAND_STAGING_PATTERNS = [
    (r"cp\.async\.cg\.shared\.global", True),  # tiles by async copies
    (r"\], 16;", True),                         # of 16 bytes
    (r"cp\.async\.wait_group", True),
    (r"reinterpret_cast<uint4\*>", True),  # 16-byte stores of the results
    (r"launch_w<T, 8>", True),          # the slot cap 8 at W <= 8
    (r"launch_w<T, kMaxSlots>", True),  # 16 past it, then groups of 16
    (r"\batomic\w*\(", False),             # sums in a fixed order
    (r"\batom\.", False),
    (r"\bred\.", False),
]


@pytest.mark.parametrize("pattern,present", BAND_STAGING_PATTERNS)
def test_band_backward_stages_tiles_without_atomics(pattern, present):
    """K2 (``mhla_band_bwd.cu`` and the ``csrc`` headers it includes, where
    its staging helpers live) stages its tiles by 16-byte ``cp.async``
    copies, stores its results 16 bytes wide, fixes the slot count at
    compile time (8 or 16, by W) and uses no atomics, so two runs give the
    same bits."""
    import re

    text = _with_headers("mhla_band_bwd.cu")
    assert bool(re.search(pattern, text)) == present, pattern


@pytest.mark.parametrize("pattern,present", BAND_STAGING_PATTERNS)
def test_band_forward_stages_tiles(pattern, present):
    """K1 (``mhla_band_fwd.cu`` and the ``csrc`` headers it includes) stages
    q, k and v by 16-byte ``cp.async`` copies, stores out 16 bytes wide,
    fixes the slot count at compile time (8 or 16, by W) and uses no
    atomics."""
    import re

    text = _with_headers("mhla_band_fwd.cu")
    assert bool(re.search(pattern, text)) == present, pattern


TILE_BWD_PATTERNS = [
    (r"cp\.async\.cg\.shared\.global", True),  # rows by async copies
    (r"\], 16;", True),                         # of 16 bytes
    (r"cp\.async\.wait_group", True),
    (r"stmatrix\.sync", True),            # results staged in the dead rows
    (r"reinterpret_cast<uint4\*>", True),  # and stored 16 bytes wide
    (r"\batomic\w*\(", False),             # sums in a fixed order
    (r"\batom\.", False),
    (r"\bred\.", False),
]


@pytest.mark.parametrize("pattern,present", TILE_BWD_PATTERNS)
def test_tile_band_backward_stages_rows_without_atomics(pattern, present):
    """K7 (``mhla_tile_band_bwd.cu`` and the ``csrc`` headers it includes)
    brings its rows in by 16-byte ``cp.async`` copies, stores its results
    16 bytes wide through shared memory and uses no atomics, so two runs
    give the same bits."""
    import re

    text = _with_headers("mhla_tile_band_bwd.cu")
    assert bool(re.search(pattern, text)) == present, pattern


TILE_FWD_PATTERNS = [
    (r"cp\.async\.cg\.shared\.global", True),  # rows by async copies
    (r"\], 16;", True),                         # of 16 bytes
    (r"cp\.async\.wait_group", True),
    (r"stmatrix\.sync", True),            # results staged in the dead Q rows
    (r"reinterpret_cast<uint4\*>", True),  # and stored 16 bytes wide
    (r"\batomic\w*\(", False),             # every element by one thread
    (r"\batom\.", False),
    (r"\bred\.", False),
]


@pytest.mark.parametrize("pattern,present", TILE_FWD_PATTERNS)
def test_tile_band_forward_stages_rows_without_atomics(pattern, present):
    """K6 and K8 (``mhla_tile_band_fwd.cu`` and the ``csrc`` headers it
    includes) bring their rows in by 16-byte ``cp.async`` copies, store
    their results 16 bytes wide through shared memory and use no atomics,
    so two runs give the same bits."""
    import re

    text = _with_headers("mhla_tile_band_fwd.cu")
    assert bool(re.search(pattern, text)) == present, pattern


TILE_SM90_PATTERNS = [
    (r"wgmma\.mma_async", True),               # the band products on wgmma
    (r"cp\.async\.bulk\.tensor", True),       # a stage's tiles by TMA land
    (r"mbar_wait\(&full\[", True),               # on its barrier, awaited
    (r"mbar_wait\(&empty\[", True),              # and released per stage
    (r"\bring\.wait\(", True),
    (r"\bring\.release\(", True),
    (r"\bring\.acquire\(", True),
    (r"mbar_arrive_expect_tx\(bar, kTileBytes\)", True),
    (r"tb90::tile_product<", True),
    (r"__syncthreads\(\)", False),               # no block barrier an item
    (r"\batomic\w*\(", False),                   # sums in a fixed order
    (r"\batom\.", False),
    (r"\bred\.", False),
]


def _sm90_kernels(name: str) -> str:
    """The bodies of a tile-band source's wgmma kernels (``__global__``
    functions named ``..._sm90...``) and the text of the ``csrc`` headers it
    includes, the ring header first."""
    import re

    src = (CSRC / name).read_text()
    bodies = []
    for m in re.finditer(r"__global__[^{;]*?\b(tile_band_\w*sm90\w*)\(", src):
        start = src.index("{", m.end())
        depth, i = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
            if depth == 0:
                break
        bodies.append(src[start:i])
    assert bodies, name
    headers = "".join((CSRC / h).read_text() for h in re.findall(
        r'#include "(\w+\.cuh)"', src) if h == "tile_band_sm90.cuh")
    return headers + "".join(bodies)


@pytest.mark.parametrize("name", ["mhla_tile_band_fwd.cu",
                                  "mhla_tile_band_bwd.cu"])
@pytest.mark.parametrize("pattern,present", TILE_SM90_PATTERNS)
def test_tile_band_wgmma_kernels_wait_per_stage(name, pattern, present):
    """Past the ring kernels' range K6/K8 and K7 run wgmma kernels
    (``tile_band_sm90.cuh``): their tiles arrive by TMA and complete on the
    stage's own mbarrier, the consumers wait on the stage they read and
    release it, the producer waits for a released stage, the products are
    warpgroup products; no block-wide barrier per item and no atomics, so two runs
    give the same bits. (The ring header's setup barrier is outside the
    kernels' bodies.)"""
    import re

    text = _sm90_kernels(name)
    if pattern == r"__syncthreads\(\)":
        # make_ring's one barrier after the set-up is the only one.
        text = text.replace("hp::fence_barrier_init();\n  }\n  __syncthreads();",
                            "")
    assert bool(re.search(pattern, text)) == present, pattern


def test_tile_band_sources_share_one_ring_header():
    """Both tile-band sources include ``tile_ring.cuh``, which defines the
    ring helpers (ring rows, swizzle, lane addresses, row copies, staged
    stores), and neither defines its own copy of them."""
    import re

    header = (CSRC / "tile_ring.cuh").read_text()
    helpers = ("ring_row", "swz", "ring_at", "LaneAddr", "pattern_a",
               "pattern_b", "stsm_x4", "issue_rows", "store_rows")
    for name in helpers:
        assert re.search(rf"(void|int|char\*|struct|LaneAddr<D>) {name}\b",
                         header), name
    for src in ("mhla_tile_band_fwd.cu", "mhla_tile_band_bwd.cu"):
        text = (CSRC / src).read_text()
        assert '#include "tile_ring.cuh"' in text
        for name in helpers:
            assert not re.search(
                rf"(void|int|char\*|struct|LaneAddr<D>) {name}\b", text), (
                    src, name)


def _tile_entries():
    from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile

    return sorted(tile._SIGNATURES)


@pytest.mark.parametrize("lib,entry", _tile_entries())
def test_tile_band_entry_points_match_the_wrapper_signatures(lib, entry):
    """The argument list of each tile-band entry point (K6's two and their
    shared-memory report, K7's and its), parsed from its source, is the one
    ``mhla_kernel_v4._SIGNATURES`` declares."""
    from focused_attention_vit_tpu_torch.ops import mhla_kernel_v4 as tile

    src = (CSRC / f"{lib}.cu").read_text()
    assert _entry_types(src, entry) == tile._SIGNATURES[(lib, entry)]


def test_band_sources_share_one_staging_header():
    """Both band sources include ``band_stage.cuh``, which defines the
    staging helpers, and neither defines its own copy of them."""
    import re

    header = (CSRC / "band_stage.cuh").read_text()
    helpers = ("cp_async16", "cp_async_commit", "cp_async_wait", "lead",
               "Leads", "stage", "fill_halo", "unstage", "take_run",
               "load_run", "store_run")
    for name in helpers:
        assert re.search(rf"(void|int|struct) {name}\b", header), name
    for src in ("mhla_band_fwd.cu", "mhla_band_bwd.cu"):
        text = (CSRC / src).read_text()
        assert '#include "band_stage.cuh"' in text
        for name in helpers:
            assert not re.search(rf"(void|int|struct) {name}\b", text), (
                src, name)


def test_flash_common_keeps_the_fused_kernels_helpers():
    """``flash_common.cuh`` still defines every ``flash::`` helper that the
    sources including it use: the tile band's kernels, and the flash and
    fused short-S sources' delta kernel and constants."""
    import re

    header = (CSRC / "flash_common.cuh").read_text()
    users = [src for src in sorted(CSRC.glob("*.cu"))
             if '#include "flash_common.cuh"' in src.read_text()]
    assert {"mhla_tile_band_fwd.cu", "mhla_tile_band_bwd.cu",
            "fused_mha_fwd.cu", "fused_mha_bwd.cu"} <= {
                src.name for src in users}
    used = set()
    for src in users:
        used |= set(re.findall(r"flash::(\w+)", src.read_text()))
    assert {"mma_bf16", "ldsm_x4", "ldsm_x4_trans", "pack_bf16",
            "launch_delta"} <= used
    for name in sorted(used):
        defined = (
            re.search(rf"\b(?:void|float|uint32_t|cudaError_t|int)\s+{name}"
                      rf"\s*\(", header)
            or re.search(rf"^\s+{name}\(", header, re.M)
            or re.search(rf"constexpr\s+\w+\s+{name}\s*=", header)
            or re.search(rf"struct\s+{name}\b", header))
        assert defined, name


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_wide_blocks_take_the_head_dims_past_256(name):
    """Each flash and fused source sends a head dim past 256 to the blocks
    of ``flash_wide.cuh`` before its dispatch by tile width, whose widths
    end at 256, with the slice plan as launch arguments; those blocks run
    wgmma (the logits from shared memory, the slice products with a
    register A operand) on 64 x 64 tiles that each warpgroup's thread 0
    brings by TMA into its ring, wait on the stage's full barrier, refill a
    stage only past the warpgroup's barrier after the products that read
    it, swap the warpgroups' tiles under a named barrier, take the masks'
    calls of the narrower blocks, and use no atomics and no block-wide
    barrier in their bodies."""
    import re

    src = (CSRC / name).read_text()
    wide = (CSRC / WIDE_HEADER).read_text()
    assert f'#include "{WIDE_HEADER}"' in src
    assert src.index("flash_wide::takes(d)") < src.index(
        "switch (flash::tile_width(d))")
    assert re.search(r"bool takes\(int d\) \{ return d > 256 && d % 8 == 0; \}",
                     wide)
    common = (CSRC / "flash_common.cuh").read_text()
    assert "if (d < 8 || d > 256 || d % 8 != 0) return 0;" in common
    kinds = (["kFwd"] if "_fwd" in name else ["kDkv", "kDq"])
    for kind in kinds:
        assert f"flash_wide::block<flash_wide::{kind}, NT" in src, kind
    plan = ("int slices, int tiles" if "_fwd" in name else
            "int kv_slices, int kv_tiles, int q_slices,")
    assert plan in src
    for needle in ('#include "tile_band_sm90.cuh"', "tb90::mma_ss<0, 0>(",
                   "hp::Wgmma<64>::rs(", "tb90::desc_mn(", "hp::pack_a(",
                   "tb90::load_full(", "hp::tma_load_3d(",
                   "hp::mbar_wait(&ring.full[stage], phase)",
                   "hp::named_sync(kRingBar + w, 128)", "hp::wgmma_wait<0>()",
                   "feed.upto(i + g.ns)",
                   "hp::named_sync(kXchgBar, kConsumers)", "mask.apply(",
                   "mask.dkv(", "mask.dq("):
        assert needle in wide, needle
    for old in ("atomic", "__syncthreads()", "mma.sync", "ldsm", "cp.async.cg",
                "ldmatrix"):
        assert old not in wide, old


@pytest.mark.parametrize("name", WGMMA_SOURCES)
def test_tile_widths_192_and_256_take_the_block256_header(name):
    """Each flash and fused source sends the tile widths 192 and 256 to
    ``flash_block256.cuh`` (its forward, or flash_common.cuh's delta and
    then its dkv and dq, one launch each: no dk-then-dv pair, each counted
    where it is launched and read through the library's
    ``*_block256_launches``), whose blocks are 256 threads of two
    warpgroups, no producer and no setmaxnreg, wgmma on TMA rings, the
    masks' split steps, no atomics; the narrower blocks stop at 128."""
    import re

    src = (CSRC / name).read_text()
    block = (CSRC / "flash_block256.cuh").read_text()
    assert '#include "flash_block256.cuh"' in src
    if "_fwd" in name:
        assert "flash256::launch_fwd<D>(" in src
    else:
        assert "flash::launch_delta<bf16, flash::for_" in src
        assert "flash256::launch_bwd<D>(" in src
        stem = name.removesuffix(".cu")
        assert (f'extern "C" void {stem}_block256_launches(long long* '
                f'counts)') in src
        assert "flash256::dkv_launches.exchange(0)" in src
        assert "flash256::dq_launches.exchange(0)" in src
    assert re.search(r"if constexpr \(D == 192 \|\| D == 256\)"
                     r"|launch_block256<192>\(a\)", src)
    for old in ("kDkOnly", "kDvOnly", "kPart"):
        assert old not in src, old
    block = re.sub(r"//[^\n]*", "", block)  # the code, not its comments
    assert "constexpr int kThreads = 256;" in block
    for needle in ("hp::Wgmma<BN>::ss(", "hp::Wgmma<kTile>::ss(",
                   "hp::Wgmma<NC>::rs(", "hp::rs_cols<D, BN>(",
                   "hp::load_tile<D, kTile>(", "hp::mbar_wait(",
                   "hp::named_sync(kXFull, kThreads)",
                   "hp::named_sync(kXchg, kThreads)", "mask.apply(",
                   "mask.dkv_p(", "mask.dkv_ds(", "mask.dq_p(",
                   "mask.dq_ds("):
        assert needle in block, needle
    assert block.count("++dkv_launches;") == 1
    assert block.count("++dq_launches;") == 1
    for old in ("atomicAdd", "atom.", "red.", "reg_alloc", "setmaxnreg",
                "mma.sync", "ldmatrix", "delta("):
        assert old not in block, old
    for header in ("flash_fwd_block.cuh", "flash_bwd_blocks.cuh"):
        assert 'static_assert(D <= 128, "tile width");' in (
            CSRC / header).read_text()


def test_smoke_tile_widths_are_the_sources():
    """chip_smoke.py's TILE_WIDTHS are the widths ``csrc/flash_common.cuh``
    ``tile_width`` picks from, and its BLOCK256_WIDTHS the ones each flash
    and fused source sends to ``flash_block256.cuh``: the build phase holds
    the kernels of those widths to no spill, and kernel-headdims counts
    the backward's launches there."""
    import ast
    import re

    common = (CSRC / "flash_common.cuh").read_text()
    widths = re.search(r"for \(int w : \{([\d, ]+)\}\)", common).group(1)
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    keep = [node for node in tree.body if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in ("TILE_WIDTHS", "BLOCK256_WIDTHS")]
    smoke = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "chip_smoke.py",
                 "exec"), smoke)
    assert smoke["TILE_WIDTHS"] == tuple(int(w) for w in widths.split(","))
    for name in WGMMA_SOURCES:
        src = (CSRC / name).read_text()
        routed = set(re.findall(r"launch_block256<(\d+)>\(a\)", src))
        for pair in re.findall(
                r"if constexpr \(D == (\d+) \|\| D == (\d+)\) \{", src):
            routed.update(pair)
        assert {int(w) for w in routed} == set(smoke["BLOCK256_WIDTHS"]), (
            name, routed)


# --- the wide blocks' slice plan ------------------------------------------------

WIDE_PLAN_GRIDS = ((1, 65), (16, 197), (8, 3137), (128, 1370))  # rows, S


def _wide_tiles(kind, plan, d):
    """The (tensor, first column) of every 64-column output tile the plan's
    warpgroups accumulate inside d, as csrc/flash_wide.cuh out_tile places
    them: the forward's and dq's two warpgroups split a slice, dkv's each
    hold the slice of their own tensor (0: dv, 1: dk)."""
    out = []
    for sl in range(plan.slices):
        for w in range(2):
            for t in range(plan.tiles):
                tile = (sl * plan.tiles + t if kind == "dkv"
                        else (sl * 2 + w) * plan.tiles + t)
                if 64 * tile < d:
                    out.append((w if kind == "dkv" else 0, 64 * tile))
    return out


@pytest.mark.parametrize("kind", ["fwd", "dkv", "dq"])
def test_wide_plan_covers_every_column_once(kind):
    """At every head dim past 256 up to 4096 and grids small and large, the
    plan's tiles cover each column of each output once and leave no slice
    empty; a warpgroup holds a multiple of 16 columns, at most 256; the
    recomputation factor is (slices + 1) / 2 for the forward and (4 slices
    + 4) / 10, (4 slices + 2) / 10 of the backward for dkv and dq."""
    from focused_attention_vit_tpu_torch.ops import flash_attention as flash

    for d in range(264, 4097, 8):
        for rows, s in WIDE_PLAN_GRIDS:
            plan = flash.wide_plan(rows, s, d, kind)
            assert plan.cols % 16 == 0 and 32 <= plan.cols <= 256
            tiles = _wide_tiles(kind, plan, d)
            for tensor in {x for x, _ in tiles}:
                cols = sorted(c for x, c in tiles if x == tensor)
                assert cols == list(range(0, d, 64)), (d, rows, s, plan)
            per = plan.tiles * (1 if kind == "dkv" else 2)
            assert (plan.slices - 1) * per * 64 < d <= plan.slices * per * 64
            want = {"fwd": (plan.slices + 1) / 2,
                    "dkv": (4 * plan.slices + 4) / 10,
                    "dq": (4 * plan.slices + 2) / 10}[kind]
            assert plan.factor == pytest.approx(want)


def test_wide_plan_factors_and_small_grids():
    """The recomputation factors at the one-head paths' shapes (K5 at
    B*h = 8, S = 3137; the factors PERF.md gives), the small-grid rule at
    K3/K4's B*h = 16, S = 197 (2 tiles a warpgroup while every block still
    fits one wave of the card's SMs; off with CARD_SMS = 0), and the
    rejected head dims and kinds."""
    from focused_attention_vit_tpu_torch.ops import flash_attention as flash

    for d, fwd, bwd in ((264, 1.0, 1.8), (384, 1.0, 1.8), (768, 1.5, 2.6),
                        (1280, 2.0, 3.8)):
        assert flash.wide_factor(8, 3137, d, "fwd") == pytest.approx(fwd)
        assert flash.wide_factor(8, 3137, d, "bwd") == pytest.approx(bwd)
    assert flash.wide_factor(8, 3137, 256, "bwd") == 1.0
    assert flash.wide_plan(8, 3137, 768, "fwd")[:2] == (2, 3)
    assert flash.wide_plan(8, 3137, 768, "dkv")[:2] == (3, 4)
    assert flash.wide_plan(8, 3137, 768, "dq")[:2] == (2, 3)
    assert flash.wide_plan(16, 197, 384, "fwd")[:2] == (2, 2)
    assert flash.wide_plan(16, 197, 384, "dkv")[:2] == (2, 3)
    assert flash.wide_plan(16, 197, 384, "dq")[:2] == (2, 2)
    for kind in ("fwd", "dkv", "dq"):
        plan = flash.wide_plan(16, 197, 384, kind)
        assert 16 * 4 * plan.slices <= flash.CARD_SMS
    old = flash.CARD_SMS
    try:
        flash.CARD_SMS = 0
        assert flash.wide_plan(16, 197, 384, "fwd")[:2] == (1, 3)
    finally:
        flash.CARD_SMS = old
    for d in (256, 260):
        with pytest.raises(ValueError):
            flash.wide_plan(8, 197, d, "fwd")
    with pytest.raises(ValueError):
        flash.wide_plan(8, 197, 384, "bwd")


def test_wide_args_follow_the_plan():
    """The kernels' plan arguments: the plan's slices and tiles for bf16
    past 256 (the forward's; dkv's then dq's), zeros for f32 and up to
    256."""
    from focused_attention_vit_tpu_torch.ops import flash_attention as flash

    q = torch.zeros(2, 4, 3137, 768, dtype=torch.bfloat16)
    assert flash.wide_args(q, "fwd") == [2, 3]
    assert flash.wide_args(q, "bwd") == [3, 4, 2, 3]
    assert flash.wide_args(q.float(), "bwd") == [0, 0, 0, 0]
    assert flash.wide_args(q[..., :256].contiguous(), "fwd") == [0, 0]
