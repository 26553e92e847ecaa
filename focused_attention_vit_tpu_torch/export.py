"""Serialized serving artifacts through ``torch.export`` (port of
``focused_attention_vit_tpu/export.py``).

:func:`save_serving_artifact` exports the live
:class:`~.infer.Predictor`'s serving module (:class:`~.infer.ServingModule`:
uint8 NHWC in, f32 probabilities out, the on-device resize and
normalisation and the chunk loop included) into a directory:

``serving_fn.pt2``
    the ``torch.export.save``\\d program, with the model's weights in it
    (bf16 or f32, on the device it was traced on). JAX writes its
    parameters to a ``params.msgpack`` beside the program; here they travel
    inside the ``.pt2``;
``meta.json``
    the batch, the input shape, the class count and the image size, the
    torch version and the device, and the environment switches read while
    tracing (``FAVIT_MHLA_IMPL``, ``FAVIT_USE_PALLAS_MHLA``,
    ``FAVIT_FUSED_MHA``), which chose the attention path baked into the
    program.

The hand-written kernels are ``favit::`` operators (``ops/library.py``),
so the program calls them by name: :func:`load_serving_artifact` imports
that module and no model code. The artifact's numbers equal the live
Predictor's by construction: the program is the very module the Predictor
serves with.

An artifact is tied to the device type it was traced on, since the trace
takes each device's path (the tile band runs on a CUDA tensor only, for
one): a CUDA artifact raises where CUDA is not available, and a CPU one
serves on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Tuple

import numpy as np
import torch

from focused_attention_vit_tpu_torch.infer import padded_predict_proba

_FN_FILE = "serving_fn.pt2"
_META_FILE = "meta.json"
# Read at trace time by ops/window.py and models/layers.py.
TRACE_ENV = ("FAVIT_MHLA_IMPL", "FAVIT_USE_PALLAS_MHLA", "FAVIT_FUSED_MHA")


def save_serving_artifact(predictor, out_dir: str, *,
                          input_hw: Tuple[int, int] | None = None) -> str:
    """Export ``predictor``'s serving module to ``out_dir``.

    ``input_hw`` fixes the client image shape baked into the program
    (default: the model's own ``img_size`` square; the program resizes on
    the device, but an exported program has one input shape, so export one
    artifact per shape clients will send). The files are written into
    ``<out_dir>.tmp-new`` and the directories swapped at the end, so a
    crash never leaves a mixed artifact; the windows that remain fail
    loudly (a missing directory), never wrongly. A Predictor on a mesh is
    refused, as in JAX."""
    if getattr(predictor, "mesh", None) is not None:
        raise ValueError(
            "export of a mesh-sharded Predictor is not supported: the "
            "serialized program would pin this host's device topology. "
            "Export from a Predictor(mesh=None) and apply sharding on the "
            "serving host."
        )
    h, w = input_hw if input_hw is not None else (
        predictor.img_size, predictor.img_size)
    example = torch.zeros(predictor.batch_size, h, w, 3, dtype=torch.uint8,
                          device=predictor.device)
    # torch.export takes no inference-mode tensors: trace under no_grad.
    with torch.no_grad():
        program = torch.export.export(predictor.serving, (example,))
    meta = {
        "batch_size": predictor.batch_size,
        "input_hw": [h, w],
        "num_classes": predictor.num_classes,
        "img_size": predictor.img_size,
        "torch_version": torch.__version__,
        "device": predictor.device.type,
        "trace_env": {k: os.environ.get(k) for k in TRACE_ENV},
    }

    tmp_dir = out_dir.rstrip("/") + ".tmp-new"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    torch.export.save(program, os.path.join(tmp_dir, _FN_FILE))
    with open(os.path.join(tmp_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    if os.path.exists(out_dir):
        old_dir = out_dir.rstrip("/") + ".tmp-old"
        if os.path.exists(old_dir):
            shutil.rmtree(old_dir)
        os.rename(out_dir, old_dir)
        os.rename(tmp_dir, out_dir)
        shutil.rmtree(old_dir)
    else:
        os.rename(tmp_dir, out_dir)
    return out_dir


class ExportedPredictor:
    """Serving face of a loaded artifact: the Predictor API (``warmup``,
    ``predict_proba``, ``predict``; requests of any size through the shared
    padding loop) with no model class behind it."""

    def __init__(self, program, meta: Dict[str, Any]):
        self.program = program
        self._fn = program.module()
        self.meta = meta
        self.device = torch.device(meta["device"])
        self.batch_size = int(meta["batch_size"])
        self.num_classes = int(meta["num_classes"])
        self.input_hw = tuple(meta["input_hw"])

    @torch.no_grad()
    def _fwd(self, images_u8: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        return self._fn(x)

    def warmup(self) -> None:
        """Run one batch: builds the CUDA kernels on their first call."""
        h, w = self.input_hw
        self._fwd(np.zeros((self.batch_size, h, w, 3), dtype=np.uint8)).cpu()

    def predict_proba(self, images_u8: np.ndarray) -> np.ndarray:
        """``[N, h, w, C]`` uint8 -> ``[N, num_classes]`` float32."""
        return padded_predict_proba(self._fwd, self.batch_size,
                                    self.num_classes, images_u8)

    def predict(self, images_u8: np.ndarray):
        probs = self.predict_proba(images_u8)
        ids = probs.argmax(-1)
        return ids, probs[np.arange(len(ids)), ids]


def load_serving_artifact(artifact_dir: str) -> ExportedPredictor:
    """Load an artifact directory into a serving callable. Imports the
    ``favit::`` operator registrations and no model code; raises
    :class:`FileNotFoundError` naming the missing files, and
    :class:`RuntimeError` when the artifact's device type is not available
    here."""
    missing = [n for n in (_FN_FILE, _META_FILE)
               if not os.path.exists(os.path.join(artifact_dir, n))]
    if missing:
        raise FileNotFoundError(
            f"{artifact_dir} is not a complete serving artifact "
            f"(missing {missing}); re-export with save_serving_artifact")
    with open(os.path.join(artifact_dir, _META_FILE)) as f:
        meta = json.load(f)
    device = meta.get("device")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{artifact_dir} was traced on a CUDA device and CUDA is not "
            f"available here; an artifact serves on the device type it was "
            f"traced on (export a CPU artifact to serve on the CPU)")
    if device not in ("cpu", "cuda"):
        raise RuntimeError(f"{artifact_dir}: unknown artifact device "
                           f"{device!r}")
    from focused_attention_vit_tpu_torch.ops import library  # noqa: F401

    program = torch.export.load(os.path.join(artifact_dir, _FN_FILE))
    return ExportedPredictor(program, meta)
