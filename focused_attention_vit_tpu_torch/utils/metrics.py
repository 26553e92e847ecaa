"""Complexity, timing and memory measurement (port of
``focused_attention_vit_tpu/utils/metrics.py``).

The analytical ViT complexity model is the reference's, number for number,
so the CSV columns stay comparable. Timing uses the reference's warm-up and
iteration protocol and ends in ``torch.cuda.synchronize()`` on a CUDA model.
The device memory probe is the reference's own:
``torch.cuda.reset_peak_memory_stats()`` before the pass and
``max_memory_allocated()`` after it. On the CPU the device fields are 0.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


def count_parameters(params) -> int:
    """Total parameter count of a module, a state dict or an iterable of
    tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return sum(int(p.numel()) for p in params)


def calculate_model_size(params) -> Dict[str, float]:
    """Size at fp32, 4 bytes a parameter."""
    n = count_parameters(params)
    size_bytes = n * 4
    return {
        "parameters": n,
        "size_bytes": size_bytes,
        "size_kb": size_bytes / 1024,
        "size_mb": size_bytes / 1024 / 1024,
    }


def calculate_vit_complexity(
    img_size: int,
    patch_size: int,
    embed_dim: int,
    depth: int,
    num_heads: int,
    mlp_ratio: float = 4.0,
    in_channels: int = 3,
) -> Dict[str, Any]:
    """Closed-form ViT parameter, FLOP and activation-memory model, with
    the reference's conventions: a multiply-accumulate counted once, the
    head sized for 1000 classes, and activation memory
    ``seq * dim * 4 * (depth + 2)`` bytes."""
    num_patches = (img_size // patch_size) ** 2
    seq_len = num_patches + 1

    patch_embed_params = patch_size * patch_size * in_channels * embed_dim + embed_dim
    patch_embed_flops = num_patches * patch_size * patch_size * in_channels * embed_dim
    pos_embed_params = seq_len * embed_dim

    head_dim = embed_dim // num_heads
    mlp_hidden = int(embed_dim * mlp_ratio)

    ln_params = 2 * embed_dim
    mha_params = 3 * embed_dim * embed_dim + embed_dim * embed_dim + 2 * embed_dim
    mha_flops = (
        3 * seq_len * embed_dim * embed_dim
        + 2 * num_heads * seq_len * seq_len * head_dim
        + num_heads * seq_len * seq_len * head_dim
        + seq_len * embed_dim * embed_dim
    )
    mlp_params = embed_dim * mlp_hidden + mlp_hidden + mlp_hidden * embed_dim + embed_dim
    mlp_flops = seq_len * (embed_dim * mlp_hidden + mlp_hidden * embed_dim)

    block_params = depth * (2 * ln_params + mha_params + mlp_params)
    block_flops = depth * (mha_flops + mlp_flops)

    final_ln_params = 2 * embed_dim
    head_params = embed_dim * 1000 + 1000

    total_params = (
        patch_embed_params + pos_embed_params + block_params
        + final_ln_params + head_params
    )
    total_flops = patch_embed_flops + block_flops
    activation_memory = seq_len * embed_dim * 4 * (depth + 2)
    inference_memory = total_params * 4 + activation_memory

    return {
        "parameters": total_params,
        "flops": total_flops,
        "time_complexity": total_flops,
        "space_complexity_bytes": inference_memory,
        "space_complexity_mb": inference_memory / (1024 * 1024),
    }


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _sync(*xs) -> None:
    """Wait for every CUDA device that holds one of the tensors in ``xs``
    (PyTorch returns before the card finishes)."""
    for device in {t.device for t in _tensors(xs) if t.is_cuda}:
        torch.cuda.synchronize(device)


def measure_inference_time(
    apply_fn: Callable,
    *args,
    num_iterations: int = 100,
    warm_up: int = 250,
) -> Dict[str, float]:
    """Warm-up, then timed iterations of ``apply_fn(*args)`` under
    ``inference_mode`` (the reference protocol: 250 warm-up, 100 timed)."""
    with torch.inference_mode():
        out = None
        for _ in range(warm_up):
            out = apply_fn(*args)
        _sync(out, args)
        start = time.time()
        for _ in range(num_iterations):
            out = apply_fn(*args)
        _sync(out, args)
    total = time.time() - start
    return {
        "total_time": total,
        "avg_time": total / num_iterations,
        "fps": num_iterations / total,
    }


def measure_training_time(
    train_step: Callable,
    state,
    *args,
    num_iterations: int = 10,
) -> Tuple[Dict[str, float], Any]:
    """Timed forward, backward and update iterations of
    ``train_step(state, *args) -> (state, metrics)``, after one warm-up
    step."""
    state, m = train_step(state, *args)
    _sync(m, args)
    start = time.time()
    for _ in range(num_iterations):
        state, m = train_step(state, *args)
    _sync(m, args)
    total = time.time() - start
    return (
        {
            "total_time": total,
            "avg_time": total / num_iterations,
            "iterations_per_second": num_iterations / total,
        },
        state,
    )


def _rss_bytes() -> int:
    """Resident set size of this process: from psutil where it imports,
    else from ``/proc/self/statm``, else the peak from ``resource``."""
    if psutil is not None:
        return int(psutil.Process(os.getpid()).memory_info().rss)
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def measure_memory_usage(
    apply_fn: Callable,
    *args,
    backward: bool = False,
) -> Dict[str, float]:
    """RSS delta and the device allocator's peak around one forward (and
    backward) pass of ``apply_fn(*args)``. The device is that of the first
    CUDA tensor in ``args``; with none, the device fields are 0.
    ``backward=True`` differentiates ``apply_fn(*args).sum()`` with respect
    to the tensors in ``args`` that require grad, without touching their
    ``.grad``."""
    device = next((t.device for t in _tensors(args) if t.is_cuda), None)
    cpu_before = _rss_bytes()
    used_before = 0.0
    if device is not None:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        used_before = float(torch.cuda.memory_allocated(device))

    if backward:
        with torch.enable_grad():
            out = apply_fn(*args).sum()
            leaves = [t for t in _tensors(args) if t.requires_grad]
            grads = torch.autograd.grad(out, leaves) if leaves else ()
        _sync(out, grads)
        del grads
    else:
        with torch.no_grad():
            out = apply_fn(*args)
        _sync(out)
    del out

    cpu_after = _rss_bytes()
    used_after = peak = 0.0
    if device is not None:
        used_after = float(torch.cuda.memory_allocated(device))
        peak = float(torch.cuda.max_memory_allocated(device))
    used = used_after - used_before
    return {
        "cpu_memory_before_bytes": cpu_before,
        "cpu_memory_after_bytes": cpu_after,
        "cpu_memory_used_bytes": cpu_after - cpu_before,
        "cpu_memory_used_mb": (cpu_after - cpu_before) / (1024 * 1024),
        "device_memory_before_bytes": used_before,
        "device_memory_after_bytes": used_after,
        # Reference key names.
        "gpu_memory_used_bytes": used,
        "gpu_memory_used_mb": used / (1024 * 1024),
        "gpu_memory_peak_bytes": peak,
        "gpu_memory_peak_mb": peak / (1024 * 1024),
    }


def benchmark_model(
    model: torch.nn.Module,
    input_shape: Tuple[int, ...],
    *,
    num_classes: int = 1000,
    batch_size: int = 1,
    num_inference_iterations: int = 100,
    num_training_iterations: int = 10,
    warm_up: int = 250,
    seed: int = 0,
) -> Dict[str, Any]:
    """Model size, inference and training time and memory in one dict, on
    the model's device. ``input_shape`` is (H, W, C): NHWC. JAX's version
    also takes the params; here they are the model's."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.normal(size=(batch_size, *input_shape)).astype(np.float32)
    ).to(device)
    y = torch.from_numpy(rng.integers(0, num_classes, size=(batch_size,))
                         ).to(device)
    params = list(model.parameters())

    model.eval()
    inference_time = measure_inference_time(
        model, x, num_iterations=num_inference_iterations, warm_up=warm_up)
    memory_inference = measure_memory_usage(model, x)

    model.train()
    opt = torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)

    def train_step(state, x, y):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x).float(), y)
        loss.backward()
        opt.step()
        return state, loss.detach()

    training_time, _ = measure_training_time(
        train_step, None, x, y, num_iterations=num_training_iterations)
    memory_training = measure_memory_usage(
        lambda x, _params: model(x), x, params, backward=True)
    model.zero_grad(set_to_none=True)

    return {
        "theoretical": {"model_size": calculate_model_size(model)},
        "actual": {
            "inference_time": inference_time,
            "training_time": training_time,
            "memory_usage_inference": memory_inference,
            "memory_usage_training": memory_training,
        },
    }
