"""Tracing and timing hooks (port of
``focused_attention_vit_tpu/utils/profiling.py``).

- :func:`trace` writes one ``torch.profiler`` trace of the code it wraps,
  CPU and CUDA activity, as a Chrome trace file that Perfetto
  (ui.perfetto.dev) and ``chrome://tracing`` open;
- :func:`annotate` names a region on that timeline;
- :func:`wallclock` times a region on the host clock, after waiting for the
  device that computed its result.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Profile the wrapped code into ``profile_dir/trace.json`` (no-op for
    None); CUDA activity is recorded where CUDA is available."""
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))


def annotate(name: str):
    """Named region for the profiler timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def wallclock(sink: dict, key: str, result=None) -> Iterator[None]:
    """Host-clock bracket: stores elapsed seconds in ``sink[key]``. Pass the
    computation's output tensor as ``result`` to wait for its device before
    the clock stops."""
    t0 = time.perf_counter()
    yield
    if isinstance(result, torch.Tensor) and result.is_cuda:
        torch.cuda.synchronize(result.device)
    sink[key] = time.perf_counter() - t0
