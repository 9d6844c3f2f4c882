"""Tracing: named spans and a profiler trace of a command.

Counterpart of ``metatrain_tpu/utils/profiling.py`` on ``torch.profiler``:

- :func:`stage`: a named span (``torch.profiler.record_function``) that
  shows in a captured trace;
- :func:`profile_trace`: a ``torch.profiler`` trace of the block, host
  and (where there is a card) device, written as a Chrome trace into a
  directory; used by ``train --profile`` and ``eval --profile``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional

import torch


def stage(name: str):
    """A named span around a compute stage."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Trace the block into ``trace_dir/trace.json`` when ``trace_dir`` is
    set; nothing otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
