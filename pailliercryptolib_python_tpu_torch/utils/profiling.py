"""Tracing and timing hooks.

Counterpart of ``pailliercryptolib_python_tpu/utils/profiling.py``:
``trace(dir)`` captures a ``torch.profiler`` trace (CPU activity, and
CUDA activity when the port's default device is a CUDA card) and writes
it as a Chrome trace under ``dir``; ``annotate(name)`` scopes work so the
HE-level phases (encrypt, obfuscate, CRT decrypt, reduce) show as named
spans in that trace; ``timed(label, sink)`` is a host wall-clock span.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace into ``log_dir/trace_<n>.json`` (Chrome /
    Perfetto format); yields the ``torch.profiler.profile`` object.

    Usage:
        with profiling.trace("trace-dir"):
            ct = pk.encrypt(x)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ..device import get_device

    acts = [ProfilerActivity.CPU]
    if get_device().type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if get_device().type == "cuda":
                torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))


def annotate(name: str):
    """Named span context (shows in profiler timelines)."""
    from torch.profiler import record_function
    return record_function(name)


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Host wall-clock span: appends (label, seconds) to `sink` (a list)
    or prints to stderr."""
    import sys

    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, dt))
        else:
            print(f"[timed] {label}: {dt * 1e3:.1f} ms", file=sys.stderr,
                  flush=True)
