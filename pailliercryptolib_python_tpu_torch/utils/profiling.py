"""Tracing and timing hooks.

Counterpart of ``pailliercryptolib_python_tpu/utils/profiling.py``:
``trace(dir)`` captures a ``torch.profiler`` trace (CPU activity, and
CUDA activity when the port's default device is a CUDA card) and writes
it as a Chrome trace under ``dir``; ``annotate(name)`` scopes work so the
HE-level stages show as named spans in that trace; ``timed(label, sink)``
is a host wall-clock span, and an ``annotate`` span too.

The program's own spans are named ``pct.<layer>.<stage>``: ``pct.api.*``
and ``pct.fixedpoint.*`` (``api.py``, ``fixedpoint.py``) and
``pct.paillier.*`` (``models/paillier.py``).  They nest as the calls do,
so the innermost span in force is the stage the calling thread is in.
They are ``record_function`` ranges on the calling thread, in the same
trace as the device's kernels and copies, on one clock.  With no
profiler active, ``annotate`` is one flag read and returns a shared
no-op context.

``COUNTERS`` counts the work of the ct*pt modexp (``mul_pt``), of the
exponent alignment's squaring chain (K16) and the launch geometry of the
decrypt chain (K2), only while a profiler is active (``count_exp``,
``count_align``, ``count_sched``).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()

# ct*pt modexp work, counted only while a profiler is active:
# exp_columns: columns launched, padding included; exp_windows_run:
# columns x windows the chosen route runs; exp_windows_needed: the sum over
# the columns of ceil(bitlen(e) / window), 0 for e <= 1.
# K2 (``rns_exp_sched``) launches, counted the same way: sched_launches
# (a launch over both CRT halves counts once); sched_ctas: CTAs launched,
# halves x ceil(columns / 32); sched_sm_slots: the SM slots of the waves
# those CTAs take at one CTA an SM, ceil(ctas / SMs) x SMs.
# The alignment's squaring chain (K16, ``PublicContext.scale_pow2``):
# align_launches; align_columns: the shifted columns; align_squarings_needed:
# the sum of their shifts d; align_squarings_run: over the warps, the
# warp's largest d times its columns.
COUNTERS = {"exp_columns": 0, "exp_windows_run": 0, "exp_windows_needed": 0,
            "sched_launches": 0, "sched_ctas": 0, "sched_sm_slots": 0,
            "align_launches": 0, "align_columns": 0,
            "align_squarings_needed": 0, "align_squarings_run": 0}


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
    """Named span context (shows in profiler timelines); a shared no-op
    context unless a profiler is active on this thread."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name)


def count_exp(bits: list, window: int, windows_run: int) -> None:
    """Count one ct*pt modexp launch: `bits` the bit length of each
    column's exponent (padding included), `window` the route's window,
    `windows_run` the windows each column runs.  Counts only while a
    profiler is active."""
    if not _profiler_enabled():
        return
    COUNTERS["exp_columns"] += len(bits)
    COUNTERS["exp_windows_run"] += len(bits) * windows_run
    COUNTERS["exp_windows_needed"] += sum(-(-b // window) for b in bits
                                          if b > 1)


def count_align(d, L: int) -> None:
    """Count one launch of the alignment's squaring chain (K16) at L
    limbs: `d` the squarings of each listed column in launch order (not
    all 0); a warp holds 32 // g columns at the launch's g lanes a column
    (``ops.mont3.coop_shape`` at ``sqr_chain_width(d)``) and runs their
    largest d.  Counts only while a profiler is active."""
    if not _profiler_enabled():
        return
    from ..ops.mont3 import coop_shape, sqr_chain_width
    d = np.asarray(d, dtype=np.int64)
    g = coop_shape(L, sqr_chain_width(d))[0]
    starts = np.arange(0, d.size, 32 // g)
    widths = np.diff(np.append(starts, d.size))
    COUNTERS["align_launches"] += 1
    COUNTERS["align_columns"] += int(d.size)
    COUNTERS["align_squarings_needed"] += int(d.sum())
    COUNTERS["align_squarings_run"] += int(
        (np.maximum.reduceat(d, starts) * widths).sum())


def count_sched(columns: int, sms: int, halves: int = 1) -> None:
    """Count one K2 launch over `halves` CRT halves of `columns` columns
    each on a card of `sms` SMs: one CTA a tile of
    ``rns_kernels.TILE_COLS`` columns of one half, one CTA an SM (K2's
    launch bounds).  Counts only while a profiler is active."""
    if not _profiler_enabled():
        return
    from ..ops.rns_kernels import TILE_COLS
    ctas = halves * -(-columns // TILE_COLS)
    COUNTERS["sched_launches"] += 1
    COUNTERS["sched_ctas"] += ctas
    COUNTERS["sched_sm_slots"] += -(-ctas // sms) * sms


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Host wall-clock span: appends (label, seconds) to `sink` (a list)
    or prints to stderr.  The interval is also an ``annotate(label)``
    span, so it lies on a profiler trace's clock too."""
    import sys

    t0 = time.perf_counter()
    try:
        with annotate(label):
            yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, dt))
        else:
            print(f"[timed] {label}: {dt * 1e3:.1f} ms", file=sys.stderr,
                  flush=True)
