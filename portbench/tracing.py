"""The traced run: a ``torch.profiler`` trace of the window, reduced.

The profiler records CPU and CUDA activity; the trace is written as a
Chrome trace into a temporary directory (under ``TMPDIR``), read back
and deleted.  The harness marks each request with a span of its own
(``REQUEST_SPAN``), so the reduction knows the window and each request's
interval on the trace's clock.  Device activity is every kernel, memcpy
and memset on the card; "busy" is the union of their intervals.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import tempfile
import time

REQUEST_SPAN = "portbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_IDLE = "host Python outside aten ops"
COLLECTIVE_KERNEL = "nccl"       # NCCL's kernels: ncclDevKernel_*, ncclKernel_*


def is_collective(kernel_name: str) -> bool:
    """A kernel of the collectives library (NCCL), not of the program."""
    return COLLECTIVE_KERNEL in kernel_name


@contextlib.contextmanager
def profiled(cuda: bool):
    """Profile the body; yields a dict that holds the parsed ``Trace``
    under "trace" once the body has left."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    box = {}
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        with profile(activities=acts) as prof:
            yield box
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            box["trace"] = Trace(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class HostClock:
    """What the host did while the body ran: the process's CPU seconds
    and involuntary context switches, the machine's share of time stolen
    by its hypervisor (``/proc/stat``), and the garbage collections of
    each generation with their seconds (``gc.callbacks``)."""

    def __init__(self):
        self.count, self.seconds = [0, 0, 0], [0.0, 0.0, 0.0]
        self._t0 = None

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0
            self._t0 = None

    @staticmethod
    def _cpu_ticks():
        try:
            with open("/proc/stat") as f:
                return [int(v) for v in f.readline().split()[1:]]
        except OSError:
            return None

    def __enter__(self):
        import resource
        self._ru = resource.getrusage(resource.RUSAGE_SELF)
        self._ticks = self._cpu_ticks()
        self._wall = time.perf_counter()
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        import resource
        gc.callbacks.remove(self._hook)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.wall = time.perf_counter() - self._wall
        self.cpu = (ru.ru_utime + ru.ru_stime
                    - self._ru.ru_utime - self._ru.ru_stime)
        self.nivcsw = ru.ru_nivcsw - self._ru.ru_nivcsw
        t1 = self._cpu_ticks()
        self.steal = None
        if self._ticks and t1 and len(t1) > 7:
            d = [b - a for a, b in zip(self._ticks, t1)]
            self.steal = d[7] / max(1, sum(d))

    def __str__(self):
        steal = ("not read" if self.steal is None
                 else f"{100 * self.steal:.2f}%")
        return (f"host in the window: {self.cpu:.3f} s of CPU in "
                f"{self.wall:.3f} s, {self.nivcsw} involuntary switches, "
                f"steal {steal} of the machine; gc by generation: "
                + ", ".join(f"{c} in {s:.4f} s"
                            for c, s in zip(self.count, self.seconds)))


def request_span():
    from torch.profiler import record_function
    return record_function(REQUEST_SPAN)


def union(intervals: list) -> list:
    """Merged [(start, end)] of intervals sorted by start."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(merged: list, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by merged intervals."""
    tot = 0.0
    for s, e in merged:
        if e <= lo:
            continue
        if s >= hi:
            break
        tot += min(e, hi) - max(s, lo)
    return tot


class Trace:
    """Device and host activity of one profiled window, in seconds."""

    def __init__(self, doc: dict):
        events = [e for e in doc.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                              e.get("name", ""), e.get("cat"))
                             for e in events if e.get("cat") in DEVICE_CATS)
        spans = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                        e.get("tid"))
                       for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") == REQUEST_SPAN)
        self.requests = [(s, e) for s, e, _ in spans]
        tid = spans[0][2] if spans else None
        self.host = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                            e.get("name", ""))
                           for e in events if e.get("cat") == "cpu_op"
                           and e.get("tid") == tid)
        self.busy_merged = union([(s, e) for s, e, _, _ in self.device])

    @property
    def window(self) -> tuple:
        if not self.requests:
            return (0.0, 0.0)
        return (self.requests[0][0], max(e for _, e in self.requests))

    def busy(self, lo: float, hi: float) -> float:
        return covered(self.busy_merged, lo, hi)

    def collective(self, lo: float, hi: float) -> float:
        """Length of [lo, hi] covered by collective kernels (NCCL)."""
        return covered(union([(s, e) for s, e, n, c in self.device
                              if c == "kernel" and is_collective(n)]),
                       lo, hi)

    def kernels(self, lo: float, hi: float) -> list:
        """[(name, seconds)] of each kernel that starts in [lo, hi]."""
        return [(n, e - s) for s, e, n, c in self.device
                if c == "kernel" and lo <= s <= hi]

    def idle_by_host(self, lo: float, hi: float) -> dict:
        """Seconds of [lo, hi] with no device activity, split by the
        innermost aten op the host thread was in (``HOST_IDLE`` where it
        was in none)."""
        segs = _innermost(self.host)
        out = {}
        cur = lo
        gaps = []
        for s, e in self.busy_merged:
            if e <= lo:
                continue
            if s >= hi:
                break
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
        j = 0
        for gs, ge in gaps:
            labelled = 0.0
            while j < len(segs) and segs[j][1] <= gs:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < ge:
                ov = min(segs[k][1], ge) - max(segs[k][0], gs)
                if ov > 0:
                    out[segs[k][2]] = out.get(segs[k][2], 0.0) + ov
                    labelled += ov
                k += 1
            out[HOST_IDLE] = out.get(HOST_IDLE, 0.0) + (ge - gs - labelled)
        return out


def _innermost(ops: list) -> list:
    """[(start, end, name)] segments of the innermost op in force, from
    nested op intervals sorted by start."""
    segs, stack = [], []
    cur = None

    def emit(upto):
        if stack and cur is not None and upto > cur:
            segs.append((cur, upto, stack[-1][1]))

    for s, e, name in sorted(ops, key=lambda o: (o[0], -o[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            cur = stack[-1][0]
            stack.pop()
        emit(s)
        cur = s
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        cur = stack[-1][0]
        stack.pop()
    return segs
