#!/usr/bin/env python3
"""The program's spans in a traced run: the card's idle time split by the
``pct.`` span the request thread was in, and the device time by the
``pct.`` span that launched each kernel, copy and memset.

The port names its spans ``pct.<layer>.<stage>`` (its
``utils/profiling.py``): ``pct.api.*`` and ``pct.fixedpoint.*`` are the
layer "api and fixedpoint", ``pct.paillier.*`` the layer "models/paillier
eager stages".  They are ``record_function`` ranges, so they land in the
trace as user annotations on the request thread, on the clock of the
device's records.

``SpanTrace`` is ``tracing.Trace`` that also keeps the ``pct.`` spans of
the request thread (``spans``), the CUDA API calls of that thread
(``LAUNCH_CATS``) by correlation id (``launch_ts``) and each device record's
correlation id (``device_corr``); what ``Trace`` reads of a document it
reads the same.

    python3 portbench/spans.py --workload <name> --seed <n>

runs the cell once as ``run.py --trace 1`` does (a window of
``run.TRACE_SECONDS`` at most), with the trace parsed by
``SpanTrace``: the run's result line on stdout, then on stderr the idle
seconds by innermost ``pct.`` span, the device seconds by launching span
(and the count of device records no launch on the request thread could
place), the share of the idle time inside requests that no ``pct.`` span
covers, the identity of the two layers' idle shares plus the idle
outside any ``pct.`` span against ``device_idle_pct``, and the program's
ct*pt counters (``profiling.COUNTERS``); one JSON line of those readings
last on stdout.  It needs a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)

from portbench import run, tracing  # noqa: E402

PREFIX = "pct."
LAYERS = {"api": "api and fixedpoint", "fixedpoint": "api and fixedpoint",
          "paillier": "models/paillier eager stages"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def layer(span):
    """The layer of a ``pct.<layer>.<stage>`` span name; None for None
    (no span) or a name outside the scheme."""
    if span is None:
        return None
    parts = span.split(".")
    return LAYERS.get(parts[1]) if len(parts) > 2 else None


class SpanTrace(tracing.Trace):
    """``tracing.Trace`` plus the program's spans and the launches."""

    def __init__(self, doc: dict):
        super().__init__(doc)
        events = [e for e in doc.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        tid = next((e.get("tid") for e in sorted(
            (e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == tracing.REQUEST_SPAN),
            key=lambda e: e["ts"])), None)
        self.spans = sorted(
            (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
            for e in events if e.get("cat") == "user_annotation"
            and e.get("tid") == tid
            and e.get("name", "").startswith(PREFIX))
        self.launch_ts = {
            e["args"]["correlation"]: e["ts"] * 1e-6 for e in events
            if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid
            and "correlation" in e.get("args", {})}
        self.device_corr = sorted(
            (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
             e.get("args", {}).get("correlation"))
            for e in events if e.get("cat") in tracing.DEVICE_CATS)
        self.segments = tracing._innermost(self.spans)
        self._seg_starts = [s for s, _, _ in self.segments]

    def span_at(self, t: float):
        """The innermost ``pct.`` span in force at time t, or None."""
        i = bisect.bisect_right(self._seg_starts, t) - 1
        if i >= 0 and self.segments[i][0] <= t < self.segments[i][1]:
            return self.segments[i][2]
        return None

    def idle_by_span(self, lo: float, hi: float) -> dict:
        """Seconds of [lo, hi] with no device activity, by the innermost
        ``pct.`` span of the request thread (None where it was in none):
        ``Trace.idle_by_host``'s walk over the spans in place of the aten
        ops."""
        view = types.SimpleNamespace(host=self.spans,
                                     busy_merged=self.busy_merged)
        out = tracing.Trace.idle_by_host(view, lo, hi)
        out[None] = out.pop(tracing.HOST_IDLE, 0.0)
        return out

    def device_by_span(self, lo: float, hi: float) -> tuple:
        """({span or None: device seconds}, unplaced): each kernel, copy
        and memset that starts in [lo, hi], by the innermost ``pct.``
        span in force when the request thread launched it (the runtime
        call of the same correlation id); `unplaced` counts the records
        whose launch is not on the request thread."""
        out, unplaced = {}, 0
        for s, e, corr in self.device_corr:
            if not lo <= s <= hi:
                continue
            t = self.launch_ts.get(corr)
            if t is None:
                unplaced += 1
                continue
            span = self.span_at(t)
            out[span] = out.get(span, 0.0) + (e - s)
        return out, unplaced


def readings(trace: SpanTrace) -> dict:
    """The split of one traced window, in % of the window and seconds."""
    lo, hi = trace.window
    win = hi - lo
    idle = trace.idle_by_span(lo, hi)
    by_layer = {}
    for span, sec in idle.items():
        by_layer[layer(span)] = by_layer.get(layer(span), 0.0) + sec
    inside = {}
    for rlo, rhi in trace.requests:
        for span, sec in trace.idle_by_span(rlo, rhi).items():
            inside[span] = inside.get(span, 0.0) + sec
    in_req = sum(inside.values())
    dev, unplaced = trace.device_by_span(lo, hi)
    pct = (lambda s: 100.0 * s / win) if win > 0 else (lambda s: None)
    return {
        "window_s": win,
        "device_idle_pct": pct(win - trace.busy(lo, hi)),
        "idle_in_api_pct": pct(by_layer.get("api and fixedpoint", 0.0)),
        "idle_in_models_pct": pct(by_layer.get(
            "models/paillier eager stages", 0.0)),
        "idle_outside_pct": pct(by_layer.get(None, 0.0)),
        "idle_in_requests_s": in_req,
        "idle_in_requests_uncovered_pct": (
            100.0 * inside.get(None, 0.0) / in_req if in_req > 0 else None),
        "idle_by_span_s": {str(k): v for k, v in idle.items()},
        "device_by_span_s": {str(k): v for k, v in dev.items()},
        "device_unplaced": unplaced,
    }


def report(r: dict, log=sys.stderr) -> None:
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])
    print("idle by innermost pct span (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in top(r["idle_by_span_s"])), file=log)
    print("device by launching pct span (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in top(r["device_by_span_s"]))
        + f"; {r['device_unplaced']} device records unplaced", file=log)
    if r["idle_in_requests_uncovered_pct"] is not None:
        print(f"idle inside requests: {r['idle_in_requests_s']:.4f} s, "
              f"{r['idle_in_requests_uncovered_pct']:.2f}% of it in no "
              f"pct span", file=log)
    if r["device_idle_pct"] is not None:
        tot = (r["idle_in_api_pct"] + r["idle_in_models_pct"]
               + r["idle_outside_pct"])
        print(f"idle: api {r['idle_in_api_pct']:.3f} + models "
              f"{r['idle_in_models_pct']:.3f} + outside pct spans "
              f"{r['idle_outside_pct']:.3f} = {tot:.3f}% of the window; "
              f"device_idle_pct {r['device_idle_pct']:.3f}", file=log)
    if r.get("counters"):
        print(f"ct*pt counters over the window: {r['counters']}", file=log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    parsed = []

    class Kept(SpanTrace):
        def __init__(self, doc):
            super().__init__(doc)
            parsed.append(self)

    base, tracing.Trace = tracing.Trace, Kept   # run_cell parses by it
    try:
        rc = run.main(["--workload", a.workload, "--seed", str(a.seed),
                       "--seconds", str(run.TRACE_SECONDS), "--trace", "1"])
    finally:
        tracing.Trace = base
    if rc != 0 or not parsed:
        return rc or 1
    r = readings(parsed[-1])
    prof = sys.modules.get(
        "pailliercryptolib_python_tpu_torch.utils.profiling")
    r["counters"] = dict(getattr(prof, "COUNTERS", {}))
    report(r)
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "requests": len(parsed[-1].requests), **r}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
