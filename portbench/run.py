#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``: the key and its widths) and a traffic mix
(``workloads/<traffic>.json``).  A run loads the port
(``pailliercryptolib_python_tpu_torch``) with every ``PAILLIER_*`` knob
cleared, builds the key's contexts, encrypts the mix's input pools,
warms up each request shape once, then issues requests back to back
from one caller (a closed loop) for ``--seconds``.  After the window it
judges the kept answers with the plain reference, and prints one JSON
line last on stdout: the end-to-end metrics with ``--trace 0``; with
``--trace 1`` a ``torch.profiler`` trace of the window (at most
TRACE_SECONDS, and the mix's ``traced_requests``) and the per-layer
metrics read from it.  Each
number the judge compared is printed beside its limit as the last lines
on stderr and under ``checks``, the line's last key.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for); 3 when a JAX module was loaded; 1 on any other failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pailliercryptolib_python_tpu")
TRACE_SECONDS = 8.0      # a traced window's longest: the trace is read whole


def _prepare_process() -> None:
    """Defaults of the port, one host thread for the numeric libraries,
    caches inside the checkout, the checkout's root on the import path
    (and not this directory)."""
    for k in [k for k in os.environ if k.startswith("PAILLIER_")]:
        del os.environ[k]
    # One thread for the host's numeric libraries: the host path is
    # Python and small tensor ops, and a parallel region that waits for a
    # descheduled worker made runs spread several times wider.
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
        sys.path.pop(0)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Request:
    __slots__ = ("kind", "v", "values", "t0", "t1")

    def __init__(self, kind, v, values, t0, t1):
        self.kind, self.v, self.values = kind, v, values
        self.t0, self.t1 = t0, t1

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Run:
    """What a metric reader reads: the window's requests and times, the
    launch counters' increase, the trace (traced runs), the work model."""

    def __init__(self, kinds, requests, window_s, setup_s, launches, trace,
                 widths):
        self.kinds, self.requests = kinds, requests
        self.window_s, self.setup_s = window_s, setup_s
        self.launches, self.trace, self.widths = launches, trace, widths
        self.names = sorted(launches or (), key=len, reverse=True)
        self._work = {}

    def metric(self, name: str):
        """Another metric's reading of this run (its reader)."""
        return load_reader(name)(self)

    def work(self, kind: int, v: int) -> tuple:
        """(int8 operations, bytes) of a request (``workmodel.py``)."""
        if (kind, v) not in self._work:
            self._work[kind, v] = self.kinds[kind].work(self.widths, v)
        return self._work[kind, v]

    def handwritten(self, kernel_name: str):
        """The launch counter a trace kernel belongs to, or None: the
        program's kernel `<counter>_kernel` (csrc)."""
        for k in self.names:
            if k + "_kernel" in kernel_name:
                return k
        return None

    def traced_spans(self) -> list:
        """[(request, (lo, hi))]: each request with its span in the trace."""
        if self.trace is None:
            return []
        return list(zip(self.requests, self.trace.requests))

    def roofline_pct(self, op: str):
        """Least chip time of the op's requests over the device time
        inside them, in %; None where there is nothing to read."""
        from portbench.workmodel import least_seconds
        least = busy = 0.0
        for r, (lo, hi) in self.traced_spans():
            if self.kinds[r.kind].op != op:
                continue
            ops, n_bytes = self.work(r.kind, r.v)
            least += least_seconds(n_bytes, ops)
            busy += self.trace.busy(lo, hi)
        if busy <= 0 or least <= 0:
            return None
        return 100.0 * least / busy


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: str, config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, system_factory, device: str, metrics: list,
             t_start: float, log=sys.stderr, max_requests=None) -> dict:
    """One run of a cell: set-up, the window, the judge, the metrics.
    Returns the result object (``checks`` last).  `max_requests` ends
    the window early (the control's runs)."""
    from contextlib import nullcontext
    from portbench import kinds as kinds_mod
    from portbench import reference as ref
    from portbench import traffic
    from portbench.tracing import HostClock, profiled, request_span
    from portbench.workmodel import Widths
    import numpy as np

    kinds = kinds_mod.make(mix, seed)
    order = traffic.cycle([k.n_variants for k in kinds], seed)
    system = system_factory(config["key"], device)
    t_system = time.perf_counter()
    for k in kinds:
        k.setup(system)
    system.sync()
    t_pools = time.perf_counter()
    for k in kinds:                       # each request shape once
        for v in k.warm_variants():
            k.call(system, v)
    system.sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"setup: {t_system - t_start:.3f} s to the key's contexts "
          f"(imports, CUDA, kernel library), {t_pools - t_system:.3f} s "
          f"input pools, {t_warm - t_pools:.3f} s warm-up", file=log)

    caps = [max_requests]
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
        caps.append(mix.get("traced_requests"))
    cap = min((c for c in caps if c), default=None)
    keep_rng = random.Random(seed * 4 + traffic.STREAM_CHECK)
    kept = [[] for _ in kinds]            # [(request index, answer)]
    seen = [0] * len(kinds)
    # A fresh kind also keeps the first two answers to the variant of its
    # first request (one cycle apart): a cached answer, or one obfuscator
    # used again, shows there as the same residues.
    pairs = [[] for _ in kinds]
    host = HostClock()
    requests, failed, errors = [], 0, []
    counts0 = system.counters()
    cuda = system.device.type == "cuda"

    def window():
        nonlocal failed
        span = request_span if trace else nullcontext
        deadline = time.perf_counter() + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline or (cap is not None and len(requests) >= cap):
                break
            ki, v = order[i % len(order)]
            i += 1
            kind = kinds[ki]
            ok = True
            try:
                with span():
                    ans = kind.call(system, v)
            except Exception as e:          # a failed request is counted
                ok, ans = False, None
                failed += 1
                errors.append(f"{kind.op}: {type(e).__name__}: {e}")
            t1 = time.perf_counter()
            requests.append(Request(ki, v, kind.values(v) if ok else 0,
                                    t0, t1))
            if ok and kind.fresh and len(pairs[ki]) < 2 and (
                    not pairs[ki] or requests[pairs[ki][0][0]].v == v):
                pairs[ki].append((len(requests) - 1, ans))
            if ok:                  # keep all, or a seeded reservoir
                j = seen[ki]
                seen[ki] += 1
                if kind.keep == 0 or j < kind.keep:
                    kept[ki].append((len(requests) - 1, ans))
                else:
                    slot = keep_rng.randrange(j + 1)
                    if slot < kind.keep:
                        kept[ki][slot] = (len(requests) - 1, ans)

    with (profiled(cuda) if trace else nullcontext({})) as box, host:
        window()
    counts1 = system.counters()
    memory_peak = system.memory_peak()
    window_s = (requests[-1].t1 - requests[0].t0) if requests else 0.0

    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    # The judge: answers to host form, the program's state dropped, then
    # the plain reference.
    t_judge = time.perf_counter()
    answers = [[(ri, kinds[ki].collect(system, a))
                for ri, a in sorted(dict(kk + pp).items())]
               for ki, (kk, pp) in enumerate(zip(kept, pairs))]
    n_pairs = [len(pp) for pp in pairs]
    del kept, pairs
    for k in kinds:
        k.release()
    key = ref.Key(config["key"])
    judge_rng = random.Random(seed * 4 + traffic.STREAM_CHECK + 1)
    wrong = checked = 0
    faults = {}
    for ki, kk in enumerate(answers):
        for ri, got in kk:
            bad = kinds[ki].judge(key, requests[ri].v, got, judge_rng)
            checked += 1
            wrong += bool(bad)
            for f in bad:
                faults[f] = faults.get(f, 0) + 1
    checks = {"wrong_answers": {"value": wrong, "limit": 0}}
    fresh = [ki for ki, k in enumerate(kinds) if k.fresh]
    if fresh:
        checks["unfresh_ciphertexts"] = {"value": sum(
            ref.unfresh(key, [got[0] for _, got in answers[ki]])
            for ki in fresh), "limit": 0}
    judge_s = time.perf_counter() - t_judge
    correct = (failed == 0 and checked > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    launches = ({k: counts1[k] - counts0[k] for k in counts1}
                if cuda else None)
    tr = box.get("trace")
    widths = Widths(config["widths"], int(config["key"]["randbits"]))
    run = Run(kinds, requests, window_s, setup_s, launches, tr, widths)
    values = {}
    for m in metrics:
        v = load_reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": device_name(system), "count": 1,
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(requests),
              "failed": failed, "metrics": values, "device": dev}
    if tr is not None:
        lo, hi = tr.window
        dev["busy_s"] = tr.busy(lo, hi)
        dev["window_s"] = hi - lo
        result["breakdown"] = breakdown(run)
        print(f"trace: {launch_check(run)}", file=log)
    if cuda:
        dev["card"] = card_line()
    for e in errors[:5]:
        print(f"failed request: {e}", file=log)
    if requests:
        q = np.percentile([r.seconds * 1e3 for r in requests],
                          [0, 25, 50, 75, 100])
        print("latency ms min/p25/p50/p75/max: "
              + " / ".join(f"{v:.2f}" for v in q), file=log)
    print(host, file=log)
    print(f"judged {checked} answers of {len(requests)} requests "
          f"({failed} failed; wrong by kind of fault: {faults}; answers to "
          f"one variant kept for the obfuscators: "
          f"{[n_pairs[ki] for ki in fresh]}) in {judge_s:.3f} s; setup "
          f"{setup_s:.3f} s, window {window_s:.3f} s", file=log)
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    pass


def device_name(system) -> str:
    if system.device.type != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(system.device)


def launch_check(run: Run) -> str:
    """Does the trace see every hand-written launch the counters saw?"""
    lo, hi = run.trace.window
    seen = {}
    for name, _ in run.trace.kernels(lo, hi):
        k = run.handwritten(name)
        if k is not None:
            seen[k] = seen.get(k, 0) + 1
    want = {k: v for k, v in (run.launches or {}).items() if v}
    short = {k: (seen.get(k, 0), v) for k, v in want.items()
             if seen.get(k, 0) != v}
    tot_seen = sum(seen.values())
    tot = sum(want.values())
    if not short:
        return f"sees all {tot} hand-written launches the counters counted"
    return (f"sees {tot_seen} of {tot} hand-written launches; per kernel "
            f"(seen, counted): {short}")


def breakdown(run: Run) -> dict:
    """The ten device operations that took most time, and the idle time
    of the window split by what the host was doing, in seconds."""
    lo, hi = run.trace.window
    ops = {}
    for name, sec in run.trace.kernels(lo, hi):
        k = run.handwritten(name)
        label = k if k is not None else name[:120]
        ops[label] = ops.get(label, 0.0) + sec
    for s, e, name, cat in run.trace.device:
        if cat != "kernel" and lo <= s <= hi:
            ops[name[:120]] = ops.get(name[:120], 0.0) + (e - s)
    idle = run.trace.idle_by_host(lo, hi)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def main(argv=None) -> int:
    _prepare_process()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    seed = a.seed & ((1 << 63) - 1)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"no cell {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    cell = cells[a.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    from portbench import traffic
    mix = traffic.load(cell["traffic"])
    group = bench["per_layer"] if a.trace else bench["end_to_end"]
    metrics = [m for m in group if applies(m, a.workload)]

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        from portbench.systems import PortSystem
        result = run_cell(a.workload, config, mix, seed, a.seconds,
                          bool(a.trace), PortSystem, "cuda:0", metrics,
                          T_START)
    except ForbiddenModules as e:
        print(f"portbench: JAX modules loaded: {e.args[0]}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
