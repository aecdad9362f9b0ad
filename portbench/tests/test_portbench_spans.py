"""The program's spans and counters in a trace: ``spans.SpanTrace`` on
synthetic trace documents, and the reader of ``exp_windows_useful_pct``."""

import json
import os
import sys
import types

import pytest

from portbench import run as R
from portbench import spans as S
from portbench import tracing
from portbench.tests.test_portbench_metrics import make_run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MS = 1e3                    # trace times are microseconds


def doc():
    """Two requests of 10 ms on thread 1.  Request 1: ``pct.api.add``
    over it, ``pct.paillier.ctpt`` from 2 to 6 ms with an aten op inside
    it (3-5 ms), a kernel 6.5-7.5 ms launched at 5.5 ms.  Request 2:
    ``pct.api.mul`` 10-16 ms, nothing from 16 to 20 ms; a memcpy
    12-13 ms launched at 11 ms, a kernel 17-18 ms launched on thread 2."""
    ev = [
        {"cat": "user_annotation", "name": tracing.REQUEST_SPAN, "tid": 1,
         "ts": 0.0, "dur": 10 * MS},
        {"cat": "user_annotation", "name": tracing.REQUEST_SPAN, "tid": 1,
         "ts": 10 * MS, "dur": 10 * MS},
        {"cat": "user_annotation", "name": "pct.api.add", "tid": 1,
         "ts": 0.0, "dur": 10 * MS},
        {"cat": "user_annotation", "name": "pct.paillier.ctpt", "tid": 1,
         "ts": 2 * MS, "dur": 4 * MS},
        {"cat": "user_annotation", "name": "pct.api.mul", "tid": 1,
         "ts": 10 * MS, "dur": 6 * MS},
        {"cat": "user_annotation", "name": "pct.api.other_thread",
         "tid": 2, "ts": 16 * MS, "dur": 4 * MS},
        {"cat": "cpu_op", "name": "aten::index_select", "tid": 1,
         "ts": 3 * MS, "dur": 2 * MS},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
         "ts": 5.5 * MS, "dur": 0.01 * MS, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "void mm3_exp_kernel<4>(int)",
         "ts": 6.5 * MS, "dur": 1 * MS, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "tid": 1,
         "ts": 11 * MS, "dur": 0.01 * MS, "args": {"correlation": 8}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 12 * MS,
         "dur": 1 * MS, "args": {"correlation": 8}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 2,
         "ts": 16.5 * MS, "dur": 0.01 * MS, "args": {"correlation": 9}},
        {"cat": "kernel", "name": "at::native::elementwise_kernel",
         "ts": 17 * MS, "dur": 1 * MS, "args": {"correlation": 9}},
    ]
    return {"traceEvents": [dict(ph="X", **e) for e in ev]}


def test_idle_goes_to_the_innermost_pct_span_not_the_aten_op():
    t = S.SpanTrace(doc())
    idle = t.idle_by_span(*t.window)
    # busy 6.5-7.5, 12-13, 17-18 ms: 17 ms idle
    assert sum(idle.values()) == pytest.approx(0.017, abs=1e-12)
    assert idle["pct.paillier.ctpt"] == pytest.approx(0.004, abs=1e-12)
    assert idle["pct.api.add"] == pytest.approx(0.005, abs=1e-12)
    assert idle["pct.api.mul"] == pytest.approx(0.005, abs=1e-12)
    assert idle[None] == pytest.approx(0.003, abs=1e-12)
    assert "aten::index_select" not in idle
    assert "pct.api.other_thread" not in idle        # another thread
    # the aten reduction of the same document is as before
    host = t.idle_by_host(*t.window)
    assert host["aten::index_select"] == pytest.approx(0.002, abs=1e-12)


def test_layers_and_the_identity_with_device_idle_pct():
    t = S.SpanTrace(doc())
    r = S.readings(t)
    run = make_run([0.010, 0.010], trace=t)
    idle_pct = R.load_reader("device_idle_pct")(run)
    assert r["device_idle_pct"] == pytest.approx(idle_pct, abs=1e-9)
    assert r["idle_in_api_pct"] == pytest.approx(100 * 0.010 / 0.020)
    assert r["idle_in_models_pct"] == pytest.approx(100 * 0.004 / 0.020)
    assert (r["idle_in_api_pct"] + r["idle_in_models_pct"]
            + r["idle_outside_pct"]) == pytest.approx(idle_pct, abs=1e-9)
    # inside the requests, 3 of 17 ms idle lies in no pct span
    assert r["idle_in_requests_uncovered_pct"] == pytest.approx(
        100 * 3 / 17)
    assert S.layer("pct.fixedpoint.encode") == "api and fixedpoint"
    assert S.layer("pct.paillier.crt_exp") == "models/paillier eager stages"
    assert S.layer(None) is None


def test_device_time_goes_to_the_launching_span():
    t = S.SpanTrace(doc())
    dev, unplaced = t.device_by_span(*t.window)
    assert dev == {"pct.paillier.ctpt": pytest.approx(0.001),
                   "pct.api.mul": pytest.approx(0.001)}
    assert unplaced == 1              # launched on another thread
    assert t.span_at(0.001) == "pct.api.add"
    assert t.span_at(0.003) == "pct.paillier.ctpt"
    assert t.span_at(0.017) is None


def test_existing_readers_read_the_same_document_as_before():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    old = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]
           if m["name"] != "exp_windows_useful_pct"]
    d = doc()
    a = make_run([0.010, 0.010], trace=tracing.Trace(d),
                 launches={"mm3_exp": 1})
    b = make_run([0.010, 0.010], trace=S.SpanTrace(d),
                 launches={"mm3_exp": 1})
    for name in old:
        assert R.load_reader(name)(a) == R.load_reader(name)(b), name
    assert R.breakdown(a) == R.breakdown(b)
    assert R.launch_check(a) == R.launch_check(b)
    assert "sees all 1" in R.launch_check(b)


def test_exp_windows_useful_pct_from_the_counters(monkeypatch):
    read = R.load_reader("exp_windows_useful_pct")
    mod = "pailliercryptolib_python_tpu_torch.utils.profiling"
    run = make_run([0.010, 0.010], trace=S.SpanTrace(doc()))
    monkeypatch.setitem(sys.modules, mod, types.SimpleNamespace(COUNTERS={
        "exp_columns": 8, "exp_windows_run": 128,
        "exp_windows_needed": 15}))
    assert read(run) == pytest.approx(100 * 15 / 128)
    assert read(make_run([0.010, 0.010])) is None        # not traced
    # no ct*pt ran, or a program without the counters: nothing to read
    monkeypatch.setitem(sys.modules, mod, types.SimpleNamespace(COUNTERS={
        "exp_columns": 0, "exp_windows_run": 0, "exp_windows_needed": 0}))
    assert read(run) is None
    monkeypatch.setitem(sys.modules, mod, types.SimpleNamespace())
    assert read(run) is None
    monkeypatch.delitem(sys.modules, mod)
    assert read(run) is None
