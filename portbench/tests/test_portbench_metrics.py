"""The metric readers: rate and percentiles over all requests of the
window, the trace's reductions, the roofline share."""

import numpy as np
import pytest

from portbench import run as R
from portbench import tracing


class FakeKind:
    op = "matmul"

    def work(self, widths, v):
        return (0.0, 3.35e12 * 0.002)      # 2 ms of bytes at the peak


def make_run(lat, values=1000, trace=None, launches=None):
    reqs, t = [], 100.0
    for s in lat:
        reqs.append(R.Request(0, 0, values, t, t + s))
        t += s
    return R.Run([FakeKind()], reqs, reqs[-1].t1 - reqs[0].t0, 1.5,
                 launches, trace, None)


def test_rate_and_tails_over_the_whole_window():
    lat = [0.010] * 90 + [0.200] * 10
    run = make_run(lat)
    rate = R.load_reader("values_per_s")(run)
    assert rate == pytest.approx(100 * 1000 / sum(lat), rel=1e-12)
    # one window, not the mean of chunk rates (which would be larger)
    chunks = [1000 * 10 / sum(lat[i:i + 10]) for i in range(0, 100, 10)]
    assert rate < np.mean(chunks)
    p50 = R.load_reader("request_ms_p50")(run)
    p95 = R.load_reader("request_ms_p95")(run)
    got = np.array([r.seconds for r in run.requests])
    assert p50 == pytest.approx(10.0)
    assert p95 == np.percentile(got, 95) * 1e3
    assert p95 == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert p95 > max(np.percentile(lat[i:i + 10], 95) * 1e3
                     for i in range(0, 90, 10))
    assert R.load_reader("setup_s")(run) == 1.5



@pytest.mark.parametrize("name", ["values_per_s", "request_ms_p50",
                                  "request_ms_p95"])
def test_device_bound_metrics_read_as_their_own(name):
    run = make_run([0.30, 0.35, 0.33, 0.41, 0.29])
    assert R.load_reader(name + ".device_bound")(run) == \
        R.load_reader(name)(run)


def chrome(events):
    return {"traceEvents": [dict(ph="X", **e) for e in events]}


def synthetic_trace():
    us = 1e6
    return tracing.Trace(chrome([
        {"cat": "user_annotation", "name": tracing.REQUEST_SPAN,
         "ts": 0.0, "dur": 0.010 * us, "tid": 1},
        {"cat": "user_annotation", "name": tracing.REQUEST_SPAN,
         "ts": 0.010 * us, "dur": 0.010 * us, "tid": 1},
        {"cat": "kernel", "name": "void rns_mul_kernel<3>(int)",
         "ts": 0.001 * us, "dur": 0.002 * us},
        {"cat": "kernel", "name": "at::native::elementwise_kernel",
         "ts": 0.002 * us, "dur": 0.002 * us},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 0.012 * us, "dur": 0.004 * us},
        {"cat": "cpu_op", "name": "aten::index_select", "tid": 1,
         "ts": 0.004 * us, "dur": 0.004 * us},
        {"cat": "cpu_op", "name": "aten::empty", "tid": 1,
         "ts": 0.005 * us, "dur": 0.001 * us},
    ]))


def test_trace_reductions():
    t = synthetic_trace()
    assert t.window == (0.0, 0.020)
    assert abs(t.busy(0.0, 0.020) - 0.007) < 1e-12
    idle = t.idle_by_host(0.0, 0.020)
    assert abs(sum(idle.values()) - 0.013) < 1e-12
    assert abs(idle["aten::index_select"] - 0.003) < 1e-12
    assert abs(idle["aten::empty"] - 0.001) < 1e-12
    run = make_run([0.010, 0.010], trace=t, launches={"rns_mul": 1})
    assert abs(R.load_reader("device_idle_pct")(run) - 65.0) < 1e-9
    assert R.load_reader("eager_launches_per_request")(run) == 0.5
    assert R.load_reader("kernel_launches_per_request")(run) == 0.5
    assert "sees all 1" in R.launch_check(run)
    # 2 ms least time a request over 3 + 4 ms of device time
    assert abs(R.load_reader("matmul_roofline")(run)
               - 100 * 0.004 / 0.007) < 1e-9
    b = R.breakdown(run)
    assert b["device_ops"][0][0] == "Memcpy HtoD"
    assert len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("op", ["sum_parties", "sharded_sum"])
def test_add_roofline_reads_both_k3_add_kinds(monkeypatch, op):
    monkeypatch.setattr(FakeKind, "op", op)
    run = make_run([0.010, 0.010], trace=synthetic_trace(),
                   launches={"rns_mul": 1})
    assert abs(R.load_reader("add_roofline")(run)
               - 100 * 0.004 / 0.007) < 1e-9
    assert R.load_reader("matmul_roofline")(run) is None


def test_reader_returns_nothing_without_a_trace():
    run = make_run([0.01, 0.01])
    for name in ("device_idle_pct", "matmul_roofline",
                 "eager_launches_per_request", "kernel_launches_per_request"):
        assert R.load_reader(name)(run) is None


def test_union_and_coverage():
    m = tracing.union([(0, 2), (1, 3), (5, 6)])
    assert m == [[0, 3], [5, 6]]
    assert tracing.covered(m, 2, 5.5) == 1.5
