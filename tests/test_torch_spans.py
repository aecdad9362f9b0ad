"""The port's program spans and ct*pt work counters on the CPU, at the
256-bit fixed key, under a CPU ``torch.profiler``: each public operation
emits its ``pct.api.*`` span with the expected ``pct.*`` stages nested
inside it on one thread (the alignment's ``pct.paillier.align`` inside
``pct.api.align``); with no profiler active ``annotate`` enters no
``record_function`` and ``COUNTERS`` stays still; the counters of
``mul_pt`` are exact on both routes."""

import json
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.utils import config as tcfg
from pailliercryptolib_python_tpu_torch.utils import profiling
from pailliercryptolib_python_tpu_torch.utils.fixtures import fixed_key_ints

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
X = np.array([0.5, -1.25, 3e-3, 7.0, 1e-5])
W = np.array([1.5, -2.0, 0.25, 3.0, -0.5])


@pytest.fixture(autouse=True)
def _setup():
    saved = {k: getattr(tcfg.get_config(), k) for k in
             ("encrypt_engine", "decrypt_engine", "fixed_shape_ops")}
    counters = dict(profiling.COUNTERS)
    yield
    tcfg.set_config(**saved)
    profiling.COUNTERS.update(counters)


@pytest.fixture(scope="module")
def keys():
    ipub = tpt.ipclPublicKey(KD["n"], KD["bits"], True, KD["hs"],
                             KD["randbits"], device=CPU)
    pk = tpt.PaillierPublicKey(ipub)
    sk = tpt.PaillierPrivateKey(pk, KD["p"], KD["q"])
    cx = pk.encrypt(X)
    cy = pk.encrypt(X * 3 + 1)        # other exponents: `+` aligns
    return pk, sk, cx, cy


def pct_spans(fn, tmp_path):
    """[(name, start, end, tid)] of the ``pct.`` spans fn emits under a
    CPU profiler, from the exported Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("pct.")]


def inside(child, parent):
    return (child[3] == parent[3] and parent[1] <= child[1]
            and child[2] <= parent[2])


# (operation, its api span, [(stage, the span it nests in)])
CASES = {
    "encrypt": (lambda pk, sk, cx, cy: pk.encrypt(X), "pct.api.encrypt",
                [("pct.fixedpoint.encode", "pct.api.encrypt"),
                 ("pct.paillier.pack", "pct.api.encrypt"),
                 ("pct.paillier.entropy", "pct.api.encrypt"),
                 ("pct.paillier.comb", "pct.api.encrypt")]),
    "add": (lambda pk, sk, cx, cy: cx + cy, "pct.api.add",
            [("pct.api.align", "pct.api.add"),
             ("pct.paillier.align", "pct.api.align"),
             ("pct.paillier.add", "pct.api.add")]),
    "mul": (lambda pk, sk, cx, cy: cx * W, "pct.api.mul",
            [("pct.fixedpoint.encode", "pct.api.mul"),
             ("pct.api.flags", "pct.api.mul"),
             ("pct.paillier.ctpt", "pct.api.mul"),
             ("pct.paillier.digits", "pct.paillier.ctpt"),
             ("pct.api.invert", "pct.api.mul"),
             ("pct.paillier.gather", "pct.api.invert")]),
    "matmul": (lambda pk, sk, cx, cy: cx @ np.stack([W, -W * 3], axis=1),
               "pct.api.matmul",
               [("pct.fixedpoint.encode", "pct.api.matmul"),
                ("pct.api.flags", "pct.api.matmul"),
                ("pct.paillier.gather", "pct.api.matmul"),
                ("pct.paillier.ctpt", "pct.api.matmul"),
                ("pct.api.invert", "pct.api.matmul"),
                ("pct.api.align", "pct.api.matmul"),
                ("pct.paillier.align", "pct.api.align"),
                ("pct.paillier.reduce", "pct.api.matmul")]),
    "sum": (lambda pk, sk, cx, cy: cx.sum(), "pct.api.sum",
            [("pct.api.align", "pct.api.sum"),
             ("pct.paillier.align", "pct.api.align"),
             ("pct.paillier.reduce", "pct.api.sum")]),
    "decrypt": (lambda pk, sk, cx, cy: sk.decrypt(cx), "pct.api.decrypt",
                [("pct.paillier.crt_reduce", "pct.api.decrypt"),
                 ("pct.paillier.crt_exp", "pct.api.decrypt"),
                 ("pct.paillier.crt_recombine", "pct.api.decrypt"),
                 ("pct.api.readback", "pct.api.decrypt"),
                 ("pct.fixedpoint.decode", "pct.api.decrypt")]),
}


@pytest.mark.parametrize("op", sorted(CASES))
def test_each_operation_emits_its_nested_spans(op, keys, tmp_path):
    fn, top, nested = CASES[op]
    out = []
    spans = pct_spans(lambda: out.append(fn(*keys)), tmp_path)
    tops = [s for s in spans if s[0] == top]
    assert tops, [s[0] for s in spans]
    assert len({s[3] for s in spans}) == 1          # one thread
    # every span lies inside the operation's outermost span
    outer = max(tops, key=lambda s: s[2] - s[1])
    assert all(inside(s, outer) for s in spans)
    for child, parent in nested:
        kids = [s for s in spans if s[0] == child]
        assert kids, (child, [s[0] for s in spans])
        for k in kids:
            assert any(inside(k, p) for p in spans if p[0] == parent
                       and p is not k), (child, parent)
    if op == "mul":                 # the spans do not change the answer
        assert np.allclose(keys[1].decrypt(out[0]), X * W)


def test_timed_is_a_span_too(tmp_path):
    sink = []

    def body():
        with profiling.timed("pct.api.timed_stage", sink):
            torch.ones(4).sum()

    spans = pct_spans(body, tmp_path)
    assert [s[0] for s in spans] == ["pct.api.timed_stage"]
    assert sink and sink[0][0] == "pct.api.timed_stage"


def test_no_profiler_no_span_no_count(keys, monkeypatch):
    """With no profiler active, ``annotate`` is one shared no-op context:
    no ``record_function`` is entered, and the counters do not move."""
    pk, sk, cx, cy = keys

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.annotate("pct.api.a") is profiling.annotate("pct.x.b")
    before = dict(profiling.COUNTERS)
    got = sk.decrypt(((cx + cy) * W).sum())
    assert np.isclose(got, ((X + X * 3 + 1) * W).sum())
    assert profiling.COUNTERS == before


# Hand-made exponents, 5 columns padded to 8: 0, 1 and the padding count
# no window; 2 needs 1, 2^9 (10 bits) 3, 2^40 (41 bits) 11: 15 in all.
EXPS = [0, 1, 2, 1 << 9, 1 << 40]


@pytest.mark.parametrize("route,fixed,run", [
    ("rns", False, 8 * 16),     # 11 windows bucketed to 16
    ("limb", False, 8 * 11),    # the leading zero windows skipped
    ("rns", True, 8 * 64),      # fixed_shape_ops: all 64 windows of n
    ("limb", True, 8 * 64),
])
def test_exp_counters_are_exact(monkeypatch, route, fixed, run):
    tcfg.set_config(fixed_shape_ops=fixed)
    if route == "limb":
        tcfg.set_config(decrypt_engine="limb", encrypt_engine="limb")
    pub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                             KD["randbits"], device=CPU)
    assert (pub._rns_mul_plan() is None) == (route == "limb")
    nsq = KD["n"] ** 2
    rng = random.Random(5)
    cts = [rng.randrange(2, nsq) for _ in EXPS]
    ct = pub.import_cts(cts)
    assert ct.shape[1] == 8
    built = []
    digits = tsch.mg.exponent_digits
    monkeypatch.setattr(tsch.mg, "exponent_digits", lambda *a: built.append(
        digits(*a)) or built[-1])
    profiling.COUNTERS.update(dict.fromkeys(profiling.COUNTERS, 0))
    with profile(activities=[ProfilerActivity.CPU]):
        out = pub.mul_pt(ct, EXPS)
    # the host builds digits for exactly the windows the route runs; no
    # decrypt chain (K2) is counted
    assert [d.size for d in built] == [run]
    assert profiling.COUNTERS == {"exp_columns": 8, "exp_windows_run": run,
                                  "exp_windows_needed": 15,
                                  "sched_launches": 0, "sched_ctas": 0,
                                  "sched_sm_slots": 0, "align_launches": 0,
                                  "align_columns": 0,
                                  "align_squarings_needed": 0,
                                  "align_squarings_run": 0}
    assert pub.export_cts(out, 5) == [pow(c, e, nsq)
                                      for c, e in zip(cts, EXPS)]
