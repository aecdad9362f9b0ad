"""The 4096-bit decrypt's plan on the CPU, in seconds: K2's SM-fill
counter (``profiling.count_sched``: its arithmetic, its profiler gate,
its call at each launch of K2's CUDA wrapper, one- or two-half, and the
cell's reader over it), the two-half launch's operands, the CRT decrypt at the
256-bit test key under the 4096-bit key's chain window against the
default window and the plain reference's floats, and the host constants
of a 4096-bit key: the chain's window and the comb's shrink.

No 2048-bit exponent chain runs through a twin here: the 4096-bit key's
constants are computed on the host only."""

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import rns as tr
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk
from pailliercryptolib_python_tpu_torch.utils import config as tcfg
from pailliercryptolib_python_tpu_torch.utils import profiling

from portbench import reference as ref

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED = ("sched_launches", "sched_ctas", "sched_sm_slots")


def _config(*path):
    with open(os.path.join(ROOT, "portbench", *path)) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _restore_counters():
    saved = dict(profiling.COUNTERS)
    yield
    profiling.COUNTERS.update(saved)


def _sched_counts():
    return tuple(profiling.COUNTERS[k] for k in SCHED)


def _zero_sched():
    for k in SCHED:
        profiling.COUNTERS[k] = 0


@pytest.fixture(scope="module")
def key256():
    return _config("tests", "data", "paillier_256.json")["key"]


@pytest.mark.parametrize("columns, sms, ctas, slots", [
    (256, 132, 8, 132),          # the 4096-bit cell: 8 of 132 SMs
    (10240, 132, 320, 396),      # the 3072-bit cell: three waves
    (1, 132, 1, 132),
    (4096, 132, 128, 132),
    (4225, 132, 133, 264),       # one CTA past a wave takes a second
])
def test_count_sched_under_a_profiler(columns, sms, ctas, slots):
    _zero_sched()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_sched(columns, sms)
    assert _sched_counts() == (1, ctas, slots)


def test_count_sched_counts_nothing_without_a_profiler():
    _zero_sched()
    profiling.count_sched(256, 132)
    profiling.count_sched(10240, 132)
    assert _sched_counts() == (0, 0, 0)


def test_k2_wrapper_counts_each_launch(key256, monkeypatch):
    """``_rns_exp_sched_launch`` counts each one-half launch with the
    card's SM count, here with the launch itself replaced (no card)."""
    launched = []
    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *a: launched.append((name, a[-1])))
    monkeypatch.setattr(trk, "_sm_count", lambda index: 132)
    psq = key256["p"] ** 2
    base = tr.RnsBase.for_bits(tsch._rns_mbits(psq.bit_length()), CPU)
    key = tr.RnsModulus.build(base, psq,
                              tsch.limbs_for_bits(psq.bit_length() + 2))
    sched = tr.sliding_schedule(77, 3, 7)
    X = torch.zeros((base.CH, 256), dtype=torch.int32)
    _zero_sched()
    sched = torch.from_numpy(sched)
    trk._rns_exp_sched_launch((X,), (sched,), base, (key,), 3)
    assert _sched_counts() == (0, 0, 0)         # no profiler: no count
    with profile(activities=[ProfilerActivity.CPU]):
        trk._rns_exp_sched_launch((X,), (sched,), base, (key,), 3)
        trk._rns_exp_sched_launch((X[:, :33],), (sched,), base, (key,), 3)
    assert launched == [("rns_exp_sched", 256)] * 2 + [("rns_exp_sched", 33)]
    assert _sched_counts() == (2, 8 + 2, 132 + 132)


def test_count_sched_for_a_pair_launch():
    """One launch over both CRT halves counts once, with 2 x ceil(B/32)
    CTAs: at B=256 a half, 16 CTAs in one wave of 132 slots."""
    _zero_sched()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_sched(256, 132, 2)
    assert _sched_counts() == (1, 16, 132)
    _zero_sched()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_sched(10240, 132, 2)   # the 3072-bit cell: 5 waves
        profiling.count_sched(33, 132, 2)      # a ragged tile in each half
    assert _sched_counts() == (2, 640 + 4, 660 + 132)


def test_sm_fill_reader_reads_pair_launches():
    """The cell's reader (``portbench/metrics/decrypt_sm_fill_pct.py``,
    loaded as the harness loads it) over 16 pair launches of 16 CTAs:
    12.12% of the SM slots, twice the one-half launches' 6.06%."""
    from portbench import run as R
    read = R.load_reader("decrypt_sm_fill_pct")
    _zero_sched()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(16):
            profiling.count_sched(256, 132, 2)
    assert _sched_counts() == (16, 16 * 16, 16 * 132)
    traced = types.SimpleNamespace(trace=object())
    assert read(traced) == pytest.approx(100 * 16 / 132)
    assert round(read(traced), 2) == 12.12


def test_k2_pair_launch_hands_each_half_its_operands(key256, monkeypatch):
    """``_rns_exp_sched_launch`` over both halves, with the launch
    replaced by the plain twin of each half read from the argument list
    in ``pct_rns_exp_sched``'s order (no card): each half gets its own
    state, schedule, output and constants, the scratch table holds
    halves x tiles tiles, and the counter sees one launch of 2 x 2
    CTAs at B=33."""
    launched = []
    p2, q2 = key256["p"] ** 2, key256["q"] ** 2
    base = tr.RnsBase.for_bits(tsch._rns_mbits(p2.bit_length()), CPU)
    L = tsch.limbs_for_bits(max(p2, q2).bit_length() + 2)
    kp, kq = (tr.RnsModulus.build(base, m, L) for m in (p2, q2))
    by_vec = {id(trk.kernel_operands(base, k, CPU)["vec"]): k
              for k in (kp, kq)}

    def fake_launch(name, *a):
        (x0, x1, s0, s1, n_ops, o0, o1, tab, v0, v1, c0, c1, W1, W2, k, CH,
         KP, nlev, window, halves, B) = a
        launched.append((name, n_ops, halves, B, tab.shape[0]))
        for x, s, o, v in ((x0, s0, o0, v0), (x1, s1, o1, v1))[:halves]:
            o.copy_(tr.rns_exp_sched(x, s, base, by_vec[id(v)], window))

    monkeypatch.setattr(kernels, "require_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "launch", fake_launch)
    monkeypatch.setattr(trk, "_sm_count", lambda index: 132)
    rng = np.random.default_rng(24)
    mods = base.mods.numpy().reshape(-1, 1)
    Xp, Xq = (torch.from_numpy((rng.integers(0, 1 << 16, (base.CH, 33))
                                % mods).astype(np.int32)) for _ in range(2))
    sp, sq = (torch.from_numpy(tr.sliding_schedule(e, 3, 7))
              for e in (77, 100))
    _zero_sched()
    with profile(activities=[ProfilerActivity.CPU]):
        Zp, Zq = trk._rns_exp_sched_launch((Xp, Xq), (sp, sq), base,
                                           (kp, kq), 3)
    assert launched == [("rns_exp_sched", len(sp), 2, 33, 2 * 2)]
    assert _sched_counts() == (1, 2 * 2, 132)
    assert torch.equal(Zp, tr.rns_exp_sched(Xp, sp, base, kp, 3))
    assert torch.equal(Zq, tr.rns_exp_sched(Xq, sq, base, kq, 3))
    assert not torch.equal(Zp, Zq)


def _decrypt(k, monkeypatch, window):
    """(values, floats, private context) of a seeded B=8 decrypt at the
    256-bit key, K2's chain at `window` (None: the port's own plan)."""
    if window is not None:
        monkeypatch.setattr(trk, "plan_sched", lambda CH: window)
    ipub = tpt.ipclPublicKey(k["n"], k["bits"], True, k["hs"],
                             k["randbits"], device=CPU)
    pk = tpt.PaillierPublicKey(ipub)
    sk = tpt.PaillierPrivateKey(pk, k["p"], k["q"])
    x = np.random.default_rng(4096).normal(0.0, 100.0, 8)
    got = np.asarray(sk.decrypt(pk.encrypt(x)), dtype=np.float64)
    monkeypatch.undo()
    return x, got, sk.prikey.context


def test_decrypt_at_the_4096_bit_window_equals_the_reference(key256,
                                                             monkeypatch):
    """The same ciphertexts decrypted with K2's chain (its twin here) at
    window 3, the 4096-bit key's, and at the port's own plan for this
    key: both give the reference's floats bit for bit."""
    x, at3, ctx3 = _decrypt(key256, monkeypatch, 3)
    _, default, ctx = _decrypt(key256, monkeypatch, None)
    m, e = ref.encode(x)
    want = np.asarray([ref.decode(a, b) for a, b in zip(m, e)])
    assert np.array_equal(at3, want)
    assert np.array_equal(default, want)
    assert ctx3.rns_sched_window == 3
    assert ctx.rns_sched_window == trk.plan_sched(ctx.rns_base.CH) != 3
    assert len(ctx3.rsched_p) > len(ctx.rsched_p)


def test_4096_bit_plan_constants_on_the_host(monkeypatch):
    """At a 4096-bit key: p^2's RNS base has 519 channels, where the chain
    falls to window 3 (6 at 261, 4 at 389); the RNS comb shrinks from
    the card's window 12 to 11 under the default budget."""
    assert trk.plan_sched(261) == 6
    assert trk.plan_sched(389) == 4
    half = tr.RnsBase.for_bits(tsch._rns_mbits(4096), CPU)
    assert half.CH == 519
    assert trk.plan_sched(half.CH) == 3
    k = _config("configs", "paillier_4096.json")["key"]
    cfg = tcfg.get_config()
    monkeypatch.setattr(cfg, "comb_hbm_budget_bytes", 4 << 30)  # default
    monkeypatch.setattr(cfg, "comb_window_cpu", cfg.comb_window_tpu)
    pub = tsch.PublicContext(k["n"], k["bits"], True, k["hs"],
                             k["randbits"], device=CPU)
    CH = pub.rns_plan()[0].CH
    n_win = -(-pub.randbits // pub.comb_window)
    assert (cfg.comb_window_tpu, pub.L, CH) == (12, 513, 1039)
    assert (pub.comb_window, n_win) == (11, 187)
    assert n_win * CH * (1 << pub.comb_window) * 4 == 1_591_648_256
    assert 171 * CH * (1 << 12) * 4 > cfg.comb_hbm_budget_bytes // 2
