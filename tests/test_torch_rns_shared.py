"""The port's fixed-window shared-exponent RNS chain (the plain twin of
kernel K6: ``ops/rns.rns_exp_shared``, ``rns_crt_exp_half``,
``ops/rns_kernels.rns_exp_shared_p``) against the JAX package on the CPU:
its jnp chain, its Pallas kernel ``rns_exp_shared_p`` in interpret mode,
and Python ``pow``.  Every comparison is exact (states and limbs equal).
Also the host-side contract of the schedule / digit operands of K2 and
K6: a tensor that is typed as lying on a device raises; and K2's
two-half entry (``rns_exp_sched_pair``) against its one-half twins."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import rns as jr
from pailliercryptolib_python_tpu.ops import pallas_rns as jpr
from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.ops import rns as tr
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (
    LIMB_BITS, ints_to_limbs, limbs_to_ints)

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
B = 8
MBITS = 256
M = KD["p"] ** 2


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpr, "INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = (port.numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


@pytest.fixture(scope="module")
def setup():
    """Both packages' base, key and p^2 context, B Montgomery-limb
    ciphertext residues and their entered states."""
    L = (M.bit_length() + 2 + 15) // 16
    jsq = jmg.MontCtx.for_modulus(M, min_bits=LIMB_BITS * L, mxu=False)
    tsq = tmg.MontCtx.for_modulus(M, min_bits=LIMB_BITS * L, mxu=True,
                                  device=CPU)
    jb, tb = jr.RnsBase.for_bits(MBITS), tr.RnsBase.for_bits(MBITS, CPU)
    jk, tk = jr.RnsModulus.build(jb, M, L), tr.RnsModulus.build(tb, M, L)
    rng = random.Random(41)
    R = 1 << (LIMB_BITS * L)
    cs = [rng.randrange(M) for _ in range(B)]
    v = ints_to_limbs([c * R % M for c in cs], L)
    X = np.asarray(jr.rns_enter(jnp.asarray(v), jb, jk))
    _same(tr.rns_enter(_t(v), tb, tk), X)
    return dict(jb=jb, jk=jk, jsq=jsq, tb=tb, tk=tk, tsq=tsq, L=L, cs=cs,
                v=v, X=X)


def _digits(e, window, lead=0):
    n_win = -(-max(e.bit_length(), 1) // window) + lead
    return jmg.exponent_digits([e], n_win, window)[:, 0].astype(np.int32)


@pytest.mark.parametrize("window,e,lead", [
    (5, KD["p"] - 1, 0), (3, (7 << 30) | 7, 1)],
    ids=["w5-p-1", "w3-zero-first-and-inner-7-last"])
def test_exp_shared_states_match_jnp_and_pallas(setup, window, e, lead):
    s = setup
    dig = _digits(e, window, lead)
    if lead:
        assert dig[0] == 0 and dig[-1] == (1 << window) - 1
    want = np.asarray(jr.rns_exp_shared(jnp.asarray(s["X"]),
                                        jnp.asarray(dig), s["jb"], s["jk"],
                                        window))
    kern = np.asarray(jpr.rns_exp_shared_p(jnp.asarray(s["X"]),
                                           jnp.asarray(dig), s["jb"],
                                           s["jk"], window))
    assert np.array_equal(kern, want)
    for got in (tr.rns_exp_shared(_t(s["X"]), dig, s["tb"], s["tk"], window),
                trk.rns_exp_shared_p(_t(s["X"]), torch.from_numpy(dig),
                                     s["tb"], s["tk"], window),
                tr.rns_exp_shared_plain(_t(s["X"]), dig, s["tb"], s["tk"],
                                        window)):
        _same(got, want)
    out = tr.rns_exit(_t(want), s["tb"], s["tk"], s["tsq"], s["L"])
    assert limbs_to_ints(out) == [pow(c, e, M) for c in s["cs"]]


def test_crt_exp_half_matches_reference_pow_and_sched(setup):
    s = setup
    window = 5
    e = KD["p"] - 1
    dig = _digits(e, window)
    want = np.asarray(jr.rns_crt_exp_half(
        jnp.asarray(s["v"]), jnp.asarray(dig), s["jb"], s["jk"], s["jsq"],
        window, s["L"]))
    got = tr.rns_crt_exp_half(_t(s["v"]), dig, s["tb"], s["tk"], s["tsq"],
                              window, s["L"])
    _same(got, want)
    assert limbs_to_ints(got) == [pow(c, e, M) for c in s["cs"]]
    sw = 4
    sched = tr.sliding_schedule(e, sw, e.bit_length())
    _same(tr.rns_crt_exp_sched(_t(s["v"]), sched, s["tb"], s["tk"], s["tsq"],
                               sw, s["L"]), want)


def _q_half(setup):
    """The q^2 key at the setup's base, B entered states of ciphertext
    residues mod q^2 and their residues."""
    s = setup
    Q = KD["q"] ** 2
    assert Q.bit_length() <= MBITS
    tq = tr.RnsModulus.build(s["tb"], Q, s["L"])
    rng = random.Random(43)
    R = 1 << (LIMB_BITS * s["L"])
    cs = [rng.randrange(Q) for _ in range(B)]
    X = tr.rns_enter(_t(ints_to_limbs([c * R % Q for c in cs], s["L"])),
                     s["tb"], tq)
    return tq, X, cs


def test_sched_pair_equals_two_one_half_twins(setup):
    """Both CRT halves through the pair entry (its plain twins on the
    CPU) equal the one-half chain of each, state for state, and exit to
    c^(p-1) mod p^2 and c^(q-1) mod q^2."""
    s = setup
    tq, Xq, cq = _q_half(s)
    Xp = _t(s["X"])
    w = 4
    ebits = max((KD["p"] - 1).bit_length(), (KD["q"] - 1).bit_length())
    sp = tr.sliding_schedule(KD["p"] - 1, w, ebits)
    sq = tr.sliding_schedule(KD["q"] - 1, w, ebits)
    assert len(sp) == len(sq) and not np.array_equal(sp, sq)
    Zp, Zq = trk.rns_exp_sched_pair(Xp, Xq, sp, sq, s["tb"], s["tk"], tq, w)
    _same(Zp, tr.rns_exp_sched(Xp, sp, s["tb"], s["tk"], w))
    _same(Zq, tr.rns_exp_sched(Xq, sq, s["tb"], tq, w))
    _same(Zp, trk.rns_exp_sched_p(Xp, sp, s["tb"], s["tk"], w))
    Q = KD["q"] ** 2
    tqsq = tmg.MontCtx.for_modulus(Q, min_bits=LIMB_BITS * s["L"], mxu=True,
                                   device=CPU)
    up = tr.rns_exit(Zp, s["tb"], s["tk"], s["tsq"], s["L"])
    uq = tr.rns_exit(Zq, s["tb"], tq, tqsq, s["L"])
    assert limbs_to_ints(up) == [pow(c, KD["p"] - 1, M) for c in s["cs"]]
    assert limbs_to_ints(uq) == [pow(c, KD["q"] - 1, Q) for c in cq]


def test_sched_pair_raises_on_schedules_of_different_lengths(setup):
    s = setup
    tq, Xq, _ = _q_half(s)
    X = _t(s["X"])
    short, long_ = tr.sliding_schedule(77, 4, 7), tr.sliding_schedule(77, 4, 8)
    with pytest.raises(ValueError, match="schedules of 9 and 10 entries"):
        trk.rns_exp_sched_pair(X, Xq, short, long_, s["tb"], s["tk"], tq, 4)
    with pytest.raises(ValueError, match="out of range"):
        trk.rns_exp_sched_pair(X, Xq, short, np.full(9, 9, np.int32),
                               s["tb"], s["tk"], tq, 4)


class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _typed_cuda(arr):
    return torch.from_numpy(np.asarray(arr)).as_subclass(_OnDevice)


def test_device_schedule_and_digits_raise(setup):
    s = setup
    X = _t(s["X"])
    sched = tr.sliding_schedule(KD["p"] - 1, 4, (KD["p"] - 1).bit_length())
    with pytest.raises(ValueError, match="on the host"):
        trk.rns_exp_sched_p(X, _typed_cuda(sched), s["tb"], s["tk"], 4)
    with pytest.raises(ValueError, match="on the host"):
        trk.rns_exp_shared_p(X, _typed_cuda(_digits(5, 5)), s["tb"], s["tk"],
                             5)
    with pytest.raises(ValueError, match="on the host"):
        kernels.digit_tensor(_typed_cuda(_digits(5, 5)), 5, CPU)


def test_out_of_range_schedule_and_digits_raise(setup):
    s = setup
    X = _t(s["X"])
    with pytest.raises(ValueError, match="out of range"):
        trk.rns_exp_sched_p(X, np.array([0, 9], dtype=np.int32), s["tb"],
                            s["tk"], 4)
    with pytest.raises(ValueError, match="out of range"):
        trk.rns_exp_sched_p(X, torch.tensor([0, -1]), s["tb"], s["tk"], 4)
    with pytest.raises(ValueError, match="outside"):
        trk.rns_exp_shared_p(X, np.array([32], dtype=np.int32), s["tb"],
                             s["tk"], 5)
    # host schedules in either form run the twin and agree
    sched = tr.sliding_schedule(77, 4, 7)
    _same(trk.rns_exp_sched_p(X, sched, s["tb"], s["tk"], 4),
          trk.rns_exp_sched_p(X, torch.from_numpy(sched), s["tb"], s["tk"],
                              4))


def test_cuda_state_goes_to_the_kernel_or_raises(setup, monkeypatch):
    """A state that is not on the CPU never runs the twin: the shared
    chain hands it to the CUDA wrapper (stubbed here: there is no card)."""
    s = setup
    called = []
    monkeypatch.setattr(trk, "_rns_exp_shared_cuda",
                        lambda *a: called.append(a) or "kernel")
    X = _t(s["X"]).as_subclass(_OnDevice)
    monkeypatch.setattr(kernels, "digit_tensor",
                        lambda d, w, dev: torch.from_numpy(np.asarray(d)))
    assert tr.rns_exp_shared(X, _digits(5, 5), s["tb"], s["tk"], 5) == "kernel"
    assert len(called) == 1
