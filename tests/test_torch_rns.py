"""The port's RNS engine (ops/rns.py, ops/rns_kernels.py: the plain twins
of kernels K1 and K2 and their operand packing) against the JAX package
on the CPU: every host constant, every state, limb for limb."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import rns as jr
from pailliercryptolib_python_tpu.ops import pallas_rns as jpr
from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
from pailliercryptolib_python_tpu_torch.ops import rns as tr
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (
    LIMB_BITS, ints_to_limbs)

CPU = torch.device("cpu")
KD = fixed_key_ints(256)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpr, "INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = (port.cpu().numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _setup(mbits, m):
    """Both packages' (base, key, sq_ctx) for modulus m at base mbits."""
    L = (m.bit_length() + 2 + 15) // 16
    jsq = jmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=False)
    tsq = tmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=True,
                                  device=CPU)
    jb = jr.RnsBase.for_bits(mbits)
    tb = tr.RnsBase.for_bits(mbits, CPU)
    return (jb, jr.RnsModulus.build(jb, m, L), jsq,
            tb, tr.RnsModulus.build(tb, m, L), tsq, L)


CASES = [(256, KD["p"] ** 2), (576, KD["n"] ** 2),
         (2048, fixed_key_ints(2048)["p"] ** 2)]


@pytest.mark.parametrize("mbits,m", CASES, ids=["256", "576", "2048"])
def test_host_constants(mbits, m):
    jb, jk, _, tb, tk, _, L = _setup(mbits, m)
    assert (tb.k, tb.M, tb.Mp, tb.m_r, tb.mods_B_int, tb.mods_Bp_int) == (
        jb.k, jb.M, jb.Mp, jb.m_r, jb.mods_B_int, jb.mods_Bp_int)
    for f in tr._BASE_ARRAYS:
        _same(getattr(tb, f), getattr(jb, f))
    for f in tr.KEY_ARRAYS:
        _same(getattr(tk, f), getattr(jk, f))
    jp, tp = jpr.pack(mbits, m), trk.pack(mbits, m)
    for f in ("vec", "skc", "E1", "E2"):
        _same(tp[f], jp[f])
    assert tp["CHP"] == jp["CHP"]
    Lh = L
    for port, ref in zip(tr._residue_planes_np(m, Lh, 2 * Lh + 1),
                         jr._residue_planes_np(m, Lh, 2 * Lh + 1)):
        _same(port, ref)
    for port, ref in zip(tr._enter_planes_np(mbits, L),
                         jr._enter_planes_np(mbits, L)):
        _same(port, ref)
    assert tr.combine_levels(mbits) == jr.combine_levels(mbits)
    assert tr.exit_redc_iters(tb, L) == jr.exit_redc_iters(jb, L)
    assert trk.plan_sched(tb.CH) == jpr.plan_sched(jb.CH)


def test_unpack_layout_matches_base_and_key():
    """The vec/skc/E columns the CUDA kernels read hold the base and key
    vectors at the rows the kernels expect."""
    mbits, m = CASES[0]
    _, _, _, tb, tk, _, _ = _setup(mbits, m)
    k = tb.k
    (mods, n0, n032, ximul, u5, v5, w9n, w9b, ximulh, skc, E1, CS1, E2,
     CS2) = trk._unpack_c(**{f: trk.pack(mbits, m)[f]
                             for f in ("vec", "skc", "E1", "E2")})
    _same(mods[:tb.CH], tb.mods)
    _same(n0[:tb.CH], tb.n0)
    _same(n032[:tb.CH], tb.n032)
    _same(ximul[:k], tk.K1s)
    _same(ximul[k:2 * k], tb.K2s)
    _same(ximulh[:k], tk.K1sh)
    _same(u5[k:tb.CH], tk.u5)
    _same(v5[k:tb.CH], tk.v5)
    _same(w9n[:k], tk.w9n)
    _same(w9b[:k], tk.w9b)
    _same(skc[:2], tb.exit_c[:2])
    assert E1.shape == E2.shape == (4 * (k + 1), k)
    assert CS1.min() >= 0 and CS1.max() <= 65280 * k


def _states(rng, tb, B):
    mods = tb.mods.numpy()
    return (rng.integers(0, 1 << 16, size=(tb.CH, B)) % mods).astype(
        np.uint32)


@pytest.mark.parametrize("mbits,m", CASES[:2], ids=["256", "576"])
def test_rns_mont_mul(mbits, m):
    jb, jk, _, tb, tk, _, L = _setup(mbits, m)
    rng = np.random.default_rng(mbits)
    X, Y = _states(rng, tb, 9), _states(rng, tb, 9)
    got = tr.rns_mont_mul(_t(X), _t(Y), tb, tk)
    _same(got, jr.rns_mont_mul(jnp.asarray(X), jnp.asarray(Y), jb, jk))
    _same(got, jpr.rns_mul_p(jnp.asarray(X), jnp.asarray(Y), jb, jk))
    _same(trk.rns_mul(_t(X), _t(Y), tb, tk), got)   # CPU wrapper -> plain


@pytest.mark.parametrize("mbits,m,window,ebits",
                         [(256, KD["p"] ** 2, 5, None),
                          (576, KD["n"] ** 2, 4, 40)], ids=["256", "576"])
def test_rns_exp_sched_and_crt_half(mbits, m, window, ebits):
    jb, jk, jsq, tb, tk, tsq, L = _setup(mbits, m)
    rng = random.Random(mbits)
    R = 1 << (LIMB_BITS * L)
    e = KD["p"] - 1 if ebits is None else rng.getrandbits(ebits) | 1
    sched = jr.sliding_schedule(e, window, e.bit_length())
    assert np.array_equal(tr.sliding_schedule(e, window, e.bit_length()),
                          sched)
    assert tr.sched_len(e.bit_length(), window) == len(sched)
    cs = [rng.randrange(m) for _ in range(9)]
    v = ints_to_limbs([c * R % m for c in cs], L)
    X = tr.rns_enter(_t(v), tb, tk)
    jX = jr.rns_enter(jnp.asarray(v), jb, jk)
    _same(X, jX)
    got = trk.rns_exp_sched_p(X, sched, tb, tk, window)
    _same(got, jr.rns_exp_sched(jX, jnp.asarray(sched), jb, jk, window))
    _same(got, jpr.rns_exp_sched_p(jX, jnp.asarray(sched), jb, jk, window))
    _same(tr._exit_limbs(got, tb), jr._exit_limbs(jnp.asarray(
        got.numpy().astype(np.uint32)), jb))
    out = tr.rns_crt_exp_sched(_t(v), sched, tb, tk, tsq, window, L)
    _same(out, jr.rns_crt_exp_sched(jnp.asarray(v), jnp.asarray(sched), jb,
                                    jk, jsq, window, L))
    from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints
    assert limbs_to_ints(out) == [pow(c, e, m) for c in cs]


def test_residue_fold():
    kd = fixed_key_ints(256)
    n2, psq = kd["n"] ** 2, kd["p"] ** 2
    Lh = (psq.bit_length() + 2 + 15) // 16
    K = (n2.bit_length() + 2 + 15) // 16
    rng = random.Random(3)
    T = ints_to_limbs([rng.randrange(2 * n2) for _ in range(7)]
                      + [(1 << (16 * K)) - 1], K)
    C_lo, C_hi = tr._residue_planes_np(psq, Lh, K)
    got = tr.residue_fold_limbs(_t(T), _t(C_lo), _t(C_hi), Lh)
    _same(got, jr.residue_fold_limbs(jnp.asarray(T), jnp.asarray(C_lo),
                                     jnp.asarray(C_hi), Lh))


def _both(fn_name, *arrays):
    """Run a channel primitive in both packages on the same uint32 inputs."""
    port = getattr(tr, fn_name)(*[_t(a) if isinstance(a, np.ndarray) else a
                                  for a in arrays])
    ref = getattr(jr, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in arrays])
    _same(port, ref)


def test_uint32_wrap_boundaries():
    """Each formula that the JAX code runs in wrapping uint32, driven at
    its boundary values: the port's int64 + mask must agree bit for bit."""
    mb = jr.RnsBase.for_bits(2048)
    mods = np.asarray(mb.mods).astype(np.uint32)          # (CH, 1)
    n0 = np.asarray(mb.n0).astype(np.uint32)
    n032 = np.asarray(mb.n032).astype(np.uint32)
    CH = mods.shape[0]
    rng = np.random.default_rng(7)
    top = (mods - 1).astype(np.uint32)                    # largest residues
    a = np.concatenate([top, np.zeros_like(top), rng.integers(
        0, 1 << 16, size=(CH, 4)).astype(np.uint32) % mods], axis=1)
    b = np.concatenate([top, top, rng.integers(
        0, 1 << 16, size=(CH, 4)).astype(np.uint32) % mods], axis=1)
    _both("_cmul", a, b, mods, n0)
    _both("_cmul2", a, b, b, a, mods, n0)
    t = np.concatenate([np.full((CH, 1), 0xFFFFFFFF, np.uint32),
                        np.full((CH, 1), 0xFFFF0000, np.uint32),
                        rng.integers(0, 1 << 32, size=(CH, 4),
                                     dtype=np.uint64).astype(np.uint32)],
                       axis=1)
    _both("_redc", t, mods, n0)
    K1gs, K1gsh = np.asarray(mb.K1gs), np.asarray(mb.K1gsh)
    k = mb.k
    _both("_cmul_shoup", a[:k], K1gs, K1gsh, mods[:k])
    # accumulators at their int32 ceiling: t*n032 and B1*n032 << 16 wrap
    big = (1 << 31) - 1
    cols = [(0, 0, 0), (big, big, big), (big, 0, big), (0, big, 0)]
    S00 = np.array([[c[0] for c in cols]] * CH, dtype=np.int32)
    mid = np.array([[c[1] for c in cols]] * CH, dtype=np.int32)
    S11 = np.array([[c[2] for c in cols]] * CH, dtype=np.int32)
    _both("_combine_planes", S00, mid, S11, mods, n032)
    smax = 2 * k * 255 * 255
    SA = np.array([[0, smax, smax, 1]] * CH, dtype=np.int32)
    SB = np.array([[0, smax, 1, smax]] * CH, dtype=np.int32)
    nlev = jr.combine_levels(2048)
    _both("_combine_dual", SA, SB, mods, n0, nlev)
