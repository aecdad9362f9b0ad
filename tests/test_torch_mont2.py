"""The port's ``ops/matmul_mont.py`` and the plain twins of kernels
K12-K15 (``ops/mont2.py``) against the JAX package: its
``matmul_mont`` module, and its Pallas kernels ``pallas_mont2.mm2_*_p``
in interpret mode on the CPU.  Inputs come from seeded generators; a
Montgomery result (T + q*m)/R is unique, so every comparison is exact
(tolerance 0), also against the mm3 twins on the same inputs."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import matmul_mont as jmm
from pailliercryptolib_python_tpu.ops import pallas_mont2 as jpm2
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.ops import matmul_mont as tmm
from pailliercryptolib_python_tpu_torch.ops import mont2 as tm2
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_for_bits,
                                                         limbs_to_ints)

CPU = torch.device("cpu")
B = 4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpm2, "INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = (port.numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _case(bits, seed, top=True):
    """(m, L, R, JAX context, port context, xs, ys, a, b): an odd modulus
    of `bits` bits and B values below 2m each (2m - 1 and 0 first)."""
    rng = random.Random(seed)
    m = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    L = limbs_for_bits(bits + 2)
    xs = [rng.randrange(2 * m) for _ in range(B)]
    ys = [rng.randrange(2 * m) for _ in range(B)]
    if top:
        xs[0], xs[1] = 2 * m - 1, 0
    return (m, L, 1 << (LIMB_BITS * L), jmm.MatmulMontCtx(m, L),
            tmm.MatmulMontCtx(m, L, device=CPU), xs, ys,
            ints_to_limbs(xs, L), ints_to_limbs(ys, L))


# ---------------------------------------------------------------------------
# ops/matmul_mont.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [256, 1024])
def test_weights_blocks_and_context_match_jax(bits):
    m, L, _, jc, tc, xs, _, a, _ = _case(bits, bits)
    rng = random.Random(bits + 1)
    C = rng.getrandbits(bits - 8) | 1
    for args in ((C, L, 4, L), (C, L, 4, 2 * L), (C, L, 2, L)):
        _same(tmm.const_mult_weights(*args), jmm.const_mult_weights(*args))
    _same(tc.W_mu, jc.W_mu)
    _same(tc.W_m, jc.W_m)
    _same(tc.m_limbs, jc.m_limbs)
    assert tc.W_mu.dtype == torch.int8 and tc.W_m.dtype == torch.int8
    assert tc.W_mu.shape == (4 * L, 4 * L) and tc.W_m.shape == (8 * L, 4 * L)
    assert (tc.m, tc.L, tc.mu) == (jc.m, jc.L, jc.mu)
    nb = tmm.nibble_blocks(_t(a), 4)
    _same(nb, jmm.nibble_blocks(jnp.asarray(a), 4))
    assert nb.dtype == torch.int8
    y = np.random.default_rng(bits).integers(0, 900 * L, size=(8 * L, B))
    _same(tmm.recombine_blocks(_t(y), 2 * L),
          jmm.recombine_blocks(jnp.asarray(y.astype(np.int32)), 2 * L))


def test_from_arrays_equals_own_build():
    m, L, _, jc, tc, *_ = _case(512, 3)
    got = tmm.MatmulMontCtx.from_arrays(
        {k: np.asarray(getattr(jc, k)) for k in ("W_mu", "W_m", "m_limbs")},
        device=CPU)
    assert (got.m, got.L, got.mu) == (tc.m, tc.L, tc.mu)
    for k in ("W_mu", "W_m", "m_limbs"):
        assert torch.equal(getattr(got, k), getattr(tc, k))
        assert getattr(got, k).dtype == getattr(tc, k).dtype


@pytest.mark.parametrize("bits", [64, 192, 512, 1024])
def test_mont_mul_mm_matches_jax(bits):
    m, L, R, jc, tc, xs, ys, a, b = _case(bits, 10 + bits)
    got = tmm.mont_mul_mm(_t(a), _t(b), tc)
    _same(got, jmm.mont_mul_mm(jnp.asarray(a), jnp.asarray(b), jc))
    Rinv = pow(R, -1, m)
    for g, x, y in zip(limbs_to_ints(got), xs, ys):
        assert g < 2 * m and g % m == x * y * Rinv % m


def test_mont_mul_mm_chain_stays_bounded():
    m, L, R, jc, tc, xs, _, a, _ = _case(256, 20)
    acc, jacc, oracle = _t(a), jnp.asarray(a), list(xs)
    Rinv = pow(R, -1, m)
    for _ in range(20):
        acc = tmm.mont_mul_mm(acc, acc, tc)
        jacc = jmm.mont_mul_mm(jacc, jacc, jc)
        oracle = [x * x * Rinv % m for x in oracle]
    _same(acc, jacc)
    for g, o in zip(limbs_to_ints(acc), oracle):
        assert g < 2 * m and g % m == o


# ---------------------------------------------------------------------------
# ops/mont2.py: the plain twins of K12-K15
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [256, 3088], ids=["L17", "L194"])
def test_mm2_mul_and_sqr_twins_match_pallas(bits):
    m, L, R, jc, tc, xs, ys, a, b = _case(bits, 30 + bits)
    assert (L > jpm2.PRESHIFT_MAX_L) == (bits == 3088)
    got = tm2.mm2_mul(_t(a), _t(b), tc.W_mu, tc.W_m)
    _same(got, jpm2.mm2_mul_p(jnp.asarray(a), jnp.asarray(b), jc.W_mu,
                              jc.W_m))
    _same(got, tm2.mm2_mul_plain(_t(a), _t(b), tc.W_mu, tc.W_m))
    sq = tm2.mm2_sqr(_t(a), tc.W_mu, tc.W_m)
    _same(sq, jpm2.mm2_sqr_p(jnp.asarray(a), jc.W_mu, jc.W_m))
    _same(sq, tm2.mm2_mul(_t(a), _t(a), tc.W_mu, tc.W_m))
    Rinv = pow(R, -1, m)
    for g, s, x, y in zip(limbs_to_ints(got), limbs_to_ints(sq), xs, ys):
        assert g < 2 * m and g % m == x * y * Rinv % m
        assert s < 2 * m and s % m == x * x * Rinv % m


def _mont_base(m, L, R, xs):
    base = ints_to_limbs([x % m * R % m for x in xs], L)
    one = ints_to_limbs([R % m], L)
    return base, one


def test_twins_equal_the_mm3_twins():
    """K12-K15's twins equal K3 / K8 / K4 / K7's on the same inputs: the
    cross-check the smoke run makes between the kernels on the card."""
    m, L, R, _, tc, xs, _, a, b = _case(256, 60)
    ctx3 = tmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=True,
                                   device=CPU)
    assert ctx3.num_limbs == L
    w3 = (ctx3.wmu, ctx3.wm, ctx3.off1, ctx3.off2)
    _same(tm2.mm2_mul_plain(_t(a), _t(b), tc.W_mu, tc.W_m),
          tm3.mm3_mul_plain(_t(a), _t(b), *w3))
    _same(tm2.mm2_sqr_plain(_t(a), tc.W_mu, tc.W_m),
          tm3.mm3_sqr_plain(_t(a), *w3))
    base, _ = _mont_base(m, L, R, xs)
    dig = _t(np.random.default_rng(61).integers(0, 16, size=(5, B)))
    _same(tm2.mm2_exp_plain(_t(base), dig, tc.W_mu, tc.W_m, ctx3.one, 1),
          tm3.mm3_exp_plain(_t(base), dig, *w3, ctx3.one, 1))
    sdig = _t(np.random.default_rng(62).integers(0, 32, size=4))
    _same(tm2.mm2_exp_shared_plain(_t(base), sdig, tc.W_mu, tc.W_m,
                                   ctx3.one, 5),
          tm3.mm3_exp_shared_plain(_t(base), sdig, *w3, ctx3.one, 5))


def test_cpu_wrappers_route_to_twins(monkeypatch):
    """On CPU tensors the wrappers run the twins and launch nothing; a
    digit outside [0, 2^w) raises, and so do digits on a device."""
    def no_launch(*args):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(kernels, "launch", no_launch)
    m, L, R, _, tc, xs, _, a, b = _case(256, 70)
    w = (tc.W_mu, tc.W_m)
    _same(tm2.mm2_mul(_t(a), _t(b)[:, :1], *w),
          tm2.mm2_mul_plain(_t(a), _t(b)[:, :1], *w))
    _same(tm2.mm2_sqr(_t(a), *w), tm2.mm2_sqr_plain(_t(a), *w))
    base, one = _mont_base(m, L, R, xs)
    dig = np.random.default_rng(71).integers(0, 16, size=(3, B))
    _same(tm2.mm2_exp(_t(base), dig, *w, _t(one)),
          tm2.mm2_exp_plain(_t(base), _t(dig), *w, _t(one)))
    sdig = np.array([3, 0, 31], dtype=np.int32)
    _same(tm2.mm2_exp_shared(_t(base), sdig, *w, _t(one), 5),
          tm2.mm2_exp_shared_plain(_t(base), _t(sdig), *w, _t(one), 5))
    with pytest.raises(ValueError, match="outside"):
        tm2.mm2_exp(_t(base), dig + 16, *w, _t(one))
    with pytest.raises(ValueError, match="outside"):
        tm2.mm2_exp_shared(_t(base), sdig, *w, _t(one), 4)
    with pytest.raises(ValueError, match="on the host"):
        tm2.mm2_exp(_t(base), torch.zeros((3, B), device="meta"), *w,
                    _t(one))
    with pytest.raises(ValueError, match="on the host"):
        tm2.mm2_exp_shared(_t(base), torch.zeros(3, device="meta"), *w,
                           _t(one), 5)
