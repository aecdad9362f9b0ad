"""The port's per-element-moduli Montgomery layer against the JAX package
on the CPU: ``MontCtx.for_moduli``, the plain twins of kernels K9
(``mont_mul_p``) and K10 (``mont_exp_p``) against the Pallas kernels
``pallas_mont.mont_mul_p`` / ``mont_exp_p`` in interpret mode and against
Python ``pow``, and the dispatch of contexts without mm3 weights.

Montgomery products have a unique output, so limbs must be equal."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont as jpm
from pailliercryptolib_python_tpu_torch.ops import mont as tmont
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_for_bits,
                                                         limbs_to_ints)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpm, "INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = (port.numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _odd(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _contexts(ns, L, shared):
    """(JAX, port) contexts: per-element over ns, or, shared, one (L, 1)
    modulus with n0 (1,) in JAX and an int in the port (the wrappers
    broadcast it)."""
    if shared:
        return (jmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L),
                tmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L,
                                        device=CPU))
    return jmg.MontCtx.for_moduli(ns, L), tmg.MontCtx.for_moduli(ns, L, CPU)


def _moduli(rng, bits, B, shared):
    return [_odd(rng, bits)] * B if shared else [_odd(rng, bits)
                                                  for _ in range(B)]


@pytest.mark.parametrize("bits,B,shared", [(192, 8, False), (192, 8, True),
                                           (96, 256, False)],
                         ids=["per-element", "shared", "two-tiles"])
def test_k9_twin_matches_pallas_and_pow(bits, B, shared):
    rng = random.Random(bits + B + shared)
    ns = _moduli(rng, bits, B, shared)
    L = limbs_for_bits(bits + 2)
    jctx, tctx = _contexts(ns, L, shared)
    xs = [rng.randrange(2 * n) for n in ns]
    ys = [rng.randrange(2 * n) for n in ns]
    a, b = ints_to_limbs(xs, L), ints_to_limbs(ys, L)
    ref = jpm.mont_mul_p(jnp.asarray(a), jnp.asarray(b), jctx.n_limbs,
                         jctx.n0inv)
    got = tmont.mont_mul_p(_t(a), _t(b), tctx.n_limbs, tctx.n0inv)
    _same(got, ref)
    R = 1 << (LIMB_BITS * L)
    for g, x, y, n in zip(limbs_to_ints(got), xs, ys, ns):
        assert g < 2 * n and g % n == x * y * pow(R, -1, n) % n


@pytest.mark.parametrize("shared,win_start", [(False, 0), (False, 3),
                                              (True, 2)],
                         ids=["per-element", "per-element-ws3", "shared-ws2"])
def test_k10_twin_matches_pallas_and_pow(shared, win_start):
    rng = random.Random(40 + win_start)
    B, bits, n_win = 8, 160, 9
    ns = _moduli(rng, bits, B, shared)
    L = limbs_for_bits(bits + 2)
    R = 1 << (LIMB_BITS * L)
    jctx, tctx = _contexts(ns, L, shared)
    xs = [rng.randrange(n) for n in ns]
    es = [rng.getrandbits(4 * (n_win - win_start)) for _ in range(B - 2)]
    es += [0, 1]
    base = ints_to_limbs([x * R % n for x, n in zip(xs, ns)], L)
    dig = jmg.exponent_digits(es, n_win, 4)
    ref = jpm.mont_exp_p(jnp.asarray(base), jnp.asarray(dig), jctx.n_limbs,
                         jctx.n0inv, jctx.one, win_start=win_start)
    got = tmont.mont_exp_p(_t(base), dig, tctx.n_limbs, tctx.n0inv,
                           tctx.one, win_start)
    _same(got, ref)
    # the plain twin directly, and the dispatcher on a weightless context
    _same(tmont.mont_exp_plain(_t(base), _t(dig), tctx.n_limbs, tctx.n0inv,
                               tctx.one, win_start), ref)
    _same(tmg.mont_exp(_t(base), dig, tctx, 4, win_start), ref)
    for g, x, e, n in zip(limbs_to_ints(got), xs, es, ns):
        assert g % n == pow(x, e, n) * R % n


@pytest.mark.parametrize("bits", [64, 192, 1100])
def test_for_moduli_matches_jax(bits):
    rng = random.Random(bits)
    ns = [_odd(rng, bits) for _ in range(5)]
    L = limbs_for_bits(bits + 2)
    jctx = jmg.MontCtx.for_moduli(ns, L)
    tctx = tmg.MontCtx.for_moduli(ns, L, CPU)
    for f in ("n_limbs", "n0inv", "r2", "one"):
        _same(getattr(tctx, f), getattr(jctx, f))
    assert tctx.wmu is None and tctx.n0inv.shape == (5,)
    # from_arrays keeps a (B,) n0inv whole, a (1,) one becomes an int
    back = tmg.MontCtx.from_arrays({f: np.asarray(getattr(jctx, f)) for f in
                                    ("n_limbs", "n0inv", "r2", "one")}, CPU)
    _same(back.n0inv, jctx.n0inv)
    one = tmg.MontCtx.from_arrays({f: np.asarray(getattr(
        jmg.MontCtx.for_modulus(ns[0]), f)) for f in
        ("n_limbs", "n0inv", "r2", "one")}, CPU)
    assert isinstance(one.n0inv, int)
    # Walter's bound: 4n < R, as the JAX package requires
    big = (1 << (LIMB_BITS * L - 2)) + 1
    with pytest.raises(ValueError, match="too large"):
        tmg.MontCtx.for_moduli(ns + [big], L, CPU)
    with pytest.raises(ValueError, match="too large"):
        jmg.MontCtx.for_moduli(ns + [big], L)


def test_per_element_products_match_jax():
    """The JAX package's test_per_element_moduli case through both
    dispatchers: products, and a shared exponent over distinct moduli."""
    rng = random.Random(97)
    ns = [_odd(rng, 192) for _ in range(4)]
    L = limbs_for_bits(194)
    jctx = jmg.MontCtx.for_moduli(ns, L)
    tctx = tmg.MontCtx.for_moduli(ns, L, CPU)
    xs = [rng.randrange(n) for n in ns]
    ys = [rng.randrange(n) for n in ns]
    a, b = ints_to_limbs(xs, L), ints_to_limbs(ys, L)
    jam, jbm = jmg.to_mont(jnp.asarray(a), jctx), jmg.to_mont(jnp.asarray(b),
                                                              jctx)
    tam, tbm = tmg.to_mont(_t(a), tctx), tmg.to_mont(_t(b), tctx)
    _same(tam, jam)
    prod = tmg.mont_mul(tam, tbm, tctx)
    _same(prod, jmg.mont_mul(jam, jbm, jctx))
    _same(tmg.from_mont(prod, tctx), jmg.from_mont(jmg.mont_mul(jam, jbm,
                                                                jctx), jctx))
    assert limbs_to_ints(tmg.from_mont(prod, tctx)) == \
        [x * y % n for x, y, n in zip(xs, ys, ns)]
    e = rng.getrandbits(64)
    digits = jmg.exponent_digits([e], 16, 4)[:, 0]
    got = tmg.mont_exp_shared(tam, digits, tctx, window=4)
    _same(got, jmg.mont_exp_shared(jam, jnp.asarray(digits), jctx, window=4))
    assert limbs_to_ints(tmg.from_mont(got, tctx)) == \
        [pow(x, e, n) for x, n in zip(xs, ns)]
    # the wide reduction over per-element moduli
    T = ints_to_limbs([rng.randrange(n << 32) for n in ns], L + 2)
    _same(tmg.mont_reduce_wide(_t(T), tctx, iters=2),
          jmg.mont_reduce_wide(jnp.asarray(T), jctx, iters=2))


def test_weightless_dispatch_and_refusals():
    """A weightless context's products and chains go through ops/mont.py
    (K9/K10 on CUDA, the plain twins here); tensors that are neither on
    the CPU nor on CUDA, digits not on the host, and L past the kernels'
    limit are refused, never moved."""
    rng = random.Random(3)
    m = _odd(rng, 300)
    wctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    pctx = tmg.MontCtx.for_modulus(m, device=CPU)
    assert pctx.wmu is None
    L = pctx.num_limbs
    a = _t(ints_to_limbs([rng.randrange(2 * m) for _ in range(6)], L))
    b = _t(ints_to_limbs([rng.randrange(2 * m) for _ in range(6)], L))
    _same(tmg.mont_mul(a, b, pctx), tmg.mont_mul(a, b, wctx))   # K9 == K3
    dig = jmg.exponent_digits([rng.getrandbits(20) for _ in range(6)], 6, 4)
    _same(tmg.mont_exp(a, dig, pctx, 4, 1), tmg.mont_exp(a, dig, wctx, 4, 1))
    meta = torch.zeros((L, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tmont.mont_mul_p(meta, meta, pctx.n_limbs, pctx.n0inv)
    with pytest.raises(ValueError):
        tmont.mont_exp_p(meta, dig[:, :2], pctx.n_limbs, pctx.n0inv,
                         pctx.one)
    with pytest.raises(ValueError, match="host"):
        tmont.mont_exp_p(a, torch.zeros((3, 6), dtype=torch.int32,
                                        device="meta"),
                         pctx.n_limbs, pctx.n0inv, pctx.one)
    with pytest.raises(ValueError, match="2\\^4"):
        tmont.mont_exp_p(a, dig + 16, pctx.n_limbs, pctx.n0inv, pctx.one)
    with pytest.raises(ValueError, match="limbs"):
        tmont._mont_mul_cuda(torch.zeros((tmont.MAX_LIMBS + 1, 1),
                                         dtype=torch.int32), a, pctx.n_limbs,
                             pctx.n0inv)
