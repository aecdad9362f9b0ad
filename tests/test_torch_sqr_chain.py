"""The plain twins of kernels K8 (``mont3.mm3_sqr``) and K11
(``mont.mont_chain_p``) against the JAX package's Pallas kernels
``pallas_mont3.mm3_sqr_p`` and ``pallas_mont.mont_chain_p`` in interpret
mode on the CPU, against the products they must equal, and against
Python ints.  A Montgomery result (T + q*m)/R is unique, so every
comparison is exact."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont as jpm
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
from pailliercryptolib_python_tpu_torch.ops import mont as tmont
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS, big_mul,
                                                         ints_to_limbs,
                                                         limbs_for_bits,
                                                         limbs_to_ints)

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
B = 8


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpm, "INTERPRET", True)
    monkeypatch.setattr(jpm3, "INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = (port.numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _cols(rng, ms, L):
    """(L, B) limbs of one value below 2m per modulus, the extremes
    first: 2m - 1, 0, 1."""
    vals = [rng.randrange(2 * m) for m in ms]
    vals[0], vals[1], vals[2] = 2 * ms[0] - 1, 0, 1
    return vals, ints_to_limbs(vals, L)


@pytest.mark.parametrize("m", [KD["p"] ** 2, KD["n"] ** 2, KD["p"]],
                         ids=["p2-L17", "n2-L32", "p-L9"])
def test_big_sqr_is_the_square(m):
    L = limbs_for_bits(m.bit_length() + 2)
    vals, a = _cols(random.Random(L), [m] * B, L)
    _same(tm3.big_sqr(_t(a)), big_mul(_t(a), _t(a), out_limbs=2 * L))
    assert limbs_to_ints(tm3.big_sqr(_t(a))) == [v * v for v in vals]


@pytest.mark.parametrize("m", [KD["p"] ** 2, KD["n"] ** 2],
                         ids=["p2-L17", "n2-L32"])
def test_k8_twin_matches_pallas_and_the_product(m):
    L = limbs_for_bits(m.bit_length() + 2)
    ctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    assert ctx.num_limbs == L and ctx.wmu is not None
    w_np = tm3.byte_weights_np(m, L)
    vals, a = _cols(random.Random(7 * L), [m] * B, L)
    got = tm3.mm3_sqr(_t(a), ctx)
    _same(got, jpm3.mm3_sqr_p(jnp.asarray(a), *map(jnp.asarray, w_np),
                              tb=128))
    _same(got, tm3.mm3_sqr_plain(_t(a), ctx.wmu, ctx.wm, ctx.off1, ctx.off2))
    _same(got, tm3.mm3_mul_plain(_t(a), _t(a), ctx.wmu, ctx.wm, ctx.off1,
                                 ctx.off2))
    _same(got, tmg.mont_sqr(_t(a), ctx))
    Rinv = pow(1 << (LIMB_BITS * L), -1, m)
    for g, v in zip(limbs_to_ints(got), vals):
        assert g < 2 * m and g % m == v * v * Rinv % m


def _chain_case(rng, shared, n_win=5):
    bits = 192
    odd = lambda: rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    ns = [odd()] * B if shared else [odd() for _ in range(B)]
    L = limbs_for_bits(bits + 2)
    if shared:
        jctx = jmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L)
        tctx = tmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L,
                                       device=CPU)
    else:
        jctx = jmg.MontCtx.for_moduli(ns, L)
        tctx = tmg.MontCtx.for_moduli(ns, L, CPU)
    _, acc0 = _cols(rng, ns, L)
    fac = np.stack([_cols(rng, ns, L)[1] for _ in range(n_win)], axis=0)
    return ns, L, jctx, tctx, acc0, fac


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "per-element"])
def test_k11_twin_matches_pallas_and_a_product_loop(shared):
    rng = random.Random(11 + shared)
    ns, L, jctx, tctx, acc0, fac = _chain_case(rng, shared)
    want = jpm.mont_chain_p(jnp.asarray(fac), jnp.asarray(acc0),
                            jnp.broadcast_to(jctx.n_limbs, (L, B)),
                            jnp.broadcast_to(jctx.n0inv, (B,)))
    got = tmont.mont_chain_p(_t(fac), _t(acc0), tctx.n_limbs, tctx.n0inv)
    _same(got, want)
    _same(got, tmont.mont_chain_plain(_t(fac), _t(acc0), tctx.n_limbs,
                                      tctx.n0inv))
    acc = _t(acc0)
    for j in range(fac.shape[0]):
        acc = tmont.mont_mul_p(acc, _t(fac[j]), tctx.n_limbs, tctx.n0inv)
    _same(got, acc)
    R = 1 << (LIMB_BITS * L)
    a_int = limbs_to_ints(acc0)
    f_int = [limbs_to_ints(f) for f in fac]
    for b, (g, n) in enumerate(zip(limbs_to_ints(got), ns)):
        want_b = a_int[b]
        for f in f_int:
            want_b = want_b * f[b] * pow(R, -1, n) % n
        assert g < 2 * n and g % n == want_b


@pytest.mark.parametrize("mxu", [False, True], ids=["K9-route", "K3-route"])
def test_fused_chain_equals_fixed_base_on_a_comb(mxu):
    """gather + ``mont_chain_p`` equals the streamed
    ``mont_exp_fixed_base`` limb for limb on a small comb of hs, with and
    without an accumulator to start from, and both equal hs^r."""
    n2 = KD["n"] ** 2
    ctx = tmg.MontCtx.for_modulus(n2, mxu=mxu, device=CPU)
    L = ctx.num_limbs
    R = 1 << (LIMB_BITS * L)
    w, nbits = 4, 16
    hs = KD["hs"]
    lad = _t(ints_to_limbs([pow(hs, 1 << t, n2) * R % n2
                            for t in range(nbits)], L).T[:, :, None])
    comb = tmg.build_comb_table(lad, ctx, w)
    rng = np.random.default_rng(5)
    rs = [int(r) for r in rng.integers(0, 1 << nbits, size=B)]
    rs[0], rs[1] = 0, (1 << nbits) - 1
    digits = np.array([[(r >> (w * j)) & ((1 << w) - 1) for r in rs]
                       for j in range(nbits // w)], dtype=np.uint16)
    acc0 = tmg.to_mont(_t(ints_to_limbs([3 + b for b in range(B)], L)), ctx)
    streamed = tmg.mont_exp_fixed_base(comb, digits, ctx, acc0=acc0)
    fused = tmg.mont_exp_fixed_base_chain(comb, digits, ctx, acc0)
    _same(fused, streamed)
    assert limbs_to_ints(tmg.from_mont(fused, ctx)) == [
        (3 + b) * pow(hs, r, n2) % n2 for b, r in enumerate(rs)]
