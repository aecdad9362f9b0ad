"""The plain twins of kernels K8 (``mont3.mm3_sqr``) and K11
(``mont.mont_chain_p``) against the JAX package's Pallas kernels
``pallas_mont3.mm3_sqr_p`` and ``pallas_mont.mont_chain_p`` in interpret
mode on the CPU, against the products they must equal, and against
Python ints; the twin of K16 (``mont3.mm3_sqr_chain``, d squarings a
listed column) against Python's ``pow`` and a loop of K8's twin, its
wrapper's call into the C library, its shape's width and the host's copy
of the cooperative kernels' (g, K) rule.  A Montgomery
result (T + q*m)/R is unique, so every comparison is exact."""

import dataclasses
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont as jpm
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
from pailliercryptolib_python_tpu_torch import kernels
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


# K16: a column raised to 2^d by d squarings.  The shifts of one batch
# mix 0 (listed, or not listed at all) with long chains.
D_MIX = (0, 1, 2, 15, 27, 64)


def _odd_modulus(rng, L):
    """A random odd modulus that takes L limbs with 4m < R."""
    bits = LIMB_BITS * L - 3
    return rng.getrandbits(bits) | 1 | (1 << (bits - 1))


@pytest.mark.parametrize("L,B", [(257, 7), (513, 6), (257, 1), (17, 13)],
                         ids=["L257-B7", "L513-B6", "L257-B1", "L17-B13"])
def test_k16_twin_matches_pow_and_a_k8_loop(L, B):
    """Unsorted columns, d in D_MIX, B not a multiple of a warp's 4
    columns (g=8 at these small batches, 32 lanes at L=513); the columns
    left out and those with d = 0 come back as they are."""
    rng = random.Random(L * 100 + B)
    m = _odd_modulus(rng, L)
    ctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    assert ctx.num_limbs == L
    vals, a = _cols(rng, [m] * max(B, 3), L)
    vals, a = vals[:B], _t(a[:, :B])
    d = np.array([D_MIX[(5 * i + 1) % len(D_MIX)] for i in range(B)])
    cols = np.array(rng.sample(range(B), B))[:max(1, B - 1)]  # one left out
    got = tm3.mm3_sqr_chain(a, cols, d[cols], ctx)
    assert got.shape == a.shape and got.dtype == a.dtype
    R_inv = pow(1 << (LIMB_BITS * L), -1, m)
    for b, g in enumerate(limbs_to_ints(got)):
        e = 1 << int(d[b]) if b in cols else 1
        assert g < 2 * m and g % m == pow(vals[b], e, m) * pow(
            R_inv, e - 1, m) % m, b
        x = a[:, b:b + 1]
        for _ in range(int(d[b]) if b in cols else 0):
            x = tm3.mm3_sqr_plain(x, ctx.wmu, ctx.wm, ctx.off1, ctx.off2)
        _same(got[:, b:b + 1], x)
    # without the mm3 weights the twin squares by K9's: the same limbs
    bare = tmg.MontCtx.for_modulus(m, mxu=False, device=CPU)
    _same(tm3.mm3_sqr_chain(a, cols, d[cols], bare), got)


class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return t.as_subclass(_OnDevice)


def test_k16_wrapper_passes_its_signature_and_raises(monkeypatch):
    """A CUDA tensor reaches ``pct_mm3_sqr_chain`` with its argument list:
    the (2, C) columns and counts as int32, n0, L, B, C and the chain's
    mean width; the launch counter rises; a launch error raises with no
    twin run; counts of 0 alone launch nothing."""
    calls, sent = [], []

    def twin(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(kernels, "_call",
                        lambda n, conv, dev: calls.append((n, conv)) or 0)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    monkeypatch.setattr(tm3, "h2d", lambda t, dev: sent.append(t) or _fake(t))
    monkeypatch.setattr(tm3, "mm3_sqr_chain_plain", twin)
    m = KD["n"] ** 2
    ctx = tmg.MontCtx.for_modulus(m, device=CPU)
    ctx = dataclasses.replace(ctx, n_limbs=_fake(ctx.n_limbs))
    L = ctx.num_limbs
    a = _fake(_t(_cols(random.Random(16), [m] * B, L)[1]).to(torch.int32))
    cols, d = np.array([5, 0, 2]), np.array([15, 15, 1])
    before = kernels.COUNTS["mm3_sqr_chain"]
    out = tm3.mm3_sqr_chain(a, cols, d, ctx)
    assert out.shape == (L, B) and out.device.type == "cuda"
    assert [n for n, _ in calls] == ["mm3_sqr_chain"]
    conv = calls[0][1]
    assert len(conv) == len(kernels._SIGS["mm3_sqr_chain"]) - 1
    assert conv[4:] == [ctx.n0inv, L, B, 3, 3]     # width ceil(31 / 15)
    assert sent[0].dtype == torch.int32
    assert sent[0].tolist() == [[5, 0, 2], [15, 15, 1]]
    assert kernels.COUNTS["mm3_sqr_chain"] == before + 1
    tm3.mm3_sqr_chain(a, cols, np.zeros(3), ctx)
    assert len(calls) == 1
    monkeypatch.setattr(kernels, "_call", lambda n, c, dev: 1)
    with pytest.raises(RuntimeError, match="mm3_sqr_chain failed to launch"):
        tm3.mm3_sqr_chain(a, cols, d, ctx)
    assert kernels.COUNTS["mm3_sqr_chain"] == before + 2


@pytest.mark.parametrize("cols,d", [([0, 0], [1, 2]), ([0, 5], [1, 1]),
                                    ([-1], [1]), ([1], [-1]), ([0, 1], [1])],
                         ids=["repeated", "past-B", "negative-column",
                              "negative-count", "lengths"])
def test_k16_refuses_bad_columns(cols, d):
    m = KD["n"] ** 2
    ctx = tmg.MontCtx.for_modulus(m, device=CPU)
    _, a = _cols(random.Random(3), [m] * 4, ctx.num_limbs)
    with pytest.raises(ValueError):
        tm3.mm3_sqr_chain(_t(a), np.array(cols), np.array(d), ctx)


@pytest.mark.parametrize("d,width", [
    ([24] * 4096, 4096), ([15, 15] + [1] * 3398, 229),
    ([7, 5, 3, 3, 2, 1, 1], 4), ([27], 1)],
    ids=["uniform", "two-long", "small", "one"])
def test_k16_width_is_the_chains_mean_width(d, width):
    """K16's shape is K8's rule at sum(d) / max(d), rounded up: the
    column count at one d, far fewer where two columns run 15 squarings
    and the rest one (the alignment's planted extremes)."""
    assert tm3.sqr_chain_width(np.array(d)) == width


@pytest.mark.parametrize("L,B,g,K", [
    (257, 4096, 8, 17), (129, 8192, 8, 9), (65, 256, 16, 3),
    (65, 4096, 8, 5), (385, 10240, 16, 17), (193, 10240, 8, 17),
    (513, 256, 32, 9), (257, 256, 32, 5), (520, 64, 32, 9),
    (257, 2112, 8, 17), (257, 2111, 32, 5)])
def test_coop_shape_on_the_host(L, B, g, K):
    """The host's copy of csrc/coop.cuh's rule gives the (g, K) of the
    cooperative kernels' rows in PERF.md, and switches to the least
    padding where B g / 32 reaches 4 warps on each of 132 SMs."""
    assert tm3.coop_shape(L, B) == (g, K)
