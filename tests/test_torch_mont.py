"""The port's Montgomery layer (ops/montgomery.py, ops/mont3.py: the plain
twins of kernels K3 and K4) against the JAX package on the CPU.

Every Montgomery product here has a unique output (a*b + q*m)/R with
q = -a*b*m^-1 mod R, so the port's plain mm3 product, the JAX CIOS path
(_mont_mul_jnp) and the Pallas kernel (mm3_mul_p, interpret mode) must
agree limb for limb.
"""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu.ops.limb import LIMB_BITS
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops.limb import ints_to_limbs

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpm3, "INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = port.cpu().numpy().astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _modulus(rng, bits):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


def _contexts(m):
    jctx = jmg.MontCtx.for_modulus(m, mxu=True)
    tctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    return jctx, tctx


@pytest.mark.parametrize("bits", [128, 256, 1040])
def test_context_constants(bits):
    m = _modulus(random.Random(bits), bits)
    jctx, tctx = _contexts(m)
    for f in ("n_limbs", "r2", "one", "wmu", "wm", "off1", "off2"):
        _same(getattr(tctx, f), getattr(jctx, f))
    assert tctx.n0inv == int(np.asarray(jctx.n0inv)[0])
    L = tctx.num_limbs
    for out_l in (L, 2 * L):
        assert np.array_equal(tm3.byte_toeplitz(m, L, out_l),
                              jpm3.byte_toeplitz(m, L, out_l))
    for nb in (1, 7, 40):
        c = random.Random(nb).getrandbits(8 * nb)
        assert np.array_equal(tm3.signed_bytes_of(c, nb),
                              jpm3.signed_bytes_of(c, nb))


@pytest.mark.parametrize("bits", [256, 1040])
def test_mm3_mul_plain_matches_kernel_and_cios(bits):
    rng = random.Random(bits + 1)
    m = _modulus(rng, bits)
    jctx, tctx = _contexts(m)
    L = tctx.num_limbs
    xs = [rng.randrange(2 * m) for _ in range(7)] + [2 * m - 1]
    ys = [rng.randrange(2 * m) for _ in range(7)] + [2 * m - 1]
    a, b = ints_to_limbs(xs, L), ints_to_limbs(ys, L)
    got = tm3.mm3_mul_plain(_t(a), _t(b), tctx.wmu, tctx.wm, tctx.off1,
                            tctx.off2)
    w = (jctx.wmu, jctx.wm, jctx.off1, jctx.off2)
    _same(got, jpm3.mm3_mul_p(jnp.asarray(a), jnp.asarray(b), *w, tb=128))
    _same(got, jmg._mont_mul_jnp(jnp.asarray(a), jnp.asarray(b), jctx))
    # the wrapper takes the plain twin for a CPU tensor; the CIOS twin
    # of a weightless context and the dispatcher agree
    _same(tm3.mm3_mul(_t(a), _t(b), tctx), got)
    plain_ctx = tmg.MontCtx.for_modulus(m, device=CPU)
    assert plain_ctx.wmu is None
    _same(tmg.mont_mul(_t(a), _t(b), plain_ctx), got)
    R = 1 << (LIMB_BITS * L)
    from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints
    for g, x, y in zip(limbs_to_ints(got), xs, ys):
        assert g < 2 * m and g % m == x * y * pow(R, -1, m) % m


def test_mm3_exp_plain_matches_kernel_and_jnp():
    rng = random.Random(9)
    m = _modulus(rng, 128)
    jctx, tctx = _contexts(m)
    L = tctx.num_limbs
    R = 1 << (LIMB_BITS * L)
    xs = [rng.randrange(m) for _ in range(4)]
    es = [rng.getrandbits(24) for _ in range(4)]
    base = ints_to_limbs([x * R % m for x in xs], L)
    dig = jmg.exponent_digits(es, 9, 4)        # 3 leading zero windows
    w = (jctx.wmu, jctx.wm, jctx.off1, jctx.off2)
    for ws in (0, 2, 3):
        got = tm3.mm3_exp_plain(_t(base), _t(dig), tctx.wmu, tctx.wm,
                                tctx.off1, tctx.off2, tctx.one, ws)
        if ws == 3:                            # interpret mode is slow
            _same(got, jpm3.mm3_exp_p(jnp.asarray(base), jnp.asarray(dig),
                                      *w, jctx.one, win_start=ws, tb=128))
        _same(got, jmg._mont_exp_jnp(jnp.asarray(base), jnp.asarray(dig),
                                     jctx, 4, ws))
        _same(tmg.mont_exp(_t(base), dig, tctx, 4, ws), got)
    from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints
    for g, x, e in zip(limbs_to_ints(got), xs, es):
        assert g % m == pow(x, e, m) * R % m


def test_plain_cios_exp_other_window():
    """The weightless CPU context's plain chain for windows != 4."""
    rng = random.Random(12)
    m = _modulus(rng, 200)
    jctx = jmg.MontCtx.for_modulus(m, mxu=False)
    tctx = tmg.MontCtx.for_modulus(m, device=CPU)
    L = tctx.num_limbs
    base = ints_to_limbs([rng.randrange(2 * m) for _ in range(5)], L)
    dig = jmg.exponent_digits([rng.getrandbits(30) for _ in range(5)], 6, 5)
    _same(tmg.mont_exp(_t(base), dig, tctx, 5, 1),
          jmg._mont_exp_jnp(jnp.asarray(base), jnp.asarray(dig), jctx, 5, 1))


@pytest.mark.parametrize("iters", [None, 2, 5])
def test_reduce_wide_to_from_mont(iters):
    rng = random.Random(iters or 0)
    m = _modulus(rng, 500)
    jctx, tctx = _contexts(m)
    L = tctx.num_limbs
    K = L + (iters or L)
    T = ints_to_limbs([rng.randrange(m << (16 * (iters or L)))
                       for _ in range(6)], K)
    _same(tmg.mont_reduce_wide(_t(T), tctx, iters=iters),
          jmg.mont_reduce_wide(jnp.asarray(T), jctx, iters=iters))
    a = ints_to_limbs([rng.randrange(m) for _ in range(6)] + [m - 1], L)
    _same(tmg.to_mont(_t(a), tctx), jmg.to_mont(jnp.asarray(a), jctx))
    am = ints_to_limbs([rng.randrange(2 * m) for _ in range(6)], L)
    _same(tmg.from_mont(_t(am), tctx), jmg.from_mont(jnp.asarray(am), jctx))


def test_cios_carry_save_boundary():
    """The CIOS accumulators at their largest: a = b = 2m-1 with m just
    below R/4 (the JAX carry-save adds never wrap there either)."""
    L = 9
    m = (1 << (16 * L - 2)) - 3
    jctx = jmg.MontCtx.for_modulus(m, mxu=False)
    tctx = tmg.MontCtx.for_modulus(m, device=CPU)
    a = ints_to_limbs([2 * m - 1, 2 * m - 2, (1 << (16 * L - 1)) - 1], L)
    _same(tmg.mont_mul_plain(_t(a), _t(a), tctx),
          jmg._mont_mul_jnp(jnp.asarray(a), jnp.asarray(a), jctx))


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """No fallback: a tensor that is neither on the CPU nor on CUDA is
    refused, never moved."""
    m = _modulus(random.Random(2), 256)
    tctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    a = torch.zeros((tctx.num_limbs, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tm3.mm3_mul(a, a, tctx)
    with pytest.raises(ValueError):
        tm3.mm3_exp(a, torch.zeros((3, 2), dtype=torch.int32), tctx)
