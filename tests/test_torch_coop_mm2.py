"""Kernels K12 (``mont2.mm2_mul``) and K13 (``mont2.mm2_sqr``) run on the
cooperative 32-bit-word routine of ``csrc/coop.cuh``, one word product a
column, their modulus and n' recovered from the weights once a block;
their arithmetic in plain PyTorch is ``mont2.mm2_mul_words`` and
``mont2.mm2_sqr_words`` (``mont.cios32_mul`` with m and n' from
``mont2.wm_words``).  On the CPU: the word product and square equal the
JAX package's Pallas kernels ``pallas_mont2.mm2_mul_p`` (b an (L, 1)
broadcast) and ``mm2_sqr_p`` in interpret mode at an odd L, and the
twins ``mm2_mul_plain`` / ``mm2_sqr_plain`` and Python's integers at one
odd and one even L, with 0, 1 and 2m-1 among the operands; the
recovery's words and n' equal the contexts' at odd and even L up to the
kernels' largest; the K12 and K13 wrappers pass their signature to the C
library and raise on a failed launch.

Montgomery products have a unique output, so limbs must be equal."""

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
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_to_ints)

CPU = torch.device("cpu")
B = 8
# one odd and one even L; moduli of 16L - 2 bits, so 4m < R
SHAPES = [pytest.param(17, id="odd-L17"), pytest.param(12, id="even-L12")]


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


def _case(L: int, seed: int):
    """An odd modulus of 16L - 2 bits and two lists of B values below 2m:
    2m - 1, 0 and 1 first in one, last in the other."""
    rng = random.Random(seed)
    bits = LIMB_BITS * L - 2
    m = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    xs = [rng.randrange(2 * m) for _ in range(B)]
    ys = [rng.randrange(2 * m) for _ in range(B)]
    xs[:3] = [2 * m - 1, 0, 1]
    ys[-3:] = [1, 0, 2 * m - 1]
    return m, xs, ys


def _mont(m, L, x, y):
    """(x y + q m) / R, q = -x y m^-1 mod R: the unique Montgomery
    product."""
    R = 1 << (LIMB_BITS * L)
    return (x * y + (-x * y * pow(m, -1, R) % R) * m) // R


@pytest.mark.parametrize("op", ["mul-b(L,1)", "sqr"])
def test_words_equal_pallas_kernels(op):
    """One Pallas shape per JAX kernel (each compiles in interpret mode
    for seconds): K12's product with b an (L, 1) broadcast, and K13's
    square, at L=13."""
    L = 13
    m, xs, ys = _case(L, 100)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    jc = jmm.MatmulMontCtx(m, L)
    a = ints_to_limbs(xs, L)
    if op == "sqr":
        got = tm2.mm2_sqr_words(_t(a), tc.W_m)
        _same(got, jpm2.mm2_sqr_p(jnp.asarray(a), jc.W_mu, jc.W_m))
        _same(got, tm2.mm2_sqr_plain(_t(a), tc.W_mu, tc.W_m))
        want = [_mont(m, L, x, x) for x in xs]
    else:
        b = ints_to_limbs(ys[:1], L)
        got = tm2.mm2_mul_words(_t(a), _t(b), tc.W_m)
        _same(got, jpm2.mm2_mul_p(jnp.asarray(a), jnp.asarray(b), jc.W_mu,
                                  jc.W_m))
        _same(got, tm2.mm2_mul_plain(_t(a), _t(b), tc.W_mu, tc.W_m))
        want = [_mont(m, L, x, ys[0]) for x in xs]
    assert got.shape == (L, B)
    assert limbs_to_ints(got) == want


@pytest.mark.parametrize("op", ["mul", "sqr"])
@pytest.mark.parametrize("L", SHAPES)
def test_words_equal_twins_and_ints(L, op):
    """The word product and square against the nibble twins and Python's
    integers: the unique value in [0, 2m); the square also against the
    product of a with itself."""
    m, xs, ys = _case(L, 200 + L)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    a, b = _t(ints_to_limbs(xs, L)), _t(ints_to_limbs(ys, L))
    if op == "sqr":
        got = tm2.mm2_sqr_words(a, tc.W_m)
        _same(got, tm2.mm2_sqr_plain(a, tc.W_mu, tc.W_m))
        _same(got, tm2.mm2_mul_words(a, a, tc.W_m))
        want = [_mont(m, L, x, x) for x in xs]
    else:
        got = tm2.mm2_mul_words(a, b, tc.W_m)
        _same(got, tm2.mm2_mul_plain(a, b, tc.W_mu, tc.W_m))
        want = [_mont(m, L, x, y) for x, y in zip(xs, ys)]
    vals = limbs_to_ints(got)
    assert vals == want and all(v < 2 * m for v in vals)


@pytest.mark.parametrize("L", [2, 3, 12, 17, 64, 65, 129, 256, 257, 519,
                               520])
def test_block_recovery_equals_context(L):
    """K12's and K13's recovery as the block runs it (``wm_words``): the
    W words built from column 0 of W_m (limbs 2i, 2i+1; 0 past an odd L)
    equal m's 32-bit words, and n' from word 0 by four Newton steps
    equals -m^-1 mod 2^32, at odd and even L up to the kernels' largest
    (520); at one L also on the JAX package's weights."""
    m, _, _ = _case(L, 300 + L)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    words, np_ = tm2.wm_words(tc.W_m, L)
    W = (L + 1) // 2
    assert words.tolist() == [(m >> (32 * i)) & 0xFFFFFFFF for i in range(W)]
    assert np_ == (-pow(m, -1, 1 << 32)) % (1 << 32)
    limbs, np2 = tm2.wm_modulus(tc.W_m, L)
    _same(limbs, tc.m_limbs)
    assert np2 == np_
    if L == 17:
        jw, jnp_ = tm2.wm_words(_t(np.asarray(jmm.MatmulMontCtx(m, L).W_m)),
                                L)
        assert torch.equal(jw, words) and jnp_ == np_


# ---------------------------------------------------------------------------
# The wrappers' calls into the C library, without a card.
# ---------------------------------------------------------------------------

class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return t.as_subclass(_OnDevice)


@pytest.mark.parametrize("name", ["mm2_mul", "mm2_sqr"])
def test_k12_k13_wrappers_pass_their_signature_and_raise(name, monkeypatch):
    """A CUDA tensor reaches ``pct_mm2_mul`` / ``pct_mm2_sqr`` with its
    argument list (operands, out, wmu, wm, L, B; b given as an (L, 1)
    broadcast), the launch counter rises, and a launch error raises
    ``RuntimeError`` with no twin run."""
    calls, made = [], []

    def call(n, conv, dev):
        calls.append((n, conv))
        return 0

    def twin(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain twin")

    monkeypatch.setattr(kernels, "_call", call)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    for fn in ("mm2_mul_plain", "mm2_sqr_plain", "mm2_mul_words",
               "mm2_sqr_words"):
        monkeypatch.setattr(tm2, fn, twin)
    monkeypatch.setattr(torch, "empty",
                        lambda *s, **k: made.append(_fake(torch.zeros(*s, **{
                            key: v for key, v in k.items()
                            if key != "device"}))) or made[-1])
    L = 17
    m, xs, ys = _case(L, 7)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    wmu, wm = _fake(tc.W_mu), _fake(tc.W_m)
    a = _fake(_t(ints_to_limbs(xs, L)).to(torch.int32))
    b = _fake(_t(ints_to_limbs(ys[:1], L)).to(torch.int32))
    run = ((lambda: tm2.mm2_mul(a, b, wmu, wm)) if name == "mm2_mul"
           else (lambda: tm2.mm2_sqr(a, wmu, wm)))
    before = kernels.COUNTS[name]
    out = run()
    assert isinstance(out, _OnDevice) and out.shape == (L, B)
    assert [n for n, _ in calls] == [name]
    conv = calls[0][1]
    assert len(conv) == len(kernels._SIGS[name]) - 1
    assert conv[-2:] == [L, B]
    assert kernels.COUNTS[name] == before + 1
    monkeypatch.setattr(kernels, "_call", lambda n, c, dev: 1)
    with pytest.raises(RuntimeError, match=f"{name} failed to launch"):
        run()
    assert kernels.COUNTS[name] == before + 2
