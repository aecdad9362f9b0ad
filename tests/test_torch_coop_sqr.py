"""Kernels K8 (``mont3.mm3_sqr``) and K15 (``mont2.mm2_exp_shared``) run
on the cooperative 32-bit-word routine of ``csrc/coop.cuh``, each
square a word product with one operand; their arithmetic in plain
PyTorch is ``mont.cios32_mul(a, a, ...)`` and
``mont2.mm2_exp_shared_words``.  On the CPU: the word square equals the
JAX package's Pallas kernel ``pallas_mont3.mm3_sqr_p`` in interpret
mode, the twin ``mm3_sqr_plain`` and Python's integers; the word chain
equals ``pallas_mont2.mm2_exp_shared_p`` in interpret mode, the twin
``mm2_exp_shared_plain`` and ``pow``; K15's recovery of the modulus and
n' from its weights equals the context's.  Each at one odd and one even
L, with 0, 1 and 2m-1 among the operands.  Plus the K8 and K15
wrappers' calls into the C library.

Montgomery products have a unique output, so limbs must be equal."""

import ctypes
import dataclasses
import random
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import matmul_mont as jmm
from pailliercryptolib_python_tpu.ops import pallas_mont2 as jpm2
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.ops import matmul_mont as tmm
from pailliercryptolib_python_tpu_torch.ops import mont as tmont
from pailliercryptolib_python_tpu_torch.ops import mont2 as tm2
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
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
    monkeypatch.setattr(jpm3, "INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = (port.numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _case(L: int, seed: int):
    """An odd modulus of 16L - 2 bits and B values below 2m: 2m - 1, 0
    and 1 first."""
    rng = random.Random(seed)
    bits = LIMB_BITS * L - 2
    m = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    vals = [rng.randrange(2 * m) for _ in range(B)]
    vals[:3] = [2 * m - 1, 0, 1]
    return m, vals


@pytest.mark.parametrize("L", SHAPES)
def test_word_square_equals_pallas_twin_and_ints(L):
    m, vals = _case(L, 300 + L)
    ctx = tmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=True,
                                  device=CPU)
    assert ctx.num_limbs == L
    a = ints_to_limbs(vals, L)
    got = tmont.cios32_mul(_t(a), _t(a), ctx.n_limbs, ctx.n0inv)
    w_np = tm3.byte_weights_np(m, L)
    _same(got, jpm3.mm3_sqr_p(jnp.asarray(a), *map(jnp.asarray, w_np),
                              tb=128))
    _same(got, tm3.mm3_sqr_plain(_t(a), ctx.wmu, ctx.wm, ctx.off1, ctx.off2))
    _same(got, tm3.mm3_sqr(_t(a), ctx))
    R = 1 << (LIMB_BITS * L)
    for g, x in zip(limbs_to_ints(got), vals):
        assert g == (x * x + (-x * x * pow(m, -1, R) % R) * m) // R < 2 * m


@pytest.mark.parametrize("L", SHAPES)
def test_modulus_recovered_from_the_weights(L):
    """K15 reads m from column 0 of W_m and derives n' = -m^-1 mod 2^32
    by Newton steps: both equal the contexts' (the port's and the JAX
    package's)."""
    m, _ = _case(L, 400 + L)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    jc = jmm.MatmulMontCtx(m, L)
    limbs, np_ = tm2.wm_modulus(tc.W_m, L)
    _same(limbs, tc.m_limbs)
    _same(limbs, jc.m_limbs)
    _same(tm2.wm_modulus(_t(np.asarray(jc.W_m)), L)[0], jc.m_limbs)
    assert np_ == (-pow(m, -1, 1 << 32)) % (1 << 32)


@pytest.mark.parametrize("window, L", [(5, 17), (3, 12)],
                         ids=["w5-odd-L17", "w3-even-L12"])
def test_word_chain_equals_pallas_twin_and_pow(window, L):
    """K15's order of products over ``cios32_mul``: the
    table T[d] = T[d-1] base, then per window `window` squarings and one
    product by T[digit]; the digits cover 0 and 2^window - 1."""
    m, vals = _case(L, 500 + window)
    R = 1 << (LIMB_BITS * L)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    jc = jmm.MatmulMontCtx(m, L)
    mont = [x % m * R % m for x in vals]
    mont[0] = 2 * m - 1
    base = ints_to_limbs(mont, L)
    one = ints_to_limbs([R % m], L)
    digits = np.array([(1 << window) - 1, 0, 1, 6], dtype=np.int32)
    e = int("".join(format(int(d), f"0{window}b") for d in digits), 2)
    got = tm2.mm2_exp_shared_words(_t(base), digits, tc.W_m, _t(one),
                                   window)
    _same(got, jpm2.mm2_exp_shared_p(jnp.asarray(base), digits, jc.W_mu,
                                     jc.W_m, jnp.asarray(one),
                                     window=window))
    _same(got, tm2.mm2_exp_shared_plain(_t(base), _t(digits), tc.W_mu,
                                        tc.W_m, _t(one), window))
    for g, b in zip(limbs_to_ints(got), limbs_to_ints(base)):
        assert g < 2 * m and g % m == pow(b * pow(R, -1, m), e, m) * R % m


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


def _k8_call():
    L = 17
    m, vals = _case(L, 7)
    ctx = tmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=False,
                                  device=CPU)
    ctx = dataclasses.replace(ctx, n_limbs=_fake(ctx.n_limbs))
    a = _fake(_t(ints_to_limbs(vals, L)).to(torch.int32))
    return (lambda: tm3.mm3_sqr(a, ctx)), [ctx.n0inv, L, B]


def _k15_call(monkeypatch):
    L, window = 17, 5
    m, vals = _case(L, 8)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    wmu, wm = _fake(tc.W_mu), _fake(tc.W_m)
    base = _fake(_t(ints_to_limbs(vals, L)).to(torch.int32))
    one = _fake(_t(ints_to_limbs([1], L)).to(torch.int32))
    digits = np.array([31, 0, 7], dtype=np.int32)
    real = kernels.digit_tensor
    monkeypatch.setattr(kernels, "digit_tensor",
                        lambda d, w, dev, below=None: _fake(real(d, w, CPU,
                                                                 below)))
    # the table's size comes from the library (K words an entry for every
    # thread of the launch); its stand-in here
    words = (1 << window) * 9 * 128
    monkeypatch.setattr(kernels, "mm2_exp_shared_table_words",
                        lambda *args: words if args == (L, B, window)
                        else pytest.fail(f"table asked for {args}"))
    run = lambda: tm2.mm2_exp_shared(base, digits, wmu, wm, one, window)
    return run, [3, L, B, window], words


@pytest.mark.parametrize("name", ["mm3_sqr", "mm2_exp_shared"])
def test_k8_k15_wrappers_pass_their_signature_and_raise(name, monkeypatch):
    """A CUDA tensor reaches ``pct_mm3_sqr`` / ``pct_mm2_exp_shared``
    with its argument list (K15's table sized by the library), the launch
    counter rises, and a launch error raises ``RuntimeError`` with no twin
    run."""
    calls, made = [], []

    def call(n, conv, dev):
        calls.append((n, conv))
        return 0

    def twin(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(kernels, "_call", call)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    monkeypatch.setattr(tm3, "mm3_sqr_plain", twin)
    monkeypatch.setattr(tm2, "mm2_exp_shared_plain", twin)
    monkeypatch.setattr(torch, "empty",
                        lambda *s, **k: made.append(_fake(torch.zeros(*s, **{
                            key: v for key, v in k.items()
                            if key != "device"}))) or made[-1])
    if name == "mm3_sqr":
        run, tail = _k8_call()
    else:
        run, tail, words = _k15_call(monkeypatch)
    before = kernels.COUNTS[name]
    out = run()
    assert isinstance(out, _OnDevice) and out.shape == (17, B)
    assert [n for n, _ in calls] == [name]
    conv = calls[0][1]
    assert len(conv) == len(kernels._SIGS[name]) - 1
    if name == "mm3_sqr":
        assert conv[3:] == tail                  # n0, L, B
    else:
        assert [conv[2]] + conv[8:] == tail      # n_win, L, B, window
        assert made[1].shape == (words,)
    assert kernels.COUNTS[name] == before + 1
    monkeypatch.setattr(kernels, "_call", lambda n, c, dev: 1)
    with pytest.raises(RuntimeError, match=f"{name} failed to launch"):
        run()
    assert kernels.COUNTS[name] == before + 2


def test_table_size_is_read_from_the_library(monkeypatch):
    """``kernels.mm2_exp_shared_table_words`` asks the built library
    (``csrc/mont2.cu``) for K15's scratch as a 64-bit count, and raises
    where the library refuses the shape."""
    asked = []

    class Fn:
        restype = ctypes.c_int

        def __call__(self, L, Bn, window):
            asked.append((L, Bn, window, self.restype))
            return -1 if L > 520 else (1 << window) * 9 * 32768

    monkeypatch.setattr(kernels, "lib",
                        lambda: types.SimpleNamespace(
                            pct_mm2_exp_shared_table_words=Fn()))
    assert kernels.mm2_exp_shared_table_words(129, 4096, 5) == 32 * 9 * 32768
    with pytest.raises(ValueError, match="K15"):
        kernels.mm2_exp_shared_table_words(521, 4096, 5)
    assert asked == [(129, 4096, 5, ctypes.c_longlong),
                     (521, 4096, 5, ctypes.c_longlong)]
