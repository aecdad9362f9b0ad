"""Kernel K14 (``mont2.mm2_exp``) runs K10's 4-bit chain on the
cooperative 32-bit-word routine of ``csrc/coop.cuh``, its modulus and n'
recovered from the weights; its arithmetic in plain PyTorch is
``mont2.mm2_exp_words`` (``mont.mont_exp_words`` with m and n' from
``mont2.wm_modulus``).  On the CPU: the word chain equals the nibble
twin ``mm2_exp_plain``, K10's word chain on the recovered modulus and
Python's ``pow`` at odd and even L from 2 to 520 and win_start 0, 2 and
n_win; it equals the JAX package's Pallas kernel
``pallas_mont2.mm2_exp_p`` in interpret mode at one L below and one
above the reference's ``PRESHIFT_MAX_L`` (its squaring routine and its
product path); the K14 wrapper passes its signature, with no table
argument, to the C library and raises on a failed launch.

Montgomery products have a unique output, so limbs must be equal."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pailliercryptolib_python_tpu.ops import matmul_mont as jmm
from pailliercryptolib_python_tpu.ops import pallas_mont2 as jpm2
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.ops import matmul_mont as tmm
from pailliercryptolib_python_tpu_torch.ops import mont as tmont
from pailliercryptolib_python_tpu_torch.ops import mont2 as tm2
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_to_ints)

CPU = torch.device("cpu")
B = 4
N_WIN = 2


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


def _case(L: int, seed: int, n_win: int = N_WIN):
    """An odd modulus of 16L - 2 bits (4m < R), B Montgomery bases below
    2m (2m - 1 and 0 first), the Montgomery one as (L, 1), and n_win
    4-bit digits a column MSB-first, the first column's all 15."""
    rng = random.Random(seed)
    bits = LIMB_BITS * L - 2
    m = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    R = 1 << (LIMB_BITS * L)
    xs = [2 * m - 1, 0] + [rng.randrange(2 * m) for _ in range(B - 2)]
    es = [(1 << (4 * n_win)) - 1] + [rng.getrandbits(4 * n_win)
                                     for _ in range(B - 1)]
    return (m, R, xs, es, ints_to_limbs(xs, L), ints_to_limbs([R % m], L),
            tmg.exponent_digits(es, n_win, 4))


@pytest.mark.parametrize("win_start", [0, 1, N_WIN])
@pytest.mark.parametrize("L", [2, 3, 12, 17, 65, 130, 520])
def test_words_equal_twin_k10_and_pow(L, win_start):
    """``mm2_exp_words`` equals the nibble twin, K10's word chain on the
    modulus ``wm_modulus`` recovers (n' mod 2^16 as its n0), and
    x^e' R mod m below 2m, e' the digits from win_start on (x the value
    the Montgomery base stands for)."""
    m, R, xs, es, base, one, digits = _case(L, 1000 + L)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    got = tm2.mm2_exp_words(_t(base), digits, tc.W_m, _t(one), win_start)
    assert got.shape == (L, B) and got.dtype == torch.int32
    _same(got, tm2.mm2_exp_plain(_t(base), _t(digits), tc.W_mu, tc.W_m,
                                 _t(one), win_start))
    mlimbs, np_ = tm2.wm_modulus(tc.W_m, L)
    _same(mlimbs, tc.m_limbs)
    _same(got, tmont.mont_exp_words(_t(base), digits, mlimbs, np_ & 0xFFFF,
                                    _t(one), win_start))
    keep = 4 * (N_WIN - win_start)
    Rinv = pow(R, -1, m)
    for g, x, e in zip(limbs_to_ints(got), xs, es):
        assert g < 2 * m
        assert g % m == pow(x * Rinv % m, e & ((1 << keep) - 1), m) * R % m


@pytest.mark.parametrize("L", [pytest.param(13, id="L13-squares"),
                               pytest.param(194, id="L194-products")])
def test_words_equal_pallas_kernel(L):
    """The word chain against the Pallas kernel in interpret mode: at
    L=13 it squares through its squaring routine, at L=194 (above the
    reference's PRESHIFT_MAX_L) through its product; win_start 1."""
    assert (L > jpm2.PRESHIFT_MAX_L) == (L == 194)
    m, R, xs, es, base, one, digits = _case(L, 2000 + L)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    jc = jmm.MatmulMontCtx(m, L)
    got = tm2.mm2_exp_words(_t(base), digits, tc.W_m, _t(one), 1)
    _same(got, jpm2.mm2_exp_p(jnp.asarray(base), jnp.asarray(digits),
                              jc.W_mu, jc.W_m, jnp.asarray(one),
                              win_start=1))


# ---------------------------------------------------------------------------
# The wrapper's call into the C library, without a card.
# ---------------------------------------------------------------------------

class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return t.as_subclass(_OnDevice)


def test_k14_wrapper_passes_its_signature_and_raises(monkeypatch):
    """A CUDA tensor reaches ``pct_mm2_exp`` with its argument list
    (base, digits, one, out, wmu, wm, L, B, n_win, win_start: no table
    scratch), the launch counter rises, and a launch error raises
    ``RuntimeError`` with no twin run."""
    calls, made = [], []

    def call(n, conv, dev):
        calls.append((n, conv))
        return 0

    def twin(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain twin")

    monkeypatch.setattr(kernels, "_call", call)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    for fn in ("mm2_exp_plain", "mm2_exp_words"):
        monkeypatch.setattr(tm2, fn, twin)
    monkeypatch.setattr(kernels, "digit_tensor",
                        lambda d, w, dev: _fake(torch.as_tensor(
                            np.asarray(d, dtype=np.int32))))
    monkeypatch.setattr(torch, "empty",
                        lambda *s, **k: made.append(_fake(torch.zeros(*s, **{
                            key: v for key, v in k.items()
                            if key != "device"}))) or made[-1])
    L = 17
    m, R, xs, es, base, one, digits = _case(L, 7)
    tc = tmm.MatmulMontCtx(m, L, device=CPU)
    wmu, wm = _fake(tc.W_mu), _fake(tc.W_m)
    a = _fake(_t(base).to(torch.int32))
    o = _fake(_t(one).to(torch.int32))
    run = lambda: tm2.mm2_exp(a, digits, wmu, wm, o, 1)
    before = kernels.COUNTS["mm2_exp"]
    out = run()
    assert isinstance(out, _OnDevice) and out.shape == (L, B)
    assert len(made) == 1                       # the output, no table
    assert [n for n, _ in calls] == ["mm2_exp"]
    conv = calls[0][1]
    assert len(conv) == len(kernels._SIGS["mm2_exp"]) - 1 == 10
    assert conv[-4:] == [L, B, N_WIN, 1]
    assert kernels.COUNTS["mm2_exp"] == before + 1
    monkeypatch.setattr(kernels, "_call", lambda n, c, dev: 1)
    with pytest.raises(RuntimeError, match="mm2_exp failed to launch"):
        run()
    assert kernels.COUNTS["mm2_exp"] == before + 2
