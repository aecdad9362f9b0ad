"""Kernels K4 (``mm3_exp``) and K7 (``mm3_exp_shared``), the chains on
K3's tile (``csrc/mm3_tile.cuh``), on the CPU: their plain twins against
the JAX package's Pallas kernels (interpret mode) and Python's ``pow``,
limb for limb.  The wrappers' calls into the C library are in
``test_torch_mont3_tile.py``.

Every Montgomery product's output is unique, and the chains run the TPU
kernels' order of products, so the twins, the Pallas kernels and the
CUDA chains agree limb for limb."""

import functools
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_to_ints)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpm3, "INTERPRET", True)


def _modulus(L: int, seed: int) -> int:
    """An odd modulus with exactly L limbs in its context (R > 4m)."""
    bits = LIMB_BITS * L - 2
    return random.Random(seed).getrandbits(bits) | (1 << (bits - 1)) | 1


def _contexts(m: int):
    return (jmg.MontCtx.for_modulus(m, mxu=True),
            tmg.MontCtx.for_modulus(m, mxu=True, device=CPU))


def _same(port, ref):
    p = port.numpy().astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _exponent(digits, window: int, start: int = 0) -> int:
    """The integer of MSB-first base-2^window digits from `start` on."""
    e = 0
    for d in digits[start:]:
        e = (e << window) | int(d)
    return e


def _mont_bases(m: int, L: int, B: int, seed: int):
    """B values x < m (0 and 1 the last two when B > 2) and their
    Montgomery forms."""
    r = random.Random(seed)
    xs = [r.randrange(m) for _ in range(B)]
    if B > 2:
        xs[-2:] = [0, 1]
    R = 1 << (LIMB_BITS * L)
    return xs, ints_to_limbs([x * R % m for x in xs], L)


_K4_WIN_START = {4: 0, 17: 3}


@functools.lru_cache(maxsize=None)
def _k4_reference(L: int):
    """The Pallas ``mm3_exp_p`` at L over 33 columns, once per L (compiling
    the kernel in interpret mode takes most of a case's time, and a case
    of B columns reads the first B): the contexts, the bases, the digits
    and the kernel's output."""
    ws, B = _K4_WIN_START[L], 33
    m = _modulus(L, 10 * L + B)
    jctx, tctx = _contexts(m)
    assert tctx.num_limbs == L
    xs, base = _mont_bases(m, L, B, L + B + ws)
    rng = np.random.default_rng(L * B + ws)
    dig = rng.integers(0, 16, size=(ws + 4, B)).astype(np.int32)
    dig[ws, 0], dig[ws + 1, 0] = 0, 15           # counted windows hold 0, 15
    dig[ws + 2, 1:17] = np.arange(16)            # ... and every digit
    ref = np.asarray(jpm3.mm3_exp_p(
        jnp.asarray(base.astype(np.uint32)), jnp.asarray(dig), jctx.wmu,
        jctx.wm, jctx.off1, jctx.off2, jctx.one, win_start=ws, tb=128))
    return m, tctx, xs, base, dig, ref


# Each value of L, B and win_start (one win_start per L: the kernel is
# compiled once per L).
@pytest.mark.parametrize("L,B,ws", [(4, 1, 0), (4, 33, 0), (17, 1, 3),
                                    (17, 33, 3)])
def test_k4_twin_equals_pallas_kernel_and_pow(L, B, ws):
    assert _K4_WIN_START[L] == ws
    m, tctx, xs, base, dig, ref = _k4_reference(L)
    xs, base, dig = xs[:B], base[:, :B], np.ascontiguousarray(dig[:, :B])
    got = tm3.mm3_exp_plain(torch.from_numpy(base.astype(np.int64)),
                            torch.from_numpy(dig), tctx.wmu, tctx.wm,
                            tctx.off1, tctx.off2, tctx.one, ws)
    _same(got, ref[:, :B])
    # the wrapper and the dispatcher on a CPU tensor: the twin
    _same(tm3.mm3_exp(torch.from_numpy(base.astype(np.int32)), dig, tctx,
                      ws), got.numpy())
    _same(tmg.mont_exp(torch.from_numpy(base.astype(np.int32)), dig, tctx,
                       4, ws), got.numpy())
    R = 1 << (LIMB_BITS * L)
    for j, (g, x) in enumerate(zip(limbs_to_ints(got), xs)):
        e = _exponent(dig[:, j], 4, ws)
        assert g < 2 * m and g % m == pow(x, e, m) * R % m


@pytest.mark.parametrize("L,window", [(17, 3), (4, 5)])
def test_k7_twin_equals_pallas_kernel_and_pow(L, window):
    m = _modulus(L, 7 * L + window)
    jctx, tctx = _contexts(m)
    B = 33
    xs, base = _mont_bases(m, L, B, L * window)
    dig = np.array([0, (1 << window) - 1, 1, 5 % (1 << window)],
                   dtype=np.int32)
    got = tm3.mm3_exp_shared_plain(
        torch.from_numpy(base.astype(np.int64)), torch.from_numpy(dig),
        tctx.wmu, tctx.wm, tctx.off1, tctx.off2, tctx.one, window)
    _same(got, jpm3.mm3_exp_shared_p(jnp.asarray(base.astype(np.uint32)),
                                     jnp.asarray(dig), jctx.wmu, jctx.wm,
                                     jctx.off1, jctx.off2, jctx.one,
                                     window=window))
    _same(tm3.mm3_exp_shared(torch.from_numpy(base.astype(np.int32)), dig,
                             tctx, window), got.numpy())
    R = 1 << (LIMB_BITS * L)
    e = _exponent(dig, window)
    for g, x in zip(limbs_to_ints(got), xs):
        assert g < 2 * m and g % m == pow(x, e, m) * R % m
