"""Kernel K10's arithmetic on the CPU: the plain PyTorch model of its
32-bit-word Montgomery product (``mont.cios32_mul``: limb pairs, W =
ceil(L/2) word steps, n' = -n^-1 mod 2^32 by one Newton step from the
16-bit n0, the outer operand shifted by 16 bits at odd L) and of its
chain (``mont.mont_exp_words``), which must equal the 16-bit CIOS
product ``cios_mul``, the plain twin, the JAX package's Pallas kernel
``pallas_mont.mont_exp_p`` in interpret mode and Python's integers limb
for limb; plus the K10 wrapper's call into the C library.

Montgomery products have a unique output, so limbs must be equal."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont as jpm
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.ops import mont as tmont
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_to_ints)

CPU = torch.device("cpu")
B = 7


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


def _moduli(L: int, shared: bool, seed: int) -> list:
    """B odd moduli (or one, repeated) with exactly L limbs (R > 4n)."""
    r = random.Random(seed)
    bits = LIMB_BITS * L - 2
    odd = lambda: r.getrandbits(bits) | (1 << (bits - 1)) | 1
    return [odd()] * B if shared else [odd() for _ in range(B)]


def _contexts(ns, L, shared):
    if shared:
        return (jmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L),
                tmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L,
                                        mxu=False, device=CPU))
    return jmg.MontCtx.for_moduli(ns, L), tmg.MontCtx.for_moduli(ns, L, CPU)


@pytest.mark.parametrize("shared", [False, True], ids=["per-element",
                                                       "shared"])
@pytest.mark.parametrize("L", [2, 3, 17, 64, 65, 129])
def test_word_product_equals_cios_and_ints(L, shared):
    ns = _moduli(L, shared, L)
    ctx = _contexts(ns, L, shared)[1]
    assert ctx.num_limbs == L
    r = random.Random(L + 1)
    xs = [r.randrange(2 * n) for n in ns]
    ys = [r.randrange(2 * n) for n in ns]
    xs[0], ys[1] = 0, 1                          # the edges
    xs[2] = ys[2] = xs[3] = 2 * ns[2] - 1
    a, b = _t(ints_to_limbs(xs, L)), _t(ints_to_limbs(ys, L))
    got = tmont.cios32_mul(a, b, ctx.n_limbs, ctx.n0inv)
    assert got.dtype == torch.int32 and got.shape == (L, B)
    _same(got, tmg.cios_mul(a, b, ctx.n_limbs, ctx.n0inv))
    R = 1 << (LIMB_BITS * L)
    for g, x, y, n in zip(limbs_to_ints(got), xs, ys, ns):
        assert g == (x * y + (-x * y * pow(n, -1, R) % R) * n) // R < 2 * n


@pytest.mark.parametrize("L,shared,win_start", [
    (2, False, 0), (3, True, 3), (17, False, 3), (64, True, 0),
    (65, False, 3), (129, False, 0), (129, True, 3)])
def test_word_chain_equals_twin_pallas_and_pow(L, shared, win_start):
    ns = _moduli(L, shared, 50 + L)
    jctx, tctx = _contexts(ns, L, shared)
    r = random.Random(L + win_start)
    n_win = win_start + 2
    R = 1 << (LIMB_BITS * L)
    xs = [r.randrange(n) for n in ns]
    es = [r.getrandbits(4 * (n_win - win_start)) for _ in range(B - 2)]
    es += [0, 1]
    base = ints_to_limbs([x * R % n for x, n in zip(xs, ns)], L)
    dig = jmg.exponent_digits(es, n_win, 4)
    dig[-1, :min(B, 16)] = np.arange(min(B, 16))  # low digits 0..6
    es = [int(sum(int(d) << (4 * (n_win - 1 - w))
                  for w, d in enumerate(dig[win_start:, c], win_start)))
          for c in range(B)]
    got = tmont.mont_exp_words(_t(base), dig, tctx.n_limbs, tctx.n0inv,
                               tctx.one, win_start)
    ref = jpm.mont_exp_p(jnp.asarray(base), jnp.asarray(dig), jctx.n_limbs,
                         jctx.n0inv, jctx.one, win_start=win_start)
    _same(got, ref)
    _same(tmont.mont_exp_plain(_t(base), _t(dig), tctx.n_limbs, tctx.n0inv,
                               tctx.one, win_start), ref)
    for g, x, e, n in zip(limbs_to_ints(got), xs, es, ns):
        assert g % n == pow(x, e, n) * R % n


class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("shared", [False, True], ids=["per-element",
                                                       "shared"])
def test_k10_wrapper_passes_its_signature_and_raises(shared, monkeypatch):
    """A CUDA tensor reaches K10's C entry point with its argument list
    (no table scratch: the table lives in the kernel's shared memory)
    and the per-element flag; a launch error raises, and nothing falls
    back to the twin."""
    L = 65
    ns = _moduli(L, shared, 3)
    ctx = _contexts(ns, L, shared)[1]
    fake = lambda t: t.as_subclass(_OnDevice)
    base = fake(torch.from_numpy(ints_to_limbs([n - 2 for n in ns], L)
                                 .astype(np.int32)))
    n0 = ctx.n0inv if isinstance(ctx.n0inv, int) else fake(ctx.n0inv)
    dig = np.arange(3 * B, dtype=np.int32).reshape(3, B) % 16
    calls = []

    def call(name, conv, dev):
        calls.append((name, conv))
        return 0

    monkeypatch.setattr(kernels, "_call", call)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    real = kernels.digit_tensor
    monkeypatch.setattr(kernels, "digit_tensor",
                        lambda d, w, dev, below=None: fake(real(d, w, CPU,
                                                                below)))
    monkeypatch.setattr(torch, "empty",
                        lambda *s, **k: fake(torch.zeros(*s, **{
                            key: v for key, v in k.items()
                            if key != "device"})))
    monkeypatch.setattr(torch, "full",
                        lambda *s, **k: fake(torch.ones(s[0], **{
                            key: v for key, v in k.items()
                            if key not in ("device", "fill_value")})))
    before = kernels.COUNTS["mont_exp"]
    out = tmont.mont_exp_p(base, dig, fake(ctx.n_limbs), n0, fake(ctx.one),
                           1)
    assert isinstance(out, _OnDevice) and out.shape == (L, B)
    assert [n for n, _ in calls] == ["mont_exp"]
    conv = calls[0][1]
    assert len(conv) == len(kernels._SIGS["mont_exp"]) - 1
    # per_elem, L, B, n_win, win_start
    assert conv[6:] == [int(not shared), L, B, 3, 1]
    assert kernels.COUNTS["mont_exp"] == before + 1
    monkeypatch.setattr(kernels, "_call", lambda n, c, dev: 1)
    with pytest.raises(RuntimeError, match="mont_exp failed to launch"):
        tmont.mont_exp_p(base, dig, fake(ctx.n_limbs), n0, fake(ctx.one))
