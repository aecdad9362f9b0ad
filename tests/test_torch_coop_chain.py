"""Kernels K9 (``mont.mont_mul_p``) and K11 (``mont.mont_chain_p``) run on
K10's cooperative 32-bit-word routine; its arithmetic in plain PyTorch
is ``mont.cios32_mul``.  On the CPU: one ``cios32_mul`` equals the JAX
package's Pallas kernel ``pallas_mont.mont_mul_p`` in interpret mode, and
a chain of ``cios32_mul`` over pre-gathered factors equals
``pallas_mont.mont_chain_p`` in interpret mode, the plain twin
``mont_chain_plain`` and Python's integers, at one odd and one even L,
shared and per-element, with 0, 1 and 2n-1 among the operands.  Plus
the K9 and K11 wrappers' calls into the C library.

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
B = 8
N_WIN = 5


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


def _case(L: int, shared: bool, seed: int):
    """B odd moduli of exactly L limbs (R > 4n), one repeated when
    shared; the (JAX, port) contexts, the JAX modulus and n0 broadcast
    to (L, B) and (B,) (one Pallas shape for both cases), and a value
    maker whose first three columns are 2n-1, 0 and 1."""
    r = random.Random(seed)
    bits = LIMB_BITS * L - 2
    odd = lambda: r.getrandbits(bits) | (1 << (bits - 1)) | 1
    ns = [odd()] * B if shared else [odd() for _ in range(B)]
    if shared:
        jctx = jmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L)
        tctx = tmg.MontCtx.for_modulus(ns[0], min_bits=LIMB_BITS * L,
                                       mxu=False, device=CPU)
    else:
        jctx = jmg.MontCtx.for_moduli(ns, L)
        tctx = tmg.MontCtx.for_moduli(ns, L, CPU)
    assert tctx.num_limbs == L
    jn = jnp.broadcast_to(jctx.n_limbs, (L, B))
    jn0 = jnp.broadcast_to(jnp.asarray(jctx.n0inv).reshape(-1), (B,))

    def values(first):
        vals = [r.randrange(2 * n) for n in ns]
        vals[first % B] = 2 * ns[first % B] - 1
        vals[(first + 1) % B], vals[(first + 2) % B] = 0, 1
        return vals
    return ns, jctx, tctx, jn, jn0, values


@pytest.mark.parametrize("shared", [False, True],
                         ids=["per-element", "shared"])
@pytest.mark.parametrize("L", [13, 12], ids=["odd-L13", "even-L12"])
def test_word_product_equals_pallas_mont_mul(L, shared):
    ns, _, tctx, jn, jn0, values = _case(L, shared, 100 + L + shared)
    xs, ys = values(0), values(3)
    a, b = ints_to_limbs(xs, L), ints_to_limbs(ys, L)
    got = tmont.cios32_mul(_t(a), _t(b), tctx.n_limbs, tctx.n0inv)
    _same(got, jpm.mont_mul_p(jnp.asarray(a), jnp.asarray(b), jn, jn0))
    _same(got, tmont.mont_mul_p(_t(a), _t(b), tctx.n_limbs, tctx.n0inv))
    R = 1 << (LIMB_BITS * L)
    for g, x, y, n in zip(limbs_to_ints(got), xs, ys, ns):
        assert g == (x * y + (-x * y * pow(n, -1, R) % R) * n) // R < 2 * n


@pytest.mark.parametrize("shared", [False, True],
                         ids=["per-element", "shared"])
@pytest.mark.parametrize("L", [13, 12], ids=["odd-L13", "even-L12"])
def test_word_chain_equals_pallas_twin_and_ints(L, shared):
    """K11's order of products: acc = acc0, then acc = acc * factors[j]
    by ``cios32_mul``, one per pre-gathered factor."""
    ns, _, tctx, jn, jn0, values = _case(L, shared, 200 + L + shared)
    acc_vals = values(0)
    fac_vals = [values(j + 1) for j in range(N_WIN)]
    acc0 = ints_to_limbs(acc_vals, L)
    fac = np.stack([ints_to_limbs(v, L) for v in fac_vals], axis=0)
    acc = _t(acc0)
    for j in range(N_WIN):
        acc = tmont.cios32_mul(acc, _t(fac[j]), tctx.n_limbs, tctx.n0inv)
    want = jpm.mont_chain_p(jnp.asarray(fac), jnp.asarray(acc0), jn, jn0)
    _same(acc, want)
    _same(acc, tmont.mont_chain_plain(_t(fac), _t(acc0), tctx.n_limbs,
                                      tctx.n0inv))
    _same(acc, tmont.mont_chain_p(_t(fac), _t(acc0), tctx.n_limbs,
                                  tctx.n0inv))
    R = 1 << (LIMB_BITS * L)
    for b, (g, n) in enumerate(zip(limbs_to_ints(acc), ns)):
        want_b = acc_vals[b]
        for f in fac_vals:
            want_b = (want_b * f[b] + (-want_b * f[b] * pow(n, -1, R) % R)
                      * n) // R
        assert g == want_b < 2 * n


class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _route(monkeypatch, calls):
    """Send kernel launches to `calls`, tensors to a fake device, and make
    the plain twins raise: a CUDA tensor must never reach them."""
    fake = lambda t: t.as_subclass(_OnDevice)

    def call(name, conv, dev):
        calls.append((name, conv))
        return 0

    def twin(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    monkeypatch.setattr(kernels, "_call", call)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    monkeypatch.setattr(tmont, "cios_mul", twin)
    monkeypatch.setattr(tmont, "mont_chain_plain", twin)
    monkeypatch.setattr(torch, "empty",
                        lambda *s, **k: fake(torch.zeros(*s, **{
                            key: v for key, v in k.items()
                            if key != "device"})))
    monkeypatch.setattr(torch, "full",
                        lambda *s, **k: fake(torch.ones(s[0], **{
                            key: v for key, v in k.items()
                            if key not in ("device", "fill_value")})))
    return fake


@pytest.mark.parametrize("shared", [False, True],
                         ids=["per-element", "shared"])
@pytest.mark.parametrize("name", ["mont_mul", "mont_chain"])
def test_k9_k11_wrappers_pass_their_signature_and_raise(name, shared,
                                                        monkeypatch):
    """A CUDA tensor reaches ``pct_mont_mul`` / ``pct_mont_chain`` with
    its argument list and the per-element flag, the launch counter rises,
    and a launch error raises ``RuntimeError`` with no twin run."""
    L = 13
    ns, _, tctx, _, _, values = _case(L, shared, 7 + shared)
    calls = []
    fake = _route(monkeypatch, calls)
    a = fake(torch.from_numpy(ints_to_limbs(values(0), L).astype(np.int32)))
    n0 = tctx.n0inv if isinstance(tctx.n0inv, int) else fake(tctx.n0inv)
    n = fake(tctx.n_limbs)
    if name == "mont_mul":
        run = lambda: tmont.mont_mul_p(a, a, n, n0)
        tail = [int(not shared), L, B]                  # per_elem, L, B
    else:
        fac = fake(torch.stack([a] * 3))
        run = lambda: tmont.mont_chain_p(fac, a, n, n0)
        tail = [int(not shared), 3, L, B]         # per_elem, n_win, L, B
    before = kernels.COUNTS[name]
    out = run()
    assert isinstance(out, _OnDevice) and out.shape == (L, B)
    assert [c for c, _ in calls] == [name]
    conv = calls[0][1]
    assert len(conv) == len(kernels._SIGS[name]) - 1
    assert conv[5:] == tail
    assert kernels.COUNTS[name] == before + 1
    monkeypatch.setattr(kernels, "_call", lambda nm, c, dev: 1)
    with pytest.raises(RuntimeError, match=f"{name} failed to launch"):
        run()
    assert kernels.COUNTS[name] == before + 2
