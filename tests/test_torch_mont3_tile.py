"""Kernel K3's tile (``csrc/mm3_tile.cuh``) on the CPU: the unsigned
Toeplitz matrices W_mu, W_m and their mma fragment order, and the plain
PyTorch version of the kernel's steps (``mont3.mm3_mul_tile``: product,
slot sums, recombination), which must equal the port's twin, the JAX
package's Pallas kernel (interpret mode) and Python's integers bit for
bit; plus the K3, K4, K7, K5 and K6 wrappers' calls into the C library, and
the shared memory of a K3, K4 or K7 launch, read from the library."""

import ctypes
import dataclasses
import random
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.ops import mont3, rns
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_to_ints)

CPU = torch.device("cpu")
B = 37                      # not a multiple of the tile's 32 columns
LS = [2, 17, 129, 257]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpm3, "INTERPRET", True)


def _modulus(L: int, seed: int) -> int:
    """An odd modulus with exactly L limbs in its context (R > 4m)."""
    bits = LIMB_BITS * L - 2
    m = random.Random(seed).getrandbits(bits) | (1 << (bits - 1)) | 1
    assert (m.bit_length() + 2 + 15) // 16 == L
    return m


def _operands(L: int, m: int, seed: int):
    """B values below 2m each for a and b, with the edges 0, 1, 2m-1."""
    r = random.Random(seed)
    xs = [r.randrange(2 * m) for _ in range(B)]
    ys = [r.randrange(2 * m) for _ in range(B)]
    xs[0], ys[1] = 0, 1
    xs[2] = ys[2] = xs[3] = 2 * m - 1
    return xs, ys


def _limbs(vals, L):
    return torch.from_numpy(ints_to_limbs(vals, L).astype(np.int32))


@pytest.mark.parametrize("L", LS)
def test_tile_product_equals_twin_jax_and_ints(L):
    m = _modulus(L, L)
    ctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    assert ctx.num_limbs == L
    Wmu, Wm = (torch.from_numpy(w) for w in mont3.tile_weights_np(m, L))
    xs, ys = _operands(L, m, 100 + L)
    a, b = _limbs(xs, L), _limbs(ys, L)
    got = mont3.mm3_mul_tile(a, b, Wmu, Wm)
    assert got.dtype == torch.int32 and got.shape == (L, B)
    assert torch.equal(got, mont3.mm3_mul_plain(a, b, ctx.wmu, ctx.wm,
                                                ctx.off1, ctx.off2))
    jw = jpm3.byte_weights(m, L)
    ref = np.asarray(jpm3.mm3_mul_p(jnp.asarray(a.numpy().astype(np.uint32)),
                                    jnp.asarray(b.numpy().astype(np.uint32)),
                                    *jw, tb=128))
    assert np.array_equal(got.numpy().astype(np.int64), ref.astype(np.int64))
    # Python's integers: a*b*R^-1 mod m, lifted to the unique value < 2m
    R = 1 << (LIMB_BITS * L)
    mu = (-pow(m, -1, R)) % R
    want = [(x * y + (x * y * mu % R) * m) // R for x, y in zip(xs, ys)]
    assert limbs_to_ints(got) == want
    assert all(w < 2 * m and w % m == x * y * pow(R, -1, m) % m
               for w, x, y in zip(want, xs, ys))
    # b as an (L, 1) broadcast
    assert torch.equal(mont3.mm3_mul_tile(a, b[:, :1], Wmu, Wm),
                       mont3.mm3_mul_tile(a, b[:, :1].expand(L, B), Wmu, Wm))


@pytest.mark.parametrize("L", LS)
def test_tile_weights_layout(L):
    m = _modulus(L, L)
    R = 1 << (LIMB_BITS * L)
    mu = (-pow(m, -1, R)) % R
    Wmu, Wm = mont3.tile_weights_np(m, L)
    K = -(-2 * L // 32) * 32
    assert Wmu.dtype == np.uint8 and Wm.dtype == np.uint8
    assert Wmu.shape == (-(-2 * L // 16) * 16, K)
    assert Wm.shape == (-(-4 * L // 16) * 16, K)
    # the Toeplitz bytes, and zero padding past 2L / 4L rows, 2L columns
    mub, mb = mu.to_bytes(2 * L, "little"), m.to_bytes(4 * L, "little")
    for p in (0, 1, 2 * L - 1):
        for i in (0, p // 2, p, 2 * L - 1):
            assert Wmu[p, i] == (mub[p - i] if p >= i else 0)
    for p in (0, 2 * L - 1, 2 * L, 4 * L - 1):
        for i in (0, p // 3, min(p, 2 * L - 1), 2 * L - 1):
            assert Wm[p, i] == (mb[p - i] if p >= i else 0)
    assert not Wmu[2 * L:].any() and not Wmu[:, 2 * L:].any()
    assert not Wm[4 * L:].any() and not Wm[:, 2 * L:].any()
    assert not np.triu(Wmu[:2 * L, :2 * L], 1).any()      # lower triangular
    assert not np.tril(Wm[:4 * L, :2 * L], -2 * L).any()  # a band
    # the context's copies are the same bytes in fragment order
    ctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    for W, Wf in ((Wmu, ctx.wmu_f), (Wm, ctx.wm_f)):
        MT, KS = W.shape[0] // 16, W.shape[1] // 32
        assert Wf.dtype == torch.uint8 and Wf.numel() == W.size
        back = Wf.numpy().reshape(MT, KS, 8, 4, 2, 2, 4).transpose(
            0, 5, 2, 1, 4, 3, 6).reshape(W.shape)
        assert np.array_equal(back, W)


@pytest.mark.parametrize("L", LS)
def test_slot_sums_fit_the_accumulator(L):
    """Every byte slot of W . bytes(x) is below 2L * 255^2 < 2^31, the
    mma's int32, even for all-0xFF operands (and so are the kernel's
    product slots once split into 16-bit parts)."""
    m = _modulus(L, L)
    Wmu, Wm = (torch.from_numpy(w).to(torch.int64)
               for w in mont3.tile_weights_np(m, L))
    x = torch.full((Wmu.shape[1], 1), 255, dtype=torch.int64)
    for W in (Wmu, Wm):
        assert int(torch.matmul(W, x).max()) <= 2 * L * 255 * 255 < (1 << 31)
    assert 2 * 520 * 255 * 255 < (1 << 31)     # up to kMaxLimbs


def test_weights_come_with_the_jax_context_too():
    """A context carried across from the JAX package's arrays gets the
    tile weights from its modulus, like one built by for_modulus."""
    L = 17
    m = _modulus(L, 3)
    ctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    arrays = dict(n_limbs=ctx.n_limbs.numpy(), n0inv=np.array([ctx.n0inv]),
                  r2=ctx.r2.numpy(), one=ctx.one.numpy(),
                  wmu=ctx.wmu.numpy(), wm=ctx.wm.numpy(),
                  off1=ctx.off1.numpy(), off2=ctx.off2.numpy())
    back = tmg.MontCtx.from_arrays(arrays, device=CPU)
    assert torch.equal(back.wmu_f, ctx.wmu_f)
    assert torch.equal(back.wm_f, ctx.wm_f)
    assert tmg.MontCtx.for_modulus(m, mxu=False, device=CPU).wmu_f is None


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


def _fake_digits():
    real = kernels.digit_tensor
    return lambda d, w, dev, below=None: _fake(real(d, w, CPU, below))


def _mm3_call(name):
    """A call of the K3, K4 or K7 wrapper on operands that report a CUDA
    device, and the digit_tensor stand-in it needs."""
    L = 17
    m = _modulus(L, 5)
    ctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    ctx = tmg.MontCtx(*(_fake(v) if isinstance(v, torch.Tensor) else v
                        for v in (getattr(ctx, f.name)
                                  for f in dataclasses.fields(ctx))))
    xs, ys = _operands(L, m, 9)
    a, b = _fake(_limbs(xs, L)), _fake(_limbs(ys, L))
    if name == "mm3_mul":
        return lambda: mont3.mm3_mul(a, b, ctx), kernels.digit_tensor
    if name == "mm3_exp":
        digits = np.arange(3 * B, dtype=np.int32).reshape(3, B) % 16
        return lambda: mont3.mm3_exp(a, digits, ctx, 1), _fake_digits()
    digits = np.array([31, 0, 7], dtype=np.int32)
    return (lambda: mont3.mm3_exp_shared(a, digits, ctx, 5),
            _fake_digits())


def _rns_call(name):
    """A call of the K5 or K6 wrapper on a state that reports a CUDA
    device."""
    KD = fixed_key_ints(256)
    m = KD["p"] ** 2
    tb = rns.RnsBase.for_bits(256, CPU)
    tk = rns.RnsModulus.build(tb, m, (m.bit_length() + 2 + 15) // 16)
    trk.kernel_operands(tb, tk, CPU)
    tk._dev_ops = {k: (_fake(v) if isinstance(v, torch.Tensor) else v)
                   for k, v in tk._dev_ops.items()}
    X = _fake(torch.zeros((tb.CH, B), dtype=torch.int32))
    if name == "rns_exp_shared":
        digits = np.array([31, 0, 7], dtype=np.int32)
        return (lambda: trk.rns_exp_shared_p(X, digits, tb, tk, 5),
                _fake_digits())
    digits = np.arange(3 * B, dtype=np.int32).reshape(3, B) % 16
    return (lambda: trk.rns_exp_elem_p(X, digits, tb, tk, 4),
            _fake_digits())


@pytest.mark.parametrize("name", ["mm3_mul", "mm3_exp", "mm3_exp_shared",
                                  "rns_exp_elem", "rns_exp_shared"])
def test_wrapper_passes_its_signature_and_raises(name, monkeypatch):
    calls = []

    def call(n, conv, dev):
        calls.append((n, conv))
        return 0

    monkeypatch.setattr(kernels, "_call", call)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    run, fake_digits = (_rns_call(name) if name.startswith("rns")
                        else _mm3_call(name))
    monkeypatch.setattr(kernels, "digit_tensor", fake_digits)
    made = []
    monkeypatch.setattr(torch, "empty",
                        lambda *s, **k: made.append(_fake(torch.zeros(*s, **{
                            key: v for key, v in k.items()
                            if key != "device"}))) or made[-1])
    before = kernels.COUNTS[name]
    run()
    assert [n for n, _ in calls] == [name]
    # the stream is appended by _call: the wrapper passes all but it
    assert len(calls[0][1]) == len(kernels._SIGS[name]) - 1
    if name.startswith("rns"):
        # the tile kernels' W1f / W2f, never the per-column E stacks, and
        # the table scratch tile by tile: (tiles, 2^w, CH, 32) uint16
        assert len(made) == 2 and made[1].dtype == torch.int16
        assert made[1].shape[0] == -(-B // trk.TILE_COLS)
        assert made[1].shape[3] == trk.TILE_COLS
    assert kernels.COUNTS[name] == before + 1
    # a launch error propagates; nothing falls back to the twin
    monkeypatch.setattr(kernels, "_call", lambda n, conv, dev: 1)
    with pytest.raises(RuntimeError, match=f"{name} failed to launch"):
        run()


def test_shared_memory_is_read_from_the_library(monkeypatch):
    """``kernels.mm3_smem_bytes`` asks the built library (``csrc/mont3.cu``
    ``mm3_smem``) for the shared memory a launch of K3, K4 or K7 takes,
    as a 64-bit count; nothing in Python recomputes it."""
    asked = []

    class Fn:
        restype = ctypes.c_int

        def __call__(self, L, kernel):
            asked.append((L, kernel, self.restype))
            return 217_088 + kernel

    monkeypatch.setattr(kernels, "lib",
                        lambda: types.SimpleNamespace(pct_mm3_smem=Fn()))
    got = [kernels.mm3_smem_bytes(n, 520)
           for n in ("mm3_mul", "mm3_exp", "mm3_exp_shared")]
    assert got == [217_088, 217_089, 217_090]
    assert asked == [(520, k, ctypes.c_longlong) for k in range(3)]
