"""The port's limb core (pailliercryptolib_python_tpu_torch/ops/limb.py)
against the JAX package's, on the CPU: exact equality of every limb.

Inputs come from a seeded numpy generator and go through both
implementations as numpy arrays; the port is pinned to the CPU, where its
functions are the plain PyTorch ones.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pailliercryptolib_python_tpu.ops import limb as jl
from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import reduction as jred
from pailliercryptolib_python_tpu_torch.ops import limb as tl
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops import reduction as tred

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = port.cpu().numpy().astype(np.int64) if isinstance(
        port, torch.Tensor) else np.asarray(port).astype(np.int64)
    assert p.shape == np.asarray(ref).shape
    assert np.array_equal(p, np.asarray(ref).astype(np.int64))


def _limbs(rng, L, B, top=None):
    a = rng.integers(0, 1 << 16, size=(L, B), dtype=np.int64)
    if top is not None:
        a[-1] = rng.integers(0, top, size=B)
    return a.astype(np.uint32)


@pytest.mark.parametrize("L,B", [(1, 3), (7, 5), (33, 9), (129, 4)])
def test_normalize_redundant(L, B):
    rng = np.random.default_rng(10 + L)
    t = rng.integers(0, 1 << 32, size=(L, B), dtype=np.uint64)
    t[:, 0] = 0xFFFFFFFF                       # boundary column
    t[:, 1 % B] = 0xFFFF                       # long carry chains
    t = t.astype(np.uint32)
    _same(tl.normalize(_t(t)), jl.normalize(jnp.asarray(t)))


@pytest.mark.parametrize("L", [5, 17, 65])
def test_compare_sub_condsub(L):
    rng = np.random.default_rng(L)
    a = _limbs(rng, L, 12)
    b = _limbs(rng, L, 12)
    b[:, :3] = a[:, :3]                        # equal columns
    b[0, 3] += 1 if b[0, 3] < 0xFFFF else -1   # differ only in limb 0
    _same(tl.compare_ge(_t(a), _t(b)),
          jl.compare_ge(jnp.asarray(a), jnp.asarray(b)))
    _same(tl.sub_mod_base(_t(a), _t(b)),
          jl.sub_mod_base(jnp.asarray(a), jnp.asarray(b)))
    m = b[:, :1]
    _same(tl.cond_sub(_t(a), _t(m)), jl.cond_sub(jnp.asarray(a),
                                                 jnp.asarray(m)))
    _same(tl.big_add(_t(a), _t(b)), jl.big_add(jnp.asarray(a),
                                               jnp.asarray(b)))


@pytest.mark.parametrize("La,Lb,out", [(9, 9, None), (17, 1, 17),
                                       (65, 65, 65), (33, 17, 40)])
def test_big_mul(La, Lb, out):
    rng = np.random.default_rng(La * 100 + Lb)
    a = _limbs(rng, La, 6)
    b = _limbs(rng, Lb, 1 if Lb == 1 else 6)
    a[:, 0] = 0xFFFF                           # maximal limbs
    _same(tl.big_mul(_t(a), _t(b), out_limbs=out),
          jl.big_mul(jnp.asarray(a), jnp.asarray(b), out_limbs=out))
    if out is not None:
        _same(tl.big_mul_low(_t(a), _t(b), out),
              jl.big_mul_low(jnp.asarray(a), jnp.asarray(b), out))


def test_int_limb_converters():
    rng = np.random.default_rng(3)
    xs = [int.from_bytes(rng.bytes(40), "little") for _ in range(7)] + [0, 1]
    for x in xs[:3]:
        assert np.array_equal(tl.int_to_limbs(x, 21), jl.int_to_limbs(x, 21))
        assert tl.limbs_to_int(tl.int_to_limbs(x, 21)) == x
    arr = tl.ints_to_limbs(xs, 21)
    assert np.array_equal(arr, jl.ints_to_limbs(xs, 21))
    assert tl.limbs_to_ints(_t(arr)) == jl.limbs_to_ints(arr) == xs
    red = arr.astype(np.int64)
    red[0] += 1 << 20                          # redundant limbs
    assert tl.limbs_to_ints(red) == jl.limbs_to_ints(red.astype(np.uint32))


def test_exact_div():
    rng = np.random.default_rng(4)
    d = int.from_bytes(rng.bytes(16), "little") | 1
    Lq = 10
    qs = [int.from_bytes(rng.bytes(18), "little") for _ in range(5)]
    x = tl.ints_to_limbs([d * q for q in qs], 20)
    dinv = tl.int_to_limbs(pow(d, -1, 1 << (16 * Lq)), Lq)[:, None]
    got = tred.exact_div(_t(x), _t(dinv), Lq)
    _same(got, jred.exact_div(jnp.asarray(x), jnp.asarray(dinv), Lq))
    assert tl.limbs_to_ints(got) == [q % (1 << (16 * Lq)) for q in qs]


@pytest.mark.parametrize("window", [3, 4, 5, 6, 8, 12])
def test_exponent_digits(window):
    rng = np.random.default_rng(window)
    exps = [int.from_bytes(rng.bytes(30), "little") for _ in range(6)] + [0]
    n_win = -(-240 // window)
    for msb in (True, False):
        assert np.array_equal(
            tmg.exponent_digits(exps, n_win, window, msb_first=msb),
            jmg.exponent_digits(exps, n_win, window, msb_first=msb))
