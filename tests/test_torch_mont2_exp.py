"""The plain twins of kernels K14 and K15 (``ops/mont2.mm2_exp`` /
``mm2_exp_shared``) against the JAX package's Pallas kernels
``pallas_mont2.mm2_exp_p`` / ``mm2_exp_shared_p`` in interpret mode on
the CPU, exactly, and against Python's ``pow``.  A file of their own:
compiling the reference's unrolled chains takes most of their time, and
beside the other ``mont2`` cases it would keep one worker busy for
about a minute and a half."""

import random

import jax.numpy as jnp
import pytest

from pailliercryptolib_python_tpu.ops import pallas_mont2 as jpm2
from pailliercryptolib_python_tpu_torch.ops import mont2 as tm2
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints

from tests.test_torch_mont2 import B, _case, _mont_base, _same, _t


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpm2, "INTERPRET", True)


@pytest.mark.parametrize("win_start", [0, 2])
def test_mm2_exp_twin_matches_pallas(win_start):
    m, L, R, jc, tc, xs, _, _, _ = _case(128, 40, top=False)
    base, one = _mont_base(m, L, R, xs)
    rng = random.Random(41)
    n_win = 3
    es = [rng.getrandbits(4 * n_win) for _ in range(B)]
    es[0] = (1 << (4 * n_win)) - 1
    digits = tmg.exponent_digits(es, n_win, 4)
    got = tm2.mm2_exp(_t(base), digits, tc.W_mu, tc.W_m, _t(one), win_start)
    _same(got, jpm2.mm2_exp_p(jnp.asarray(base), jnp.asarray(digits),
                              jc.W_mu, jc.W_m, jnp.asarray(one),
                              win_start=win_start))
    keep = 4 * (n_win - win_start)
    for g, x, e in zip(limbs_to_ints(got), xs, es):
        assert g % m == pow(x, e & ((1 << keep) - 1), m) * R % m


@pytest.mark.parametrize("window", [4, 5])
def test_mm2_exp_shared_twin_matches_pallas(window):
    m, L, R, jc, tc, xs, _, _, _ = _case(128, 50 + window, top=False)
    base, one = _mont_base(m, L, R, xs)
    e = random.Random(window).getrandbits(20) | (1 << 19)
    n_win = -(-20 // window)
    digits = tmg.exponent_digits([e], n_win, window)[:, 0]
    got = tm2.mm2_exp_shared(_t(base), digits, tc.W_mu, tc.W_m, _t(one),
                             window)
    _same(got, jpm2.mm2_exp_shared_p(jnp.asarray(base), digits, jc.W_mu,
                                     jc.W_m, jnp.asarray(one),
                                     window=window))
    for g, x in zip(limbs_to_ints(got), xs):
        assert g % m == pow(x, e, m) * R % m
