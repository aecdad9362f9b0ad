"""The port's limb CRT-decrypt engine against the JAX package on the CPU,
at the 256-bit fixed key: the plain twin of kernel K7
(``mm3_exp_shared``) against the Pallas kernel in interpret mode and the
jnp chain, the window plan, and ``decrypt_engine="limb"`` end to end
(state carried across with ``from_jax_state``).  Limbs must be equal;
decrypted plaintexts equal."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pailliercryptolib_python_tpu as jpt
from pailliercryptolib_python_tpu.models import paillier as jsch
from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu.utils import config as jcfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_to_ints)
from pailliercryptolib_python_tpu_torch.utils import config as tcfg

from tests.test_torch_paillier import _jax_state, _mont

CPU = torch.device("cpu")
KD = fixed_key_ints(256)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(jpm3, "INTERPRET", True)
    saved = [(cfg, {k: getattr(cfg.get_config(), k) for k in
                    ("encrypt_engine", "decrypt_engine")})
             for cfg in (jcfg, tcfg)]
    jcfg.set_config(encrypt_engine="rns")
    yield
    for cfg, vals in saved:
        cfg.set_config(**vals)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(port, ref):
    p = (port.cpu().numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


@pytest.mark.parametrize("L", [9, 17, 33, 65, 129, 257, 513])
def test_shared_exp_plan_matches(L):
    assert tm3.shared_exp_window(L) == jpm3.shared_exp_plan(L)[0]


def test_mm3_exp_shared_twin():
    m = KD["p"] ** 2
    L = (m.bit_length() + 2 + 15) // 16
    jctx = jmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=True)
    tctx = tmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=True,
                                   device=CPU)
    plain_ctx = tmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L,
                                        device=CPU)
    window = tm3.shared_exp_window(L)
    e = KD["p"] - 1
    nwd = -(-e.bit_length() // window)
    digits = jmg.exponent_digits([e], nwd, window)[:, 0]
    short = digits[:6]                     # interpret mode is slow
    rng = random.Random(71)
    R = 1 << (LIMB_BITS * L)
    xs = [rng.randrange(m) for _ in range(8)]
    base = ints_to_limbs([x * R % m for x in xs], L)
    w = (jctx.wmu, jctx.wm, jctx.off1, jctx.off2)
    got = tm3.mm3_exp_shared(_t(base), short, tctx, window)   # CPU: twin
    _same(got, jpm3.mm3_exp_shared_p(jnp.asarray(base), jnp.asarray(short),
                                     *w, jctx.one, window=window))
    _same(got, jmg._mont_exp_shared_jnp(jnp.asarray(base),
                                        jnp.asarray(short), jctx, window))
    _same(tmg.mont_exp_shared(_t(base), short, plain_ctx, window), got)
    e_short = int("".join(format(int(d), f"0{window}b") for d in short), 2)
    for g, x in zip(limbs_to_ints(got), xs):
        assert g < 2 * m and g % m == pow(x, e_short, m) * R % m
    full = tmg.mont_exp_shared(_t(base), digits, tctx, window)
    for g, x in zip(limbs_to_ints(tmg.from_mont(full, tctx)), xs):
        assert g == pow(x, e, m)
    bad = short.copy()
    bad[0] = 1 << window
    with pytest.raises(ValueError):
        tm3.mm3_exp_shared(_t(base), bad, tctx, window)
    with pytest.raises(ValueError):        # digits are checked on the host
        tm3.mm3_exp_shared(_t(base), torch.zeros(4, dtype=torch.int32,
                                                 device="meta"), tctx, window)


def test_limb_decrypt_matches_rns_and_jax():
    jpub = jsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"])
    jpriv = jsch.PrivateContext(jpub, KD["p"], KD["q"])
    state = _jax_state(jpub, jpriv)
    # the limb engine's state: mm3 contexts of p^2, q^2 and the digits
    for f, prime in (("sq_p", KD["p"]), ("sq_q", KD["q"])):
        state["priv"][f] = _mont(jmg.MontCtx.for_modulus(
            prime * prime, min_bits=LIMB_BITS * jpriv.Lh, mxu=True))
    state["priv"].update(dec_window=jpriv.dec_window,
                         dig_p=np.asarray(jpriv.dig_p),
                         dig_q=np.asarray(jpriv.dig_q))
    rng = random.Random(72)
    msgs = [rng.randrange(KD["n"]) for _ in range(7)] + [0]
    cts = [(1 + m * KD["n"]) * pow(rng.randrange(1, KD["n"]), KD["n"],
                                   KD["n"] ** 2) % KD["n"] ** 2 for m in msgs]
    rns_pub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                                 KD["randbits"], device=CPU)
    rns_priv = tsch.PrivateContext(rns_pub, KD["p"], KD["q"])
    tcfg.set_config(decrypt_engine="limb")
    jcfg.set_config(decrypt_engine="limb")
    tpub, tpriv = tpt.from_jax_state(state, CPU)
    assert not tpriv.use_rns and tpriv.dec_window == jpriv.dec_window == 5
    _same(tpriv.dig_p, np.asarray(jpriv.dig_p))
    own = tsch.PrivateContext(rns_pub, KD["p"], KD["q"])
    _same(own.dig_p, np.asarray(jpriv.dig_p))
    _same(own.dig_q, np.asarray(jpriv.dig_q))
    jlimb = jsch.PrivateContext(jpub, KD["p"], KD["q"])
    want = jlimb.decrypt_to_ints(jpub.import_cts(cts), 8)
    assert want == msgs
    assert tpriv.decrypt_to_ints(tpub.import_cts(cts), 8) == want
    assert rns_priv.decrypt_to_ints(rns_pub.import_cts(cts), 8) == want
    # through the API: a float round trip on the limb engine
    tpk = tpt.PaillierPublicKey(tpt.ipclPublicKey(None, _context=tpub))
    ipriv = tpt.ipclPrivateKey()
    ipriv._pub, ipriv._ctx = tpk.pubkey, tpriv
    tsk = tpt.PaillierPrivateKey(ipriv)
    x = np.array([2.5, -1.0, 1e6])
    np.testing.assert_allclose(tsk.decrypt(tpk.encrypt(x)), x, rtol=1e-12)
