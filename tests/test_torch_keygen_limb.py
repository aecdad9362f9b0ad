"""The port's third slice against the JAX package on the CPU, at the
256-bit fixed key: the device-batched base-2 Miller-Rabin of keygen, the
limb comb (ladder, table, fixed-base chain) and the limb encrypt engine,
the fused per-element CRT decrypt, and keys past the RNS bound.

Both packages get the same seeded inputs; limbs, booleans, primes and
ciphertexts must be equal, decoded floats ``np.allclose``.  Every JAX
decrypt here runs 8 columns wide."""

import random
import secrets
from concurrent.futures import Future

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pailliercryptolib_python_tpu as jpt
from pailliercryptolib_python_tpu.models import paillier as jsch
from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.utils import config as jcfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch import device as tdevice
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import (ints_to_limbs,
                                                         limbs_to_ints)
from pailliercryptolib_python_tpu_torch.utils import config as tcfg

from tests.test_torch_paillier import _inject_digits, _jax_state

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
PSEUDOPRIMES = [2047, 3277, 4033, 4681, 8321]    # strong base-2 pseudoprimes


@pytest.fixture(autouse=True)
def _knobs():
    """Both packages' engine knobs restored after each test; the JAX
    package starts on its RNS encrypt engine, as the port's "auto"."""
    saved = [(cfg, {k: getattr(cfg.get_config(), k) for k in
                    ("encrypt_engine", "decrypt_engine", "keygen_device")})
             for cfg in (jcfg, tcfg)]
    jcfg.set_config(encrypt_engine="rns")
    yield
    for cfg, vals in saved:
        cfg.set_config(**vals)


def _same(port, ref):
    p = (port.numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


def _j(t):
    """A port tensor as the JAX package's uint32 array."""
    return jnp.asarray(t.numpy().astype(np.uint32))


def _oracle(c):
    d, r = c - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    return jsch._mr_round(c, d, r, 2)


def _limb_engine(engine="limb"):
    jcfg.set_config(encrypt_engine=engine)
    tcfg.set_config(encrypt_engine=engine)


def _contexts():
    jpub = jsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"])
    tpub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"], device=CPU)
    return jpub, tpub


def _msgs(seed, b=7):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(31), "little") % KD["n"]
            for _ in range(b)]


# ---------------------------------------------------------------------------
# Keygen.
# ---------------------------------------------------------------------------

def test_device_mr_base2_matches_jax_and_host_oracle():
    rng = random.Random(9)
    cands = [fixed_key_ints(256)["p"], fixed_key_ints(256)["q"]]
    cands += [rng.getrandbits(512) | 1 | (1 << 511) for _ in range(6)]
    cands += [tsch.generate_prime(512)] + PSEUDOPRIMES
    got = tsch.device_mr_base2(cands, CPU)
    assert got.dtype == bool and got.shape == (len(cands),)
    assert list(got) == list(np.asarray(jsch.device_mr_base2(cands)))
    assert list(got) == [_oracle(c) for c in cands]
    assert all(got[-len(PSEUDOPRIMES) - 1:])         # a prime, then the
    assert got[:2].all()                               # pseudoprimes


def _seeded_secrets(monkeypatch, seed):
    """secrets.randbits / randbelow from one seeded source (both packages
    call them through the same module)."""
    rng = random.Random(seed)
    monkeypatch.setattr(secrets, "randbits", rng.getrandbits)
    monkeypatch.setattr(secrets, "randbelow", rng.randrange)


def test_generate_prime_on_device_path_matches_jax(monkeypatch):
    jcfg.set_config(keygen_device="1")
    tcfg.set_config(keygen_device="1")
    _seeded_secrets(monkeypatch, 77)
    p_port = tsch.generate_prime(256, device=CPU)
    _seeded_secrets(monkeypatch, 77)
    p_jax = jsch.generate_prime(256)
    assert p_port == p_jax and p_port.bit_length() == 256
    assert tsch.is_probable_prime(p_port)


def test_keygen_device_passthrough_and_worker_init(monkeypatch):
    """generate_keypair(device=...) reaches the device-batched round;
    pool workers pin the port's default device to the CPU."""
    tcfg.set_config(keygen_device="1")
    monkeypatch.setattr(tcfg.get_config(), "keygen_parallel", "0")
    seen = []
    real = tsch.device_mr_base2
    monkeypatch.setattr(tsch, "device_mr_base2",
                        lambda c, d=None: seen.append(d) or real(c, d))
    pk, sk = tpt.PaillierKeypair.generate_keypair(256, device=CPU)
    assert seen and all(d == CPU for d in seen)
    x = np.array([0.25, -7.5, 1e3])
    np.testing.assert_allclose(sk.decrypt(pk.encrypt(x)), x, rtol=1e-12)
    monkeypatch.setattr(tdevice, "_default", torch.device("cuda"))
    tsch._prime_worker_init()
    assert tdevice.get_device() == CPU


class _InlinePool:
    """The prime pool's stand-in: runs each call where it is submitted
    and records its function; `broken` refuses ``pow`` as a lost pool
    would."""

    def __init__(self, broken=False):
        self.fns, self.broken = [], broken

    def submit(self, fn, *args):
        if self.broken and fn is pow:
            raise RuntimeError("the pool is gone")
        self.fns.append(fn)
        fut = Future()
        fut.set_result(fn(*args))
        return fut


def test_keygen_hs_in_the_pool_equals_serial(monkeypatch):
    """With the prime pool on, keygen submits the two half-width pows of
    the DJN hs to it, as the reference does; serially, or when the pool
    raises, it runs them in place.  With the primes and x fixed, every
    path returns hs = h^n mod n^2, h = -x^2 mod n."""
    p, q = KD["p"], KD["q"]
    n = p * q

    def keygen(parallel, pool):
        primes = iter([p, q])
        monkeypatch.setattr(tsch, "generate_prime",
                            lambda *a, **k: next(primes))
        monkeypatch.setattr(secrets, "randbelow", lambda k: k // 3)
        monkeypatch.setattr(tcfg.get_config(), "keygen_parallel", parallel)
        monkeypatch.setattr(tsch, "_pool_usable", lambda: True)
        monkeypatch.setattr(tsch, "_prime_pool", lambda: pool)
        return tsch.generate_key_ints(n.bit_length())["hs"]

    serial = keygen("0", None)
    pool = _InlinePool()
    assert keygen("1", pool) == serial
    assert pool.fns[2:] == [pow, pow]
    assert keygen("1", _InlinePool(broken=True)) == serial
    x = (n - 1) // 3 + 1
    assert serial == pow(-(x * x) % n, n, n * n)


# ---------------------------------------------------------------------------
# The limb comb and the limb encrypt engine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("acc0", [False, True], ids=["plain", "acc0"])
def test_limb_comb_matches_jax(acc0):
    rng = random.Random(31)
    n = rng.getrandbits(256) | 1 | (1 << 255)
    jctx = jmg.MontCtx.for_modulus(n)
    tctx = tmg.MontCtx.for_modulus(n, device=CPU)
    L = tctx.num_limbs
    g = ints_to_limbs([rng.randrange(n)], L)
    nbits, window = 36, 8                     # a clipped last window
    jg = jmg.to_mont(jnp.asarray(g), jctx)
    tg = tmg.to_mont(torch.from_numpy(g.astype(np.int32)), tctx)
    jlad = jmg.build_pow2_ladder(jg, jctx, nbits)
    tlad = tmg.build_pow2_ladder(tg, tctx, nbits)
    _same(tlad, jlad)
    jcomb = jmg.build_comb_table(jlad, jctx, window)
    tcomb = tmg.build_comb_table(tlad, tctx, window)
    _same(tcomb, jcomb)
    assert tcomb.shape == (5, L, 256)
    es = [rng.getrandbits(nbits) for _ in range(5)] + [0, 1]
    digits = jmg.exponent_digits(es, 5, window, msb_first=False)
    cs = [rng.randrange(n) for _ in es]
    if acc0:
        a0 = ints_to_limbs(cs, L)
        jacc = jmg.to_mont(jnp.asarray(a0), jctx)
        tacc = tmg.to_mont(torch.from_numpy(a0.astype(np.int32)), tctx)
    else:
        jacc = tacc = None
    jout = jmg.mont_exp_fixed_base(jcomb, jnp.asarray(digits), jctx,
                                   acc0=jacc)
    tout = tmg.mont_exp_fixed_base(tcomb, digits, tctx, acc0=tacc)
    _same(tout, jout)
    want = [pow(limbs_to_ints(g)[0], e, n) * (c if acc0 else 1) % n
            for e, c in zip(es, cs)]
    assert limbs_to_ints(tmg.from_mont(tout, tctx)) == want


def test_limb_encrypt_engine_matches_jax_and_rns(monkeypatch):
    jpub, tpub = _contexts()              # RNS on both (the fixture)
    _inject_digits(monkeypatch, jpub, tpub)
    msgs = _msgs(5)
    rns_ct = tpub.export_cts(tpub.encrypt(msgs), 7)
    _limb_engine()
    assert tpub._rns_enc_plan() is None
    tct = tpub.encrypt(msgs)
    jct = jpub.encrypt(msgs)
    _same(tct, jct)                                   # Montgomery limbs
    _same(tpub.comb_table, jpub.comb_table)
    assert tpub.export_cts(tct, 7) == jpub.export_cts(jct, 7) == rns_ct
    # re-randomization on the limb engine, same digits as JAX
    _same(tpub.obfuscate(tct), jpub.obfuscate(jct))
    tpub._drop_comb()
    assert tpub._comb is None and tpub._comb_rns is None


def test_apply_obfuscator_on_limb_engine(monkeypatch):
    _limb_engine()
    jpk = jpt.PaillierPublicKey(jpt.ipclPublicKey(
        KD["n"], KD["bits"], True, KD["hs"], KD["randbits"]))
    tpk = tpt.PaillierPublicKey(tpt.ipclPublicKey(
        KD["n"], KD["bits"], True, KD["hs"], KD["randbits"], device=CPU))
    _inject_digits(monkeypatch, jpk.pubkey.context, tpk.pubkey.context)
    tsk = tpt.PaillierPrivateKey(tpk, KD["p"], KD["q"])
    x = np.array([1.5, -2.25, 1e4, 0.0])
    jx, tx = jpk.encrypt(x), tpk.encrypt(x)
    before = [v.value() for v in tx.ciphertextBN()]
    assert before == [v.value() for v in jx.ciphertextBN()]
    raw = tsk.raw_decrypt(tx)
    tx.apply_obfuscator()
    jx.apply_obfuscator()
    after = [v.value() for v in tx.ciphertextBN()]
    assert after == [v.value() for v in jx.ciphertextBN()]
    assert all(a != b for a, b in zip(after, before))
    assert tsk.raw_decrypt(tx) == raw
    np.testing.assert_allclose(tsk.decrypt(tx), x, rtol=1e-12)


# ---------------------------------------------------------------------------
# The fused per-element CRT decrypt.
# ---------------------------------------------------------------------------

def test_fused_crt_stage_matches_jax_and_halves(monkeypatch):
    jpub, tpub = _contexts()
    _inject_digits(monkeypatch, jpub, tpub)
    jpriv = jsch.PrivateContext(jpub, KD["p"], KD["q"])
    tpriv = tsch.PrivateContext(tpub, KD["p"], KD["q"])
    _same(tpriv.exp_digits_pq, jpriv.exp_digits_pq)
    assert tpriv.n_win_dec == jpriv.n_win_dec
    msgs = _msgs(6)
    ct = tpub.encrypt(msgs)
    B = ct.shape[1]
    base_m = tsch._crt_stage_reduce(ct, tpriv)
    _same(base_m, jpriv._stage_reduce(_j(ct)))
    sq = tpriv._sq_ctx(B)
    assert sq is tpriv._sq_ctx(B) and sq.n_limbs.shape == (tpriv.Lh, 2 * B)
    _same(sq.n_limbs, jpriv._sq_ctx(B).n_limbs)
    u = tsch._crt_stage_exp(base_m, sq, tpriv.exp_digits_pq,
                            tpriv.n_win_dec)
    _same(u, jsch._crt_stage_exp(_j(base_m),
                                 jpriv._sq_ctx(B),
                                 jnp.asarray(jpriv.exp_digits_pq),
                                 jpriv.n_win_dec))
    halves = torch.cat([
        tsch._crt_stage_exp_half(base_m[:, :B], tpriv._sq_p, tpriv.dig_p,
                                 tpriv.dec_window),
        tsch._crt_stage_exp_half(base_m[:, B:], tpriv._sq_q, tpriv.dig_q,
                                 tpriv.dec_window)], dim=1)
    _same(u, halves)
    assert limbs_to_ints(tsch._crt_stage_recombine(u, tpriv))[:7] == msgs


def test_limb_decrypt_on_weightless_contexts(monkeypatch):
    jpub, tpub = _contexts()
    _inject_digits(monkeypatch, jpub, tpub)
    jcfg.set_config(decrypt_engine="limb")
    tcfg.set_config(decrypt_engine="limb")
    jpriv = jsch.PrivateContext(jpub, KD["p"], KD["q"])
    tpriv = tsch.PrivateContext(tpub, KD["p"], KD["q"])
    assert tpriv._sq_p.wmu is None and not tpriv.use_rns
    msgs = _msgs(7)
    ct = tpub.encrypt(msgs)
    assert tpriv.decrypt_to_ints(ct, 7) == \
        jpriv.decrypt_to_ints(_j(ct), 7) == msgs
    # state carried across: the limb comb and the exponent digits
    jcfg.set_config(decrypt_engine="auto")
    state = _jax_state(jpub, jsch.PrivateContext(jpub, KD["p"], KD["q"]))
    state["pub"]["comb"] = np.asarray(jpub.comb_table)
    state["priv"]["exp_digits_pq"] = np.asarray(jpriv.exp_digits_pq)
    cpub, cpriv = tpt.from_jax_state(state, CPU)
    _same(cpub._comb, jpub.comb_table)
    _same(cpriv.exp_digits_pq, jpriv.exp_digits_pq)
    _limb_engine()
    _inject_digits(monkeypatch, jpub, cpub)
    _same(cpub.encrypt(msgs), jpub.encrypt(msgs))
    assert cpriv.decrypt_to_ints(cpub.encrypt(msgs), 7) == msgs


# ---------------------------------------------------------------------------
# Keys past the RNS bound.
# ---------------------------------------------------------------------------

def test_key_past_rns_bound_runs_on_limb_engines(monkeypatch):
    """n^2 (514 bits) past a lowered bound, p^2 (256 bits) within it:
    the public side takes the limb engines, the RNS decrypt still runs;
    below p^2 the RNS decrypt raises and the limb decrypt serves."""
    monkeypatch.setattr(tsch, "RNS_MAX_MBITS", 400)
    jpub, tpub = _contexts()
    assert tpub.rns_plan() is None and tpub._rns_enc_plan() is None
    assert tpub._rns_mul_plan() is None
    jcfg.set_config(encrypt_engine="limb")      # the JAX package's twin
    _inject_digits(monkeypatch, jpub, tpub)
    msgs = _msgs(8)
    tct = tpub.encrypt(msgs)
    jct = jpub.encrypt(msgs)
    assert tpub.export_cts(tct, 7) == jpub.export_cts(jct, 7)
    tsum = tpub.add_ct(tct, tct)
    es = [3, 0, 1, 1 << 40, 12345, 7, 2]
    tprod = tpub.mul_pt(tct, es + [0])
    assert tpub.export_cts(tsum, 7) == jpub.export_cts(
        jpub.add_ct(jct, jct), 7)
    assert tpub.export_cts(tprod, 7) == jpub.export_cts(
        jpub.mul_pt(jct, es + [0]), 7)
    tpriv = tsch.PrivateContext(tpub, KD["p"], KD["q"])
    assert tpriv.use_rns
    n = KD["n"]
    assert tpriv.decrypt_to_ints(tct, 7) == msgs
    assert tpriv.decrypt_to_ints(tsum, 7) == [2 * m % n for m in msgs]
    assert tpriv.decrypt_to_ints(tprod, 7) == [m * e % n for m, e in
                                               zip(msgs, es)]
    monkeypatch.setattr(tsch, "RNS_MAX_MBITS", 200)
    with pytest.raises(NotImplementedError, match="decrypt_engine='limb'"):
        tsch.PrivateContext(tpub, KD["p"], KD["q"])
    tcfg.set_config(decrypt_engine="limb")
    assert tsch.PrivateContext(tpub, KD["p"], KD["q"]).decrypt_to_ints(
        tprod, 7) == [m * e % n for m, e in zip(msgs, es)]
