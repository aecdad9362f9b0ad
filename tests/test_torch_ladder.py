"""The port's host side at the key ladder of the reference's own
configurations (1024-, 3072- and 4096-bit keys) against the JAX package,
on the CPU.

Host-built constants must equal the JAX package's exactly: the RNS bases
of n^2 and p^2 (mbits 1024, 2064, 3072, 4096, 6160, 8208), the RNS
moduli of n^2, p^2 and q^2 with their kernel operand bundles (and the
CS bounds of fault C4 at k up to 519), the Montgomery contexts and their
byte weights at L = 65 to 513, the comb window each package picks under
the same budget and engine knobs (12 at 1024 and 3072 bits, 11 at 4096
at the accelerator's window 12), and the private context's digits and
schedules; ``from_jax_state`` and the pickle state tuples at 3072 bits.
Then one encrypt (injected obfuscator digits) -> ``+`` -> ``x * w``
(mixed signs) -> decrypt at 3072 bits, B=4, through the plain twins:
ciphertexts equal Python's ``pow``, the plaintexts Python's own Paillier
decryption and numpy (rtol 1e-12); under ``-m slow`` (~20 s of the JAX
package's CPU compiles at 3072 bits) also the JAX package's ciphertexts
after ``export_cts`` (fault C3).

Keys come from a seeded prime search in this file (``random.Random``;
the seeds pick short searches), not from the package's fixtures.
"""

import random

import numpy as np
import pytest
import torch

import pailliercryptolib_python_tpu as jpt
from pailliercryptolib_python_tpu.models import paillier as jsch
from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_mont3 as jpm3
from pailliercryptolib_python_tpu.ops import pallas_rns as jpr
from pailliercryptolib_python_tpu.ops import rns as jr
from pailliercryptolib_python_tpu.utils import config as jcfg

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.fixedpoint import (decode_vector,
                                                          encode_vector)
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops import rns as tr
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk
from pailliercryptolib_python_tpu_torch.utils import config as tcfg

CPU = torch.device("cpu")
BITS = (1024, 3072, 4096)
# seeds of a short search for each prime of each key size
SEEDS = {1024: (2, 6), 3072: (3, 31), 4096: (20, 5)}
SMALL = [s for s in range(3, 2000) if all(s % d for d in range(2, s))]


def _prime(bits: int, seed: int) -> int:
    """The first candidate of a seeded search (top two bits set, odd, no
    factor below 2000) that passes base-2 Fermat and the port's
    Miller-Rabin."""
    r = random.Random(seed)
    while True:
        c = r.getrandbits(bits) | (3 << (bits - 2)) | 1
        if all(c % s for s in SMALL) and pow(2, c - 1, c) == 1:
            assert tsch.is_probable_prime(c)
            return c


@pytest.fixture(scope="module")
def keys():
    """bits -> dict(p, q, n, hs, randbits) of a DJN key."""
    out = {}
    for bits in BITS:
        p, q = (_prime(bits // 2, s) for s in SEEDS[bits])
        n = p * q
        assert n.bit_length() == bits
        x = random.Random(bits).randrange(2, n - 1)
        hs = pow((-(x * x)) % n, n, n * n)
        out[bits] = dict(p=p, q=q, n=n, hs=hs, randbits=bits // 2, bits=bits)
    return out


@pytest.fixture
def knobs():
    """Both packages' config knobs, restored after the test."""
    jc, tc = jcfg.get_config(), tcfg.get_config()
    names = ("comb_window_cpu", "encrypt_engine", "decrypt_engine")
    saved = ({k: getattr(jc, k) for k in names},
             {k: getattr(tc, k) for k in names})

    def both(**kw):
        jcfg.set_config(**kw)
        tcfg.set_config(**kw)

    both(encrypt_engine="rns")
    yield both
    jcfg.set_config(**saved[0])
    tcfg.set_config(**saved[1])


def _same(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape and np.array_equal(p.astype(np.int64),
                                                 r.astype(np.int64))


def _moduli(k):
    return {"n^2": k["n"] ** 2, "p^2": k["p"] ** 2, "q^2": k["q"] ** 2}


@pytest.mark.parametrize("mbits", [1024, 2064, 3072, 4096, 6160, 8208])
def test_rns_base_equals_jax(mbits):
    tb, jb = tr.RnsBase.for_bits(mbits, CPU), jr.RnsBase.for_bits(mbits)
    assert (tb.k, tb.M, tb.Mp, tb.m_r, tb.CH) == (jb.k, jb.M, jb.Mp, jb.m_r,
                                                 jb.CH)
    assert tb.mods_B_int == jb.mods_B_int and tb.mods_Bp_int == jb.mods_Bp_int
    for f in ("mods", "n0", "n032", "C1_lo", "C1_hi", "C2_lo", "C2_hi",
              "W_lo", "W_hi", "K1g", "K2g", "exit_c", "K2s", "K2sh", "K1gs",
              "K1gsh", "D1_lo", "D1_hi", "D2_lo", "D2_hi"):
        _same(getattr(tb, f), getattr(jb, f))
    # fault C4: the CS correction rows are bounded by 65280*k < 2^31,
    # which the tile routines' accumulators rely on, at every width
    st = trk._pack_static(mbits)
    for col in (10, 11):
        cs = st["vec"][:, col].astype(np.int64)
        assert cs.max() <= 65280 * tb.k < (1 << 31)
    assert 2 * tb.k * 255 * 255 < (1 << 31)


@pytest.mark.parametrize("bits", BITS)
def test_rns_moduli_and_operands_equal_jax(bits, keys):
    k = keys[bits]
    for name, m in _moduli(k).items():
        mbits = -(-(2 * bits + 2 if name == "n^2" else m.bit_length())
                  // 16) * 16
        L = (m.bit_length() + 2 + 15) // 16
        tb, jb = tr.RnsBase.for_bits(mbits, CPU), jr.RnsBase.for_bits(mbits)
        tk, jk = tr.RnsModulus.build(tb, m, L), jr.RnsModulus.build(jb, m, L)
        for f in tr.KEY_ARRAYS:
            _same(getattr(tk, f), getattr(jk, f))
        tp, jp = trk.pack(mbits, m), jpr.pack(mbits, m)
        assert tp.keys() >= jp.keys()
        for f, ref in jp.items():
            if isinstance(ref, int):
                assert tp[f] == ref, f
            else:
                _same(tp[f], ref)
        # the tile weights W1 / W2: the E stacks' bytes, interleaved
        ops = trk.kernel_operands(tb, tk, CPU)
        o, KP = tb.k + 1, ops["KP"]
        E1 = np.asarray(tp["E1"]).astype(np.int64) + 128
        W1 = ops["W1"].numpy().astype(np.int64)
        assert W1.shape == (-(-2 * o // 16) * 16, 2 * KP)
        assert np.array_equal(W1[0:2 * o:2, :tb.k], E1[:o])
        assert np.array_equal(W1[1:2 * o:2, KP:KP + tb.k], E1[3 * o:])
        assert not W1[2 * o:].any() and not W1[:, tb.k:KP].any()


@pytest.mark.parametrize("bits", BITS)
def test_mont_contexts_and_byte_weights_equal_jax(bits, keys):
    k = keys[bits]
    want_L = {1024: (129, 65), 3072: (385, 193), 4096: (513, 257)}[bits]
    for m, L_expect in zip((k["n"] ** 2, k["p"] ** 2), want_L):
        tc = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
        jc = jmg.MontCtx.for_modulus(m)
        assert tc.num_limbs == jc.num_limbs == L_expect
        L = tc.num_limbs
        for f in ("n_limbs", "r2", "one"):
            _same(getattr(tc, f), getattr(jc, f))
        assert int(tc.n0inv) == int(np.asarray(jc.n0inv).reshape(-1)[0])
        for port, ref in zip((tc.wmu, tc.wm, tc.off1, tc.off2),
                             jpm3.byte_weights(m, L)):
            _same(port, ref)
        # the Toeplitz tile weights of K3 / K4 / K7 at this L
        Wmu, Wm = tm3.tile_weights_np(m, L)
        K = -(-2 * L // 32) * 32
        assert Wmu.shape == (-(-2 * L // 16) * 16, K)
        assert Wm.shape == (-(-4 * L // 16) * 16, K)
        mb = m.to_bytes(4 * L, "little")
        assert [Wm[p, 0] for p in range(0, 4 * L, 97)] == \
            [mb[p] for p in range(0, 4 * L, 97)]
        assert not Wm[4 * L:].any() and not Wm[:, 2 * L:].any()
        assert L <= 520          # K3's kMaxLimbs (csrc/mont3.cu)


@pytest.mark.parametrize("bits,window", [(1024, 12), (3072, 12),
                                         (4096, 11)])
def test_comb_window_at_the_accelerator_width(bits, window, keys, knobs):
    """The accelerator's window (comb_window_tpu, 12) given to both
    packages: the RNS comb must fit half the 4 GiB budget, so 4096 bits
    shrink to 11 (187 windows, 1.59 GB); 3072 bits keep 12 (1.63 GB)."""
    k = keys[bits]
    cfg = tcfg.get_config()
    knobs(comb_window_cpu=cfg.comb_window_tpu)
    assert cfg.comb_window_tpu == 12
    jp = jsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"])
    tp = tsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"],
                            device=CPU)
    assert tp.comb_window == jp.comb_window == window
    CH = tp.rns_plan()[0].CH
    assert CH == {1024: 263, 3072: 779, 4096: 1039}[bits]
    n_win = -(-k["randbits"] // window)
    size = n_win * CH * (1 << window) * 4
    assert size <= cfg.comb_hbm_budget_bytes // 2
    assert tp._rns_enc_plan() is not None and jp._rns_enc_plan() is not None
    if bits == 4096:
        assert (n_win, size) == (187, 1_591_648_256)
        over = -(-k["randbits"] // 12) * CH * (1 << 12) * 4
        assert over > cfg.comb_hbm_budget_bytes // 2


def _mont(ctx):
    return {f: np.asarray(getattr(ctx, f)) for f in
            ("n_limbs", "n0inv", "r2", "one", "wmu", "wm", "off1", "off2")
            if getattr(ctx, f) is not None}


@pytest.mark.parametrize("bits", BITS)
def test_private_context_digits_and_schedules_equal_jax(bits, keys, knobs):
    k = keys[bits]
    jp = jsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"])
    tp = tsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"],
                            device=CPU)
    jv, tv = jsch.PrivateContext(jp, k["p"], k["q"]), \
        tsch.PrivateContext(tp, k["p"], k["q"])
    assert (tv.Lh, tv.Lq, tv.n_win_dec, tv.rns_base.CH) == \
        (jv.Lh, jv.Lq, jv.n_win_dec, jv.rns_base.CH)
    assert tv.rns_base.CH == {1024: 133, 3072: 389, 4096: 519}[bits]
    assert (tv.rns_sched_window, tv.dec_window) == \
        (jv.rns_sched_window, jv.dec_window)
    for f in ("exp_digits_pq", "dig_p", "dig_q", "rdig_p", "rdig_q",
              "rsched_p", "rsched_q", "Cp_lo", "Cp_hi", "Cq_lo", "Cq_hi",
              "f2_p", "f2_q", "pinv_R", "qinv_R", "hpR", "hqR", "pinvqR",
              "p_limbs", "q_limbs"):
        _same(getattr(tv, f), getattr(jv, f))
    for f in tr.KEY_ARRAYS:
        _same(getattr(tv.rns_p, f), getattr(jv.rns_p, f))
        _same(getattr(tv.rns_q, f), getattr(jv.rns_q, f))
    for f in ("_sq_p", "_sq_q", "_p_ctx", "_q_ctx"):
        for g, ref in _mont(getattr(jv, f)).items():
            got = getattr(getattr(tv, f), g)
            _same(got if g != "n0inv" else [int(got)], np.reshape(ref, -1)
                  if g == "n0inv" else ref)
    # the K2 schedule replays p-1 exactly
    w = tv.rns_sched_window
    assert tv.rsched_p.max() <= 1 << (w - 1)


def test_from_jax_state_and_pickles_at_3072(keys, knobs, monkeypatch):
    k = keys[3072]
    jp = jsch.PublicContext(k["n"], 3072, True, k["hs"], k["randbits"])
    jv = jsch.PrivateContext(jp, k["p"], k["q"])
    base, key = jp._rns_enc_plan()
    rkey = lambda x: {f: np.asarray(getattr(x, f)) for f in tr.KEY_ARRAYS}
    priv = {f: np.asarray(getattr(jv, f)) for f in
            ("Cp_lo", "Cp_hi", "Cq_lo", "Cq_hi", "f2_p", "f2_q", "pinv_R",
             "qinv_R", "hpR", "hqR", "pinvqR", "p_limbs", "q_limbs",
             "rsched_p", "rsched_q", "dig_p", "dig_q", "exp_digits_pq")}
    priv.update(sq_p=_mont(jv._sq_p), sq_q=_mont(jv._sq_q),
                p_ctx=_mont(jv._p_ctx), q_ctx=_mont(jv._q_ctx),
                rns_p=rkey(jv.rns_p), rns_q=rkey(jv.rns_q),
                pack_p=jpr.pack(jv.rns_base.mbits, jv.rns_p.m),
                pack_q=jpr.pack(jv.rns_base.mbits, jv.rns_q.m),
                rns_sched_window=jv.rns_sched_window,
                dec_window=jv.dec_window)
    state = dict(n=k["n"], p=k["p"], q=k["q"], hs=k["hs"], bits=3072,
                 randbits=k["randbits"],
                 pub=dict(ctx=_mont(jp.ctx), rns_key=rkey(key),
                          rns_pack=jpr.pack(base.mbits, key.m),
                          comb_window=jp.comb_window),
                 priv=priv)
    tp, tv = tpt.from_jax_state(state, CPU)
    assert (tp.L, tp.comb_window, tv.Lh) == (385, jp.comb_window, 193)
    _same(tp.ctx.one, jp.ctx.one)
    _same(tv.rsched_q, jv.rsched_q)
    # the pickle state tuples of keys cross both ways
    from pailliercryptolib_python_tpu_torch import device
    monkeypatch.setattr(device, "_default", CPU)
    jpub = jpt.ipclPublicKey(k["n"], 3072, True, k["hs"], k["randbits"])
    tkey = tpt.ipclPublicKey.__new__(tpt.ipclPublicKey)
    tkey.__setstate__(jpub.__getstate__())
    assert tkey.__getstate__() == jpub.__getstate__()
    tpk = tpt.PaillierPublicKey(tkey)
    jsk = jpt.PaillierPrivateKey(jpt.PaillierPublicKey(jpub), k["p"], k["q"])
    tsk = tpt.PaillierPrivateKey(tpk, k["p"], k["q"])
    assert tsk.prikey.__getstate__() == jsk.prikey.__getstate__()


def _digits(n_win, window, B):
    rng = np.random.default_rng(3072 + B)
    return rng.integers(0, 1 << window, size=(n_win, B)).astype(np.uint16)


def _cts(enc):
    return [v.value() for v in enc.ciphertextBN()]


def _inputs():
    rng = np.random.default_rng(3072)
    x, y = rng.uniform(-1e3, 1e3, 4), rng.uniform(-1e3, 1e3, 4)
    wt = rng.uniform(-1.0, 1.0, 4)
    wt[:2] = -np.abs(wt[:2])
    wt[2:] = np.abs(wt[2:])
    return x, y, wt


@pytest.fixture(scope="module")
def round_trip(keys):
    """The port's encrypt (injected digits) -> + -> x * w (mixed signs)
    -> decrypt at 3072 bits, B=4, on its plain twins, at comb window 4
    (a small comb on the CPU): the ciphertexts as ints, their exponents
    and the decrypted floats."""
    k = keys[3072]
    cfg = tcfg.get_config()
    saved = (cfg.comb_window_cpu, cfg.encrypt_engine, torch.get_num_threads())
    tcfg.set_config(comb_window_cpu=4, encrypt_engine="rns")
    # one thread: under the parallel test run, torch's intra-op pools of
    # the workers oversubscribe the cores (this fixture took 1,075 s of a
    # whole run at the default thread count, 15 s alone)
    torch.set_num_threads(1)
    try:
        tpk = tpt.PaillierPublicKey(tpt.ipclPublicKey(
            k["n"], 3072, True, k["hs"], k["randbits"], device=CPU))
        tsk = tpt.PaillierPrivateKey(tpk, k["p"], k["q"])
        ctx = tpk.pubkey.context
        w_, nw = ctx.comb_window, -(-ctx.randbits // ctx.comb_window)
        ctx.sample_obfuscator_digits = lambda b: _digits(nw, w_, b)
        x, y, wt = _inputs()
        tx, ty = tpk.encrypt(x), tpk.encrypt(y)
        ts = tx + ty
        tm = ts * wt
        got = np.asarray(tsk.decrypt(tm))
    finally:
        tcfg.set_config(comb_window_cpu=saved[0], encrypt_engine=saved[1])
        torch.set_num_threads(saved[2])
    return dict(window=w_, n_win=nw, max_int=tpk.max_int, x=_cts(tx),
                s=_cts(ts), m=_cts(tm), s_exp=list(ts.exponent()),
                m_exp=list(tm.exponent()), got=got)


def test_round_trip_at_3072_against_python(keys, round_trip):
    """The round trip's ciphertexts against Python's pow and its
    plaintexts against Python's own Paillier decryption and numpy."""
    k, rt = keys[3072], round_trip
    n, nsq = k["n"], k["n"] ** 2
    x, y, wt = _inputs()
    assert rt["window"] == 4
    # (1 + m n) * hs^r mod n^2, r from the injected digits
    encs, _ = encode_vector(x, n, rt["max_int"])
    d, w_ = _digits(rt["n_win"], 4, 8), rt["window"]
    for b in range(4):
        r = sum(int(d[j, b]) << (w_ * j) for j in range(rt["n_win"]))
        assert rt["x"][b] == (1 + encs[b] * n) * pow(k["hs"], r, nsq) % nsq
    np.testing.assert_allclose(rt["got"], (x + y) * wt, rtol=1e-12)
    lam = (k["p"] - 1) * (k["q"] - 1)
    mu = pow(lam, -1, n)
    plain = [((pow(c, lam, nsq) - 1) // n) * mu % n for c in rt["m"]]
    np.testing.assert_array_equal(
        decode_vector(plain, np.asarray(rt["m_exp"]), n, rt["max_int"]),
        rt["got"])


@pytest.mark.slow
def test_round_trip_at_3072_equals_jax(keys, round_trip, knobs,
                                       monkeypatch):
    """The same round trip through the JAX package's API on the same key
    and digits: equal ciphertexts after export (fault C3) and exponents.
    Slow: the JAX package's CPU comb, encrypt and ct*pt at 3072 bits
    take ~20 s; the port's side runs unmarked above."""
    k, rt = keys[3072], round_trip
    knobs(comb_window_cpu=4)
    jpk = jpt.PaillierPublicKey(jpt.ipclPublicKey(
        k["n"], 3072, True, k["hs"], k["randbits"]))
    jctx = jpk.pubkey.context
    assert (jctx.comb_window, -(-jctx.randbits // 4)) == (4, rt["n_win"])
    monkeypatch.setattr(jctx, "sample_obfuscator_digits",
                        lambda b, as_numpy=False: _digits(rt["n_win"], 4, b))
    x, y, wt = _inputs()
    jx, jy = jpk.encrypt(x), jpk.encrypt(y)
    assert _cts(jx) == rt["x"]
    js = jx + jy
    assert _cts(js) == rt["s"] and list(js.exponent()) == rt["s_exp"]
    jm = js * wt
    assert _cts(jm) == rt["m"] and list(jm.exponent()) == rt["m_exp"]
