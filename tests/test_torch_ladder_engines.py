"""The port's runtime engines at the key ladder (1024-, 3072- and 4096-bit
keys) against the JAX package, on the CPU.

Host plans first, at every rung: the limb comb's window and bytes under
``encrypt_engine="limb"`` at the accelerator's window cap (12 at each
rung: the RNS comb alone shrinks to 11 at 4096 bits), the limb decrypt's
window and digits of p-1 and q-1 at Lh = 65, 193 and 257 (its contexts
carrying the mm3 weights, as every CUDA p^2 context does), and the window
count that ``fixed_shape_ops`` gives K5 at CH=779 and 1039 with the
shared memory its launch asks for.

Then one 1024-bit round trip, B=8, under injected obfuscator r, for each
engine combination: (a) the limb comb, (b) the limb decrypt (K7's twin),
(c) both engines limb (ct*pt and the exponent alignment on K4's twin,
the inversion tree on K3's), (d) ``fixed_shape_ops`` on the default
engines (K5's twin over the full mod-n window count).  Ciphertexts are
compared after ``export_cts``, exactly; plaintexts exactly; decoded
floats ``allclose`` to numpy.  Each must equal the port's default route,
the JAX package's result (the port's limb contexts built by
``from_jax_state`` from the JAX package's arrays) and Python's integers.
The JAX package's side runs its limb engines: its RNS decrypt and RNS
ct*pt compile for 11-56 s on the CPU.  For (d) that is its fixed-shape
ct*pt on the limb route, the same function of the same inputs.

Torch runs on one thread here, restored after (see
``tests/test_torch_ladder.py``).  Keys come from that file's seeded prime
search.
"""

import jax.numpy as jnp
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

import chip_smoke
import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.fixedpoint import (decode_vector,
                                                          encode_vector)
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops import rns as tr
from pailliercryptolib_python_tpu_torch.ops.limb import limbs_for_bits
from pailliercryptolib_python_tpu_torch.utils import config as tcfg

from tests.test_torch_ladder import SEEDS, _prime

CPU = torch.device("cpu")
BITS = (1024, 3072, 4096)
KNOBS = ("comb_window_cpu", "encrypt_engine", "decrypt_engine",
         "fixed_shape_ops")
B = 8


@pytest.fixture(scope="module")
def keys():
    """bits -> dict(p, q, n, hs, randbits) of a DJN key."""
    out = {}
    for bits in BITS:
        p, q = (_prime(bits // 2, s) for s in SEEDS[bits])
        n = p * q
        x = (p * 7 + q) % n
        out[bits] = dict(p=p, q=q, n=n, hs=pow((-(x * x)) % n, n, n * n),
                         randbits=bits // 2)
    return out


def _both(**kw):
    jcfg.set_config(**kw)
    tcfg.set_config(**kw)


@pytest.fixture
def knobs():
    """Both packages' knobs, restored after the test."""
    saved = [(c, {k: getattr(c.get_config(), k) for k in KNOBS})
             for c in (jcfg, tcfg)]
    yield _both
    for c, vals in saved:
        c.set_config(**vals)


def _mxu_for_modulus(orig):
    """MontCtx.for_modulus carrying the mm3 weights at 16 <= L <= 520 on
    the CPU too, as it does on CUDA."""
    def for_modulus(cls, n, min_bits=None, mxu=None, device=None):
        if mxu is None:
            L = limbs_for_bits(max(n.bit_length() + 2, min_bits or 0))
            mxu = 16 <= L <= tmg.MontCtx.MXU_MAX_LIMBS
        return orig(cls, n, min_bits, mxu, device)
    return classmethod(for_modulus)


@pytest.fixture
def mxu(monkeypatch):
    monkeypatch.setattr(tmg.MontCtx, "for_modulus",
                        _mxu_for_modulus(tmg.MontCtx.for_modulus.__func__))


@pytest.mark.parametrize("bits,n_win,L", [(1024, 43, 129), (3072, 128, 385),
                                          (4096, 171, 513)])
def test_limb_comb_window_and_bytes(bits, n_win, L, keys, knobs):
    """The accelerator's window cap (12) given to both packages under
    encrypt_engine="limb": the limb comb keeps window 12 at every rung
    (1.44 GB at 4096 bits, within half the 4 GiB budget); under "rns"
    the RNS comb still takes 11 at 4096 bits."""
    k = keys[bits]
    cfg = tcfg.get_config()
    knobs(comb_window_cpu=cfg.comb_window_tpu, encrypt_engine="limb")
    jp = jsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"])
    tp = tsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"],
                            device=CPU)
    assert tp.comb_window == jp.comb_window == 12
    assert (tp.L, -(-k["randbits"] // 12)) == (L, n_win)
    size = tcfg.comb_table_bytes(k["randbits"], tp.L, 12)
    assert size == n_win * L * 4096 * 4 <= cfg.comb_hbm_budget_bytes // 2
    assert tp._rns_enc_plan() is None and jp._rns_enc_plan() is None
    if bits in chip_smoke.LIMB_COMB:
        assert chip_smoke.LIMB_COMB[bits] == (12, size)
    knobs(encrypt_engine="rns")        # the JAX package's side of this:
    rp = tsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"],
                            device=CPU)        # tests/test_torch_ladder.py
    assert rp.comb_window == (11 if bits == 4096 else 12)


@pytest.mark.parametrize("bits,Lh,n_win", [(1024, 65, 103), (3072, 193, 308),
                                           (4096, 257, 410)])
def test_limb_decrypt_window_and_digits(bits, Lh, n_win, keys, knobs, mxu):
    """decrypt_engine="limb" on p^2 / q^2 contexts with mm3 weights: K7's
    window is the JAX package's plan, and the digits of p-1 and q-1 at it
    are the JAX package's."""
    k = keys[bits]
    knobs(decrypt_engine="limb")
    tp = tsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"],
                            device=CPU)
    tv = tsch.PrivateContext(tp, k["p"], k["q"])
    assert not tv.use_rns and tv._sq_p.wmu is not None and tv.Lh == Lh
    window = jpm3.shared_exp_plan(Lh)[0]
    assert tv.dec_window == tm3.shared_exp_window(Lh) == window == 5
    ebits = max((k["p"] - 1).bit_length(), (k["q"] - 1).bit_length())
    assert -(-ebits // window) == n_win
    want = jmg.exponent_digits([k["p"] - 1, k["q"] - 1], n_win, window)
    np.testing.assert_array_equal(tv.dig_p, want[:, 0])
    np.testing.assert_array_equal(tv.dig_q, want[:, 1])


@pytest.mark.parametrize("bits,CH", [(3072, 779), (4096, 1039)])
def test_fixed_shape_k5_windows_and_shared_memory(bits, CH, keys, knobs,
                                                  monkeypatch):
    """fixed_shape_ops: both packages hand the per-element RNS chain (K5)
    the full mod-n window count, ceil(bits / 4), and K5's launch at that
    count asks for less shared memory than an H100 block may have."""
    k = keys[bits]
    knobs(fixed_shape_ops=True)
    seen = []

    def capture(ct, digits, base, key, *args):
        seen.append((tuple(np.asarray(digits).shape), base.k, base.CH))
        return ct
    monkeypatch.setattr(tsch._rns, "rns_pow_elem", capture)
    monkeypatch.setattr(jr, "rns_pow_elem", capture)
    tp = tsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"],
                            device=CPU)
    jp = jsch.PublicContext(k["n"], bits, True, k["hs"], k["randbits"])
    tp.mul_pt(torch.zeros((tp.L, B), dtype=torch.int32), [3] * B)
    jp.mul_pt(jnp.zeros((jp.L, B), dtype=jnp.uint32), [3] * B)
    nw = -(-bits // 4)
    assert seen[0] == seen[1] == ((nw, B), seen[0][1], CH)
    smem = chip_smoke.rns_smem(seen[0][1], CH, nw)
    assert smem["k5"] == chip_smoke.rns_smem(seen[0][1], CH, 0)["k5"] \
        + 32 * nw <= 232448
    # the RNS tile kernels' launches at this base fit too (K1; K2 and K6
    # with W1, W2 read from global memory where they do not fit)
    assert smem["k1"] <= 232448 and smem["k2"] <= 232448


def _inputs():
    rng = np.random.default_rng(1024)
    x, y = rng.uniform(-1e3, 1e3, B), rng.uniform(-1e3, 1e3, B)
    w = rng.uniform(-1.0, 1.0, B)
    w[::2] = -np.abs(w[::2])
    w[1::2] = np.abs(w[1::2])
    rs = [int(v) for v in rng.integers(1, 1 << 62, size=B)]
    rs = [(r << 448) | r for r in rs]          # r < 2^512
    return x, y, w, rs


def _digits(rs, window, n_win):
    return tmg.exponent_digits(rs, n_win, window,
                               msb_first=False).astype(np.uint16)


def _jmont(ctx):
    return {f: np.asarray(getattr(ctx, f)) for f in
            ("n_limbs", "n0inv", "r2", "one", "wmu", "wm", "off1", "off2")
            if getattr(ctx, f) is not None}


def _cts(enc):
    return [v.value() for v in enc.ciphertextBN()]


def _limb_state(k, jpub, jpriv):
    """The JAX contexts' arrays for ``from_jax_state``: the mod-n^2 and
    p^2 / q^2 contexts with their mm3 weights, K7's window and digits at
    the JAX package's plan, the RNS key of n^2, stage 1 and stage 3."""
    n, nsq = k["n"], k["n"] ** 2
    mbits = -(-(2 * 1024 + 2) // 16) * 16
    key = jr.RnsModulus.build(jr.RnsBase.for_bits(mbits), nsq, jpub.L)
    window = jpm3.shared_exp_plan(jpriv.Lh)[0]
    ebits = max((k["p"] - 1).bit_length(), (k["q"] - 1).bit_length())
    dig = jmg.exponent_digits([k["p"] - 1, k["q"] - 1], -(-ebits // window),
                              window)
    sq = lambda m: _jmont(jmg.MontCtx.for_modulus(
        m, min_bits=16 * jpriv.Lh, mxu=True))
    priv = {f: np.asarray(getattr(jpriv, f)) for f in
            ("Cp_lo", "Cp_hi", "Cq_lo", "Cq_hi", "f2_p", "f2_q", "pinv_R",
             "qinv_R", "hpR", "hqR", "pinvqR", "p_limbs", "q_limbs")}
    priv.update(sq_p=sq(k["p"] ** 2), sq_q=sq(k["q"] ** 2),
                p_ctx=_jmont(jpriv._p_ctx), q_ctx=_jmont(jpriv._q_ctx),
                dec_window=window, dig_p=dig[:, 0], dig_q=dig[:, 1])
    pub = dict(ctx=_jmont(jmg.MontCtx.for_modulus(nsq, mxu=True)),
               rns_key={f: np.asarray(getattr(key, f))
                        for f in tr.KEY_ARRAYS},
               rns_pack=jpr.pack(mbits, nsq), comb_window=jpub.comb_window)
    return dict(n=n, p=k["p"], q=k["q"], hs=k["hs"], bits=1024,
                randbits=k["randbits"], pub=pub, priv=priv)


def _port_batch_plain(priv, encs):
    """Plaintext ints of several encrypted numbers in one decrypt."""
    arrs = [e.ciphertext().device_array() for e in encs]
    ints = priv.decrypt_to_ints(torch.cat(arrs, dim=1),
                                sum(a.shape[1] for a in arrs))
    out, at = [], 0
    for e, a in zip(encs, arrs):
        out.append(ints[at:at + len(e)])
        at += a.shape[1]
    return out


@pytest.fixture(scope="module")
def trips(keys):
    """The 1024-bit round trips, B=8: the port's default route (with the
    fixed-shape x * w beside), the port's limb engines on the JAX
    package's arrays, and the JAX package on its limb engines; each
    encrypt under the same injected r.  Returns, per route, the exported
    ciphertexts and exponents of x, y, x + y, x * w, x.sum() and the
    plaintext ints of each."""
    k = keys[1024]
    x, y, w, rs = _inputs()
    saved = [(c, {kn: getattr(c.get_config(), kn) for kn in KNOBS})
             for c in (jcfg, tcfg)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(tmg.MontCtx, "for_modulus",
               _mxu_for_modulus(tmg.MontCtx.for_modulus.__func__))
    out = {}

    def inject(ctx):
        """x and y take the same r; the port encrypts both in one call."""
        nw = -(-ctx.randbits // ctx.comb_window)
        d = _digits(rs + rs, ctx.comb_window, nw)
        return lambda b, as_numpy=False: d[:, :b]

    def run(pk, fixed_too=False):
        if isinstance(pk, jpt.PaillierPublicKey):    # no slices (fault C7)
            ct = {"x": pk.encrypt(x), "y": pk.encrypt(y)}
        else:
            xy = pk.encrypt(np.concatenate([x, y]))
            ct = {"x": xy[:B], "y": xy[B:]}
        ct["x + y"] = ct["x"] + ct["y"]
        ct["x * w"] = ct["x"] * w
        ct["x.sum()"] = ct["x"].sum()
        if fixed_too:
            _both(fixed_shape_ops=True)
            ct["x * w (fixed)"] = ct["x"] * w
            _both(fixed_shape_ops=False)
        return ct

    def record(name, ct, plain):
        out[name] = dict(cts={kk: _cts(v) for kk, v in ct.items()},
                         exps={kk: list(np.atleast_1d(v.exponent()))
                               for kk, v in ct.items()},
                         plain=plain)
    try:
        _both(comb_window_cpu=4, encrypt_engine="auto",
              decrypt_engine="auto", fixed_shape_ops=False)
        # the port's default route: the RNS comb, K2, K5
        tpk = tpt.PaillierPublicKey(tpt.ipclPublicKey(
            k["n"], 1024, True, k["hs"], k["randbits"], device=CPU))
        tsk = tpt.PaillierPrivateKey(tpk, k["p"], k["q"])
        tpk.pubkey.context.sample_obfuscator_digits = inject(
            tpk.pubkey.context)
        ct = run(tpk, fixed_too=True)
        record("default", ct, dict(zip(ct, _port_batch_plain(
            tsk.prikey.context, list(ct.values())))))
        # the JAX package on its limb engines
        _both(encrypt_engine="limb", decrypt_engine="limb")
        jpk = jpt.PaillierPublicKey(jpt.ipclPublicKey(
            k["n"], 1024, True, k["hs"], k["randbits"]))
        jsk = jpt.PaillierPrivateKey(jpk, k["p"], k["q"])
        jctx = jpk.pubkey.context
        jctx.sample_obfuscator_digits = inject(jctx)
        ct = run(jpk)
        _both(fixed_shape_ops=True)
        ct["x * w (fixed)"] = ct["x"] * w
        _both(fixed_shape_ops=False)
        arrs = [v.ciphertext().device_array() for v in ct.values()]
        ints = jsk.prikey.context.decrypt_to_ints(
            jnp.concatenate(arrs, axis=1), sum(a.shape[1] for a in arrs))
        at = np.cumsum([0] + [a.shape[1] for a in arrs])
        record("jax", ct, {kk: ints[a:a + len(v)] for (kk, v), a in
                           zip(ct.items(), at)})
        # the port's limb engines on the JAX package's arrays
        state = _limb_state(k, jctx, jsk.prikey.context)
        state["pub"]["comb"] = np.asarray(jctx.comb_table)
        tpub, tpriv = tpt.from_jax_state(state, CPU)
        assert not tpriv.use_rns and tpriv._sq_p.wmu is not None
        lpk = tpt.PaillierPublicKey(tpt.ipclPublicKey(None, _context=tpub))
        tpub.sample_obfuscator_digits = inject(tpub)
        ct = run(lpk)
        assert tpub._rns_mul_plan() is None
        record("limb", ct, dict(zip(ct, _port_batch_plain(
            tpriv, list(ct.values())))))
        out["limb"]["dec_window"] = tpriv.dec_window
    finally:
        mp.undo()
        for c, vals in saved:
            c.set_config(**vals)
        torch.set_num_threads(threads)
    return out


def test_default_route_against_python(keys, trips):
    """The port's default route: every encrypted column of x is
    (1 + m n) hs^r mod n^2, every plaintext Python's own Paillier
    decryption, every decoded value numpy's."""
    k, d = keys[1024], trips["default"]
    n, nsq = k["n"], k["n"] ** 2
    x, y, w, rs = _inputs()
    encs, _ = encode_vector(x, n, n // 3 - 1)
    assert d["cts"]["x"] == [(1 + m * n) * pow(k["hs"], r, nsq) % nsq
                             for m, r in zip(encs, rs)]
    lam = (k["p"] - 1) * (k["q"] - 1)
    mu = pow(lam, -1, n)
    for name, want in (("x", x), ("x + y", x + y), ("x * w", x * w),
                       ("x.sum()", [x.sum()]), ("x * w (fixed)", x * w)):
        plain = [((pow(c, lam, nsq) - 1) // n) * mu % n
                 for c in d["cts"][name]]
        assert d["plain"][name] == plain, name
        np.testing.assert_allclose(decode_vector(
            plain, d["exps"][name], n, n // 3 - 1), want, rtol=1e-9)


def test_a_limb_comb_encrypt_equals_default_and_jax(trips):
    for name in ("x", "y"):
        assert trips["limb"]["cts"][name] == trips["default"]["cts"][name] \
            == trips["jax"]["cts"][name], name


def test_b_limb_decrypt_equals_default_and_jax(trips):
    """K7's twin, at the JAX package's window (5 at Lh=65), on the
    limb-encrypted ciphertexts, which equal the default route's."""
    assert trips["limb"]["dec_window"] == 5
    for name in ("x", "y"):
        assert trips["limb"]["plain"][name] == \
            trips["default"]["plain"][name] == trips["jax"]["plain"][name]


@pytest.mark.parametrize("name", ["x + y", "x * w", "x.sum()"])
def test_c_both_limb_equals_default_and_jax(trips, name):
    """ct*pt and the exponent alignment on K4's twin, the inversion tree
    on K3's, decrypted on K7's: ciphertexts, exponents and plaintexts as
    the default route's and the JAX package's."""
    lt, dt, jt = trips["limb"], trips["default"], trips["jax"]
    assert lt["cts"][name] == dt["cts"][name] == jt["cts"][name]
    assert lt["exps"][name] == dt["exps"][name] == jt["exps"][name]
    assert lt["plain"][name] == dt["plain"][name] == jt["plain"][name]


def test_d_fixed_shape_equals_default_and_jax(trips):
    """x * w over the full mod-n window count of K5's twin and the
    inversion of the whole batch: the same ciphertexts as the default
    route's x * w and the JAX package's fixed-shape x * w."""
    dt, jt = trips["default"], trips["jax"]
    fixed = "x * w (fixed)"
    assert dt["cts"][fixed] == dt["cts"]["x * w"] == jt["cts"][fixed]
    assert dt["exps"][fixed] == dt["exps"]["x * w"] == jt["exps"][fixed]
    assert dt["plain"][fixed] == dt["plain"]["x * w"] == jt["plain"][fixed]
