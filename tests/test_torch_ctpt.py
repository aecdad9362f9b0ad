"""The port's ct*pt slice against the JAX package on the CPU, at the 256-bit
fixed key: the plain twin of kernel K5 (``rns_exp_elem``) and
``rns_pow_elem``, the batched inversion, both ``mul_pt`` routes, the API
operators built on them (``*`` by negatives, ``-``, ``/``, ``mean``,
``dot``, ``@``, iteration, ``increase_exponent_to``), re-randomization,
and the exponent alignment by squaring (K16's twin) against the ct*pt by
2^d it replaces.  Limbs, states and ciphertexts must be equal; decoded
floats ``allclose``.  Every ciphertext batch here is at most 8 wide, so the
JAX package compiles its decrypt once."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pailliercryptolib_python_tpu as jpt
from pailliercryptolib_python_tpu.models import paillier as jsch
from pailliercryptolib_python_tpu.ops import montgomery as jmg
from pailliercryptolib_python_tpu.ops import pallas_rns as jpr
from pailliercryptolib_python_tpu.ops import rns as jr
from pailliercryptolib_python_tpu.utils import config as jcfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.fixedpoint import encode_vector
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import mont3 as tm3
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops import rns as tr
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk
from pailliercryptolib_python_tpu_torch.ops.limb import (LIMB_BITS,
                                                         ints_to_limbs,
                                                         limbs_to_ints)
from pailliercryptolib_python_tpu_torch.utils import config as tcfg
from pailliercryptolib_python_tpu_torch.utils import profiling

CPU = torch.device("cpu")
KD = fixed_key_ints(256)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """Pallas in interpret mode; the JAX package on its RNS encrypt engine
    (the port's only one); the knobs this file sets restored after."""
    monkeypatch.setattr(jpr, "INTERPRET", True)
    saved = [(cfg, {k: getattr(cfg.get_config(), k) for k in
                    ("encrypt_engine", "decrypt_engine", "fixed_shape_ops",
                     "matmul_chunk_columns")}) for cfg in (jcfg, tcfg)]
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


def _digits(n_win, window, B):
    rng = np.random.default_rng(3000 + B)
    return rng.integers(0, 1 << window, size=(n_win, B)).astype(np.uint16)


def _inject_digits(monkeypatch, jctx, tctx):
    w, nw = tctx.comb_window, -(-tctx.randbits // tctx.comb_window)
    assert (jctx.comb_window, jctx.randbits) == (w, tctx.randbits)
    monkeypatch.setattr(jctx, "sample_obfuscator_digits",
                        lambda b, as_numpy=False: _digits(nw, w, b))
    monkeypatch.setattr(tctx, "sample_obfuscator_digits",
                        lambda b: _digits(nw, w, b))


def _keys(monkeypatch, enable_DJN=True):
    if enable_DJN:
        jpub = jpt.ipclPublicKey(KD["n"], KD["bits"], True, KD["hs"],
                                 KD["randbits"])
        tpub = tpt.ipclPublicKey(KD["n"], KD["bits"], True, KD["hs"],
                                 KD["randbits"], device=CPU)
        _inject_digits(monkeypatch, jpub.context, tpub.context)
    else:
        jpub = jpt.ipclPublicKey(KD["n"], KD["bits"], False)
        tpub = tpt.ipclPublicKey(KD["n"], KD["bits"], False, device=CPU)
    jpk, tpk = jpt.PaillierPublicKey(jpub), tpt.PaillierPublicKey(tpub)
    return (jpk, jpt.PaillierPrivateKey(jpk, KD["p"], KD["q"]),
            tpk, tpt.PaillierPrivateKey(tpk, KD["p"], KD["q"]))


def _cts(enc):
    return [v.value() for v in enc.ciphertextBN()]


def _units(rng, m, b):
    """b random units mod m (ciphertexts are units mod n^2)."""
    return [rng.randrange(1, m) | 1 for _ in range(b)]


# ---------------------------------------------------------------------------
# K5's plain twin and rns_pow_elem.
# ---------------------------------------------------------------------------

def test_rns_exp_elem_and_pow_elem():
    mbits, m = 576, KD["n"] ** 2
    L = (m.bit_length() + 2 + 15) // 16
    jb, tb = jr.RnsBase.for_bits(mbits), tr.RnsBase.for_bits(mbits, CPU)
    jk, tk = jr.RnsModulus.build(jb, m, L), tr.RnsModulus.build(tb, m, L)
    jsq = jmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=False)
    tsq = tmg.MontCtx.for_modulus(m, min_bits=LIMB_BITS * L, mxu=True,
                                  device=CPU)
    rng = random.Random(61)
    R = 1 << (LIMB_BITS * L)
    window = 4
    es = [rng.getrandbits(50) | 1 for _ in range(8)] + [0]
    nw = -(-max(e.bit_length() for e in es) // window)
    digits = jmg.exponent_digits(es, nw, window)
    cs = [rng.randrange(m) for _ in range(9)]
    v = ints_to_limbs([c * R % m for c in cs], L)
    X = tr.rns_enter(_t(v), tb, tk)
    jX = jr.rns_enter(jnp.asarray(v), jb, jk)
    got = trk.rns_exp_elem_p(X, digits, tb, tk, window)   # CPU: the twin
    _same(got, tr.rns_exp_elem(X, _t(digits), tb, tk, window))
    _same(got, jr.rns_exp_elem(jX, jnp.asarray(digits), jb, jk, window))
    _same(got, jpr.rns_exp_elem_p(jX, jnp.asarray(digits), jb, jk, window))
    out = tr.rns_pow_elem(_t(v), digits, tb, tk, tsq, window, L)
    _same(out, jr.rns_pow_elem(jnp.asarray(v), jnp.asarray(digits), jb, jk,
                               jsq, window, L))
    canon = limbs_to_ints(tmg.from_mont(out, tsq))
    assert canon == [pow(c, e, m) for c, e in zip(cs, es)]
    bad = digits.copy()
    bad[0, 0] = 1 << window
    with pytest.raises(ValueError):
        trk.rns_exp_elem_p(X, bad, tb, tk, window)


# ---------------------------------------------------------------------------
# Batched inversion.
# ---------------------------------------------------------------------------

def test_mont_inv_and_trees():
    m = KD["n"] ** 2
    jctx = jmg.MontCtx.for_modulus(m)
    tctx = tmg.MontCtx.for_modulus(m, mxu=True, device=CPU)
    L = tctx.num_limbs
    R = 1 << (LIMB_BITS * L)
    xs = _units(random.Random(62), m, 5)                # pads to 8 inside
    a = ints_to_limbs([x * R % m for x in xs], L)
    hostroot = tmg.mont_inv_tree_hostroot(_t(a), tctx, m)
    _same(hostroot, jmg.mont_inv_tree_hostroot(jnp.asarray(a), jctx, m))
    tree = tmg.mont_inv_tree(_t(a), tctx)
    _same(tree, jmg.mont_inv_tree(jnp.asarray(a), jctx))
    direct = tmg.mont_inv(_t(a[:, :2]), tctx)
    _same(direct, jmg.mont_inv(jnp.asarray(a[:, :2]), jctx))
    for got in (hostroot, tree):
        for g, x in zip(limbs_to_ints(got), xs):
            assert g < 2 * m and g % m == pow(x, -1, m) * R % m
    for g, x in zip(limbs_to_ints(direct), xs[:2]):
        assert g % m == pow(x, -1, m) * R % m


# ---------------------------------------------------------------------------
# mul_pt: the RNS route (K5), the limb route (K4), fixed_shape_ops.
# ---------------------------------------------------------------------------

# Random exponents of up to `bits` bits; or, where `top` is given, of at
# most top's bits with one equal to it, so that the limb route runs
# exactly ceil(bitlen(top) / 4) windows (1, 1, 2 and 7 below).
@pytest.mark.parametrize("bits,fixed,top", [
    (50, False, None), (9, False, None), (50, True, None),
    (None, False, 1), (None, False, 1 << 3), (None, False, 1 << 4),
    (None, False, 1 << 27)],
    ids=["rns", "limb", "fixed", "limb-win1-01", "limb-win1", "limb-win2",
         "limb-win7"])
def test_mul_pt_routes(bits, fixed, top):
    jcfg.set_config(fixed_shape_ops=fixed)
    tcfg.set_config(fixed_shape_ops=fixed)
    jpub = jsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"])
    tpub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"], device=CPU)
    rng = random.Random(63 + (bits or top))
    cts = _units(rng, KD["n"] ** 2, 7)
    if top is None:
        es = [rng.getrandbits(bits) for _ in range(7)]
    else:
        es = [top] + [rng.randrange(top + 1) for _ in range(6)]
    want = jpub.export_cts(jpub.mul_pt(jpub.import_cts(cts), es), 7)
    tct = tpub.import_cts(cts)
    assert tpub.export_cts(tpub.mul_pt(tct, es), 7) == want
    assert want == [pow(c, e, KD["n"] ** 2) for c, e in zip(cts, es)]
    # the port's limb route on the same exponents (both knobs off RNS)
    limb = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"], device=CPU)
    tcfg.set_config(decrypt_engine="limb", encrypt_engine="limb")
    assert limb._rns_mul_plan() is None
    assert limb.export_cts(limb.mul_pt(tct, es), 7) == want


# ---------------------------------------------------------------------------
# The API operators.
# ---------------------------------------------------------------------------

def _signed_mul_by_hand(tpk, tx, w, fixed):
    """``x * w`` as the API runs it, from the context's own calls:
    ``mul_pt`` by n - pt where the encoding is >= n - max_int (a negative
    weight), then ``PublicContext.invert_columns`` of those columns (by
    gather and scatter, or under fixed_shape_ops over the whole batch
    with a mask); each inverted column is checked against Python's
    inverse mod n^2.  Returns the exported ciphertexts."""
    prev = tcfg.get_config().fixed_shape_ops
    tcfg.set_config(fixed_shape_ops=fixed)
    try:
        n, max_int = tpk.n, tpk.max_int
        pts, _ = encode_vector(w, n, max_int)
        flags = np.array([pt >= n - max_int for pt in pts])
        assert flags.any() and not flags.all()
        ctx = tpk.pubkey.context
        pos = ctx.mul_pt(tx.ciphertext().device_array(),
                         [n - pt if f else pt for pt, f in zip(pts, flags)])
        got = ctx.export_cts(ctx.invert_columns(pos, flags), len(w))
    finally:
        tcfg.set_config(fixed_shape_ops=prev)
    nsq = n * n
    for g, p, f in zip(got, ctx.export_cts(pos, len(w)), flags):
        assert g == (pow(p, -1, nsq) if f else p)
    return got


@pytest.mark.parametrize("chunk", [1 << 15, 8], ids=["whole", "chunk8"])
def test_api_operators(monkeypatch, chunk):
    jcfg.set_config(matmul_chunk_columns=chunk)
    tcfg.set_config(matmul_chunk_columns=chunk)
    jpk, jsk, tpk, tsk = _keys(monkeypatch)
    rng = np.random.default_rng(64)
    x = rng.uniform(-100.0, 100.0, 6)
    w = rng.uniform(-1.0, 1.0, 6)
    w[1] = -w[1] if w[1] > 0 else w[1]                 # mixed signs
    w[2] = abs(w[2])
    W = rng.uniform(-1.0, 1.0, (3, 2))
    W2 = rng.uniform(-1.0, 1.0, (2, 3))
    jx, tx = jpk.encrypt(x), tpk.encrypt(x)
    jy, ty = jpk.encrypt(w), tpk.encrypt(w)
    assert _cts(tx) == _cts(jx)
    jv, tv = jx[0:3], tx[0:3]

    def imat(c, m):
        c @= m
        return c

    cases = [
        (lambda c, d, v: c * -2.0, x * -2.0),
        (lambda c, d, v: c * w, x * w),
        (lambda c, d, v: c - d, x - w),
        (lambda c, d, v: c - list(w), x - w),
        (lambda c, d, v: 2.5 - c, 2.5 - x),
        (lambda c, d, v: c / 3.0, x / 3.0),
        (lambda c, d, v: c.mean(), x.mean()),
        (lambda c, d, v: c.dot(w), x @ w),
        (lambda c, d, v: c @ w, np.array([x @ w])),
        (lambda c, d, v: c @ np.vstack([W, W]), x @ np.vstack([W, W])),
        (lambda c, d, v: v @ W, x[:3] @ W),
        (lambda c, d, v: W2 @ v, W2 @ x[:3]),
        (lambda c, d, v: imat(v, W), x[:3] @ W),
    ]
    for i, (op, want) in enumerate(cases):
        jres, tres = op(jx, jy, jv), op(tx, ty, tv)
        assert _cts(tres) == _cts(jres), i
        if i == 1:                                     # c * w, mixed signs
            for fixed in (False, True):
                assert _signed_mul_by_hand(tpk, tx, w, fixed) == _cts(jres)
        assert tres.exponent() == jres.exponent(), i
        td = np.asarray(tsk.decrypt(tres))
        np.testing.assert_allclose(td, np.asarray(jsk.decrypt(jres)),
                                   rtol=1e-12)
        np.testing.assert_allclose(td, want, rtol=1e-9, atol=1e-9)


def test_iter_and_increase_exponent(monkeypatch):
    jpk, jsk, tpk, tsk = _keys(monkeypatch)
    x = np.array([1.5, -2.25, 1000.0, 3.0])
    jx, tx = jpk.encrypt(x), tpk.encrypt(x)
    items = list(tx)
    assert len(items) == 4
    assert _cts(tx[:2]) == _cts(jx[0:2]) and _cts(tx[2:]) == _cts(jx[2:4])
    for item, jitem, xi in zip(items, jx, x):
        assert _cts(item) == _cts(jitem)
        assert item.exponent() == jitem.exponent()
        np.testing.assert_allclose(tsk.decrypt(item), xi, rtol=1e-12)
    target = max(tx.exponent()) + 3
    tct = tx.increase_exponent_to(tx.ciphertext(), tx.exponent(), target)
    jct = jx.increase_exponent_to(jx.ciphertext(), jx.exponent(), target)
    assert tct.host_ints() == jct.host_ints()
    raised = tpt.PaillierEncryptedNumber(tpk, tct, [target] * 4, 4)
    np.testing.assert_allclose(tsk.decrypt(raised), x, rtol=1e-12)
    same = tx.increase_exponent_to(tx.ciphertext(), tx.exponent(), 0)
    assert same is tx.ciphertext()


# ---------------------------------------------------------------------------
# Re-randomization.
# ---------------------------------------------------------------------------

def test_apply_obfuscator_djn(monkeypatch):
    jpk, jsk, tpk, tsk = _keys(monkeypatch)
    x = np.array([0.5, -7.0, 12.25])
    jx, tx = jpk.encrypt(x), tpk.encrypt(x)
    before = _cts(tx)
    jx.apply_obfuscator()
    tx.apply_obfuscator()
    assert _cts(tx) == _cts(jx)
    assert all(a != b for a, b in zip(before, _cts(tx)))
    np.testing.assert_allclose(tsk.decrypt(tx), x, rtol=1e-12)
    # the key-level entry points: an int and a ciphertext container
    c0 = before[0]
    assert tpk.apply_obfuscator(c0).value() == jpk.apply_obfuscator(c0).value()
    got = tpk.pubkey.apply_obfuscator(tx.ciphertext())
    assert [g.value() for g in got] == [
        g.value() for g in jpk.pubkey.apply_obfuscator(jx.ciphertext())]


def test_plain_paillier_obfuscator(monkeypatch):
    jpk, jsk, tpk, tsk = _keys(monkeypatch, enable_DJN=False)

    def fake(package):
        draws = random.Random(65)
        monkeypatch.setattr(package.secrets, "randbelow",
                            lambda k: draws.randrange(k))

    x = np.array([3.5, -1.25, 8.0])
    fake(jsch)
    jx = jpk.encrypt(x)
    fake(tsch)
    tx = tpk.encrypt(x)
    assert _cts(tx) == _cts(jx)
    np.testing.assert_allclose(tsk.decrypt(tx), x, rtol=1e-12)
    raw = tpk.raw_encrypt(x)
    assert _cts(raw) != _cts(tx)
    raw.apply_obfuscator()
    assert _cts(raw) != _cts(tpk.raw_encrypt(x))
    np.testing.assert_allclose(tsk.decrypt(raw), x, rtol=1e-12)


# ---------------------------------------------------------------------------
# The exponent alignment: d squarings of each shifted column (K16's twin).
# ---------------------------------------------------------------------------

ALIGN_X = np.array([0.5, -1.25, 3e-3, 7.0, 1e-5, 1000.0, 2.0 ** -40])
ALIGN_Y = np.array([3.0, 1e-7, -0.75, 2.0 ** 20, 0.1, -5e-3, 1.0])


def _ctpt_align(self, ct, diffs):
    """The alignment as one ct*pt by 2^d over the batch (``mul_pt``)."""
    return self.mul_pt(ct, [1 << int(d) if d > 0 else 1 for d in diffs])


def _port_keys(mxu):
    tpk = tpt.PaillierPublicKey(tpt.ipclPublicKey(
        KD["n"], KD["bits"], True, KD["hs"], KD["randbits"], device=CPU))
    if mxu:                      # the mm3 weights, as a CUDA context has
        pub = tpk.pubkey.context
        pub.ctx = tmg.MontCtx.for_modulus(pub.nsquare, mxu=True, device=CPU)
    return tpk, tpt.PaillierPrivateKey(tpk, KD["p"], KD["q"])


@pytest.mark.parametrize("mxu", [False, True], ids=["K9-twin", "K8-twin"])
def test_alignment_by_squaring_equals_ctpt_by_pow2(monkeypatch, mxu):
    """``+`` between different exponents, ``sum``, ``@`` and
    ``increase_exponent_to`` give the ciphertext integers and exponents of
    the ct*pt route, and ct^(2^d) by Python's pow."""
    tpk, tsk = _port_keys(mxu)
    x, y = tpk.encrypt(ALIGN_X), tpk.encrypt(ALIGN_Y)
    W = np.linspace(-1.0, 1.0, 14).reshape(7, 2)
    target = max(x.exponent()) + 5
    ops = {"x + y": lambda: x + y, "x.sum()": lambda: x.sum(),
           "x @ W": lambda: x @ W,
           "increase_exponent_to": lambda: tpt.PaillierEncryptedNumber(
               tpk, x.increase_exponent_to(x.ciphertext(), x.exponent(),
                                           target), [target] * 7, 7)}
    chains = []
    chain = tsch._m3.mm3_sqr_chain
    monkeypatch.setattr(tsch._m3, "mm3_sqr_chain",
                        lambda *a: chains.append(a[2]) or chain(*a))
    got = {k: f() for k, f in ops.items()}
    assert len(chains) >= len(ops)
    monkeypatch.setattr(tsch.PublicContext, "scale_pow2", _ctpt_align)
    want = {k: f() for k, f in ops.items()}
    for k in ops:
        assert _cts(got[k]) == _cts(want[k]), k
        assert got[k].exponent() == want[k].exponent(), k
    nsq = KD["n"] ** 2
    assert _cts(got["increase_exponent_to"]) == [
        pow(c, 1 << (target - e), nsq) for c, e in zip(_cts(x), x.exponent())]
    np.testing.assert_allclose(tsk.decrypt(got["x + y"]), ALIGN_X + ALIGN_Y,
                               rtol=1e-12)
    np.testing.assert_allclose(tsk.decrypt(got["x @ W"]), ALIGN_X @ W,
                               rtol=1e-9, atol=1e-12)


def test_fixed_shape_alignment_stays_on_mul_pt(monkeypatch):
    """Under fixed_shape_ops the alignment is one ct*pt by 2^d over the
    batch, as before the squaring chain: the same ciphertexts."""
    tpk, _ = _port_keys(False)
    x, y = tpk.encrypt(ALIGN_X), tpk.encrypt(ALIGN_Y)
    calls = []
    chain, mul_pt = tsch._m3.mm3_sqr_chain, tsch.PublicContext.mul_pt
    monkeypatch.setattr(tsch._m3, "mm3_sqr_chain",
                        lambda *a: calls.append("chain") or chain(*a))
    monkeypatch.setattr(tsch.PublicContext, "mul_pt",
                        lambda self, ct, e: calls.append(list(e))
                        or mul_pt(self, ct, e))
    default = x + y
    assert calls and set(calls) == {"chain"}
    calls.clear()
    tcfg.set_config(fixed_shape_ops=True)
    fixed = x + y
    assert calls and "chain" not in calls
    assert _cts(fixed) == _cts(default)
    tx, ty = np.array(x.exponent()), np.array(y.exponent())
    target = np.maximum(tx, ty)
    assert [e for e in calls if any(v > 1 for v in e)] == [
        [1 << int(d) for d in target - ex] for ex in (tx, ty)
        if np.any(target > ex)]


def test_align_counters_count_squarings_and_warp_padding(monkeypatch):
    """One chain over the 7 shifted columns of 9, ordered by d: at this
    modulus and the chain's mean width (22 / 7 -> 4 columns) 8 lanes a
    column, so warps of 4 columns, (7, 5, 3, 3) and (2, 1, 1), run 7 x 4
    + 2 x 3 squarings for the 22 needed."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(profiling, "COUNTERS",
                        dict.fromkeys(profiling.COUNTERS, 0))
    pub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                             KD["randbits"], device=CPU)
    assert tm3.sqr_chain_width([7, 5, 3, 3, 2, 1, 1]) == 4
    assert tm3.coop_shape(pub.L, 4) == (8, 3)
    nsq = KD["n"] ** 2
    cts = _units(random.Random(9), nsq, 9)
    diffs = np.array([0, 5, 1, 3, 3, 0, 2, 7, 1])
    with profile(activities=[ProfilerActivity.CPU]):
        out = pub.scale_pow2(pub.import_cts(cts), diffs)
    assert profiling.COUNTERS == dict(
        dict.fromkeys(profiling.COUNTERS, 0), align_launches=1,
        align_columns=7, align_squarings_needed=22, align_squarings_run=34)
    assert pub.export_cts(out, 9) == [pow(c, 1 << int(d), nsq)
                                      for c, d in zip(cts, diffs)]
    out = pub.scale_pow2(pub.import_cts(cts), diffs)      # no profiler
    assert profiling.COUNTERS["align_launches"] == 1
