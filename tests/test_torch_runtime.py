"""The port's runtime-control layer against the JAX package on the CPU:
``context`` / ``hybridControl`` / ``hybridMode`` and both mode tables, the
config knobs, the pipelined (chunked) and host/device-split encrypt, the
comb LRU registry, the bounded operand-bundle cache, the profiling hooks,
``baseconverter`` and ``PrivateContext.profile_stages``.

The port is pinned to ``device="cpu"``; the reference decrypts at one
batch width (8 columns).  Ciphertexts carry fresh randomness, so an
encrypt is held to the reference through its decryption (exact ints);
floats are compared with ``allclose`` where the test says so."""

import os
import random

import numpy as np
import pytest
import torch

import pailliercryptolib_python_tpu as jpt
from pailliercryptolib_python_tpu.models import paillier as jsch
from pailliercryptolib_python_tpu.utils import baseconverter as jbc
from pailliercryptolib_python_tpu.utils import config as jcfg
from pailliercryptolib_python_tpu.utils import context as jctx_mod
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk
from pailliercryptolib_python_tpu_torch.utils import baseconverter as tbc
from pailliercryptolib_python_tpu_torch.utils import config as tcfg
from pailliercryptolib_python_tpu_torch.utils import context as tctx_mod
from pailliercryptolib_python_tpu_torch.utils import profiling as tprof
from pailliercryptolib_python_tpu_torch.utils.context import (
    context, hybridControl, hybridMode)

from .test_torch_paillier import _jax_state

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
REF_WIDTH = 8           # the one batch width the reference decrypts at
KNOBS = ("encrypt_pipeline_chunks", "encrypt_host_ratio",
         "comb_hbm_budget_bytes", "rns_exp_window", "exp_window")


@pytest.fixture(autouse=True)
def _restore():
    """Both packages' knobs, modes and contexts as they were; the port's
    default device the CPU (``isQATRunning`` reads it)."""
    from pailliercryptolib_python_tpu_torch import device
    saved_dev = device.get_device()
    device.set_device(CPU)
    saved = [{k: getattr(c.get_config(), k) for k in KNOBS}
             for c in (tcfg, jcfg)]
    yield
    for c, s in zip((tcfg, jcfg), saved):
        c.set_config(**s)
    for mod in (tctx_mod, jctx_mod):
        mod.hybridControl._mode = mod.hybridMode.UNDEFINED
        mod.context.terminateContext()
    device.set_device(saved_dev)


@pytest.fixture(scope="module")
def keys():
    tpub = tpt.ipclPublicKey(KD["n"], KD["bits"], True, KD["hs"],
                             KD["randbits"], device=CPU)
    tpk = tpt.PaillierPublicKey(tpub)
    return tpk, tpt.PaillierPrivateKey(tpk, KD["p"], KD["q"])


@pytest.fixture(scope="module")
def ref_priv():
    """The reference's private context built from the same p, q."""
    jpub = jsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"])
    return jsch.PrivateContext(jpub, KD["p"], KD["q"])


def _ref_decrypt(ref_priv, cts):
    """Canonical ciphertext ints -> plaintext ints under the reference's
    private key, REF_WIDTH columns at a time."""
    assert len(cts) == REF_WIDTH
    return ref_priv.decrypt_to_ints(ref_priv.pub.import_cts(cts), len(cts))


def _mk_pub(seed: int) -> tsch.PublicContext:
    hs = pow(KD["hs"], seed + 2, KD["n"] * KD["n"])
    return tsch.PublicContext(KD["n"], KD["bits"], True, hs, KD["randbits"],
                              device=CPU)


# -- context / hybridControl / hybridMode ---------------------------------

def test_context_and_hybrid_shims():
    assert context.initializeContext("QAT") is True
    assert context.isQATActive() is False          # default device: the CPU
    from pailliercryptolib_python_tpu_torch import device
    device.set_device("cuda")                      # a value; nothing opens it
    assert context.isQATRunning() is True and context.isQATActive() is True
    device.set_device(CPU)
    assert context.terminateContext() is True
    assert context.isQATRunning() is False
    hybridControl.setHybridMode(hybridMode.HALF)
    assert hybridControl.getHybridMode() == hybridMode.HALF
    hybridControl.setHybridOff()
    assert hybridControl.getHybridMode() == hybridMode.IPP
    assert tpt.context is context and tpt.hybridControl is hybridControl
    assert tpt.hybridMode is hybridMode


def test_hybrid_mode_and_tables_equal_the_reference():
    jm = jctx_mod.hybridMode
    assert [(m.name, m.value) for m in hybridMode] == [
        (m.name, m.value) for m in jm]
    for name in ("OPTIMAL", "QAT", "HALF", "IPP", "UNDEFINED"):
        assert getattr(tctx_mod, name) == getattr(jctx_mod, name)
        assert getattr(tctx_mod, name) is hybridMode[name]
    as_names = lambda table: {m.name: v for m, v in table.items()}
    assert as_names(tctx_mod._MODE_CHUNKS) == as_names(jctx_mod._MODE_CHUNKS)
    assert as_names(tctx_mod._MODE_HOST_RATIO) == as_names(
        jctx_mod._MODE_HOST_RATIO)


@pytest.mark.parametrize("mode", list(hybridMode), ids=lambda m: m.name)
def test_set_hybrid_mode_sets_the_knobs_as_the_reference(mode):
    for c in (tcfg, jcfg):
        c.set_config(encrypt_pipeline_chunks=3, encrypt_host_ratio=0.25)
    hybridControl.setHybridMode(mode)
    jctx_mod.hybridControl.setHybridMode(jctx_mod.hybridMode(int(mode)))
    t, j = tcfg.get_config(), jcfg.get_config()
    assert t.encrypt_pipeline_chunks == j.encrypt_pipeline_chunks
    assert t.encrypt_host_ratio == j.encrypt_host_ratio
    assert int(hybridControl.getHybridMode()) == int(
        jctx_mod.hybridControl.getHybridMode())


def test_config_knobs_have_the_reference_names_and_defaults():
    t, j = tcfg.Config(), jcfg.Config()
    for k in ("exp_window", "rns_exp_window", "encrypt_pipeline_chunks",
              "encrypt_host_ratio", "comb_hbm_budget_bytes",
              "comb_window_tpu", "comb_window_cpu", "decrypt_engine"):
        assert getattr(t, k) == getattr(j, k), k
    with pytest.raises(ValueError):
        tcfg.set_config(definitely_not_a_knob=1)
    assert tpt.set_config(exp_window=4).exp_window == 4


# -- pipelined and split encrypt ---------------------------------------------

def test_hybrid_pipelined_encrypt(keys, ref_priv):
    """A width that chunks (2 chunks of at least 256): a slice of the
    ciphertext across the chunk boundary decrypts to the values, and
    under the reference's private key to the same plaintext ints."""
    pk, sk = keys
    B = 520
    vals = np.random.default_rng(3).random(B) * 100 - 50
    hybridControl.setHybridMode(hybridMode.HALF)       # 2 chunks ...
    tcfg.set_config(encrypt_host_ratio=0.0)            # ... and no host share
    ct = pk.encrypt(vals)
    assert len(ct) == B
    # ceil(520 / 2) = 260 pads to 384 columns a chunk: boundary at 384
    cut = slice(380, 390)
    assert np.allclose(sk.decrypt(ct[cut]), vals[cut], atol=1e-7)
    assert np.allclose(sk.decrypt(ct[500:520]), vals[500:520], atol=1e-7)
    ints = sk.raw_decrypt(ct[cut])
    cts = ct.ciphertext().host_ints()[380:380 + REF_WIDTH]
    assert _ref_decrypt(ref_priv, cts) == ints[:REF_WIDTH]
    # unchunked, the same values give the same plaintext ints
    hybridControl.setHybridMode(hybridMode.QAT)
    assert sk.raw_decrypt(pk.encrypt(vals[cut])) == ints


@pytest.mark.parametrize("mode,want", [
    (hybridMode.QAT, [(1030, None)]),
    (hybridMode.OPTIMAL, [(384, 384), (384, 384), (262, 384)]),
    (hybridMode.PREF_QAT80, [(1030, None)]),
    (hybridMode.HALF, [(1030, None)]),
    (hybridMode.IPP, [(1030, None)])], ids=lambda v: getattr(v, "name", ""))
def test_mode_decides_the_chunks(keys, monkeypatch, mode, want):
    """The (size, pad_to) of each ``PublicContext.encrypt`` call a mode
    makes for 1030 values: OPTIMAL cuts ceil(1030 / 4) = 258, padded to
    384, so three chunks; a host share (PREF_*, HALF, IPP) turns chunking
    off, as in the reference, and with no context initialized the split
    is off too."""
    pk, _ = keys
    pctx = pk.pubkey.context
    calls = []

    def fake(self, encodings, apply_obfuscator=True, pad_to=None):
        calls.append((len(encodings), pad_to))
        width = pad_to or tsch.pad_batch(len(encodings))
        return self.ctx.one.expand(self.L, width)      # encryptions of 0

    monkeypatch.setattr(tsch.PublicContext, "encrypt", fake)
    hybridControl.setHybridMode(mode)
    ct = pk.encrypt(np.zeros(1030))
    assert calls == want
    assert len(ct) == 1030
    assert ct.ciphertext().device_array().shape == (pctx.L,
                                                    tsch.pad_batch(1030))


def test_hybrid_host_device_split(keys, ref_priv):
    """With the context initialized a mode-proportional share of each
    batch encrypts on the host thread; the call counts are the
    reference's test's: [10] under HALF, then [10, 20] under IPP."""
    pk, sk = keys
    calls = []
    orig = tsch.PublicContext.host_encrypt

    def spy(self, encodings, apply_obfuscator=True):
        calls.append(len(encodings))
        return orig(self, encodings, apply_obfuscator)

    x = np.arange(20, dtype=float) + 0.5
    tsch.PublicContext.host_encrypt = spy
    try:
        hybridControl.setHybridMode(hybridMode.HALF)
        assert np.allclose(sk.decrypt(pk.encrypt(x)), x)
        assert calls == []                  # no context: no split
        context.initializeContext("QAT")
        ct = pk.encrypt(x)
        assert calls == [10]
        assert np.allclose(sk.decrypt(ct), x)
        # device columns 6..9 and host columns 10..13, reference's key
        want_ints = sk.raw_decrypt(ct)
        cts = ct.ciphertext().host_ints()[6:6 + REF_WIDTH]
        assert _ref_decrypt(ref_priv, cts) == want_ints[6:14]
        hybridControl.setHybridMode(hybridMode.IPP)
        assert np.allclose(sk.decrypt(pk.encrypt(x)), x)
        assert calls == [10, 20]
        a, b = (pk.encrypt(x[:4]).ciphertext().host_ints() for _ in range(2))
        assert all(u != v for u, v in zip(a, b))     # fresh obfuscators
        raw = pk.encrypt(x[:4], apply_obfuscator=False)
        assert raw.ciphertext().host_ints() == \
            pk.pubkey.context.host_encrypt(
                [int(v) for v in sk.raw_decrypt(raw)], False)
    finally:
        tsch.PublicContext.host_encrypt = orig


def test_host_encrypt_is_the_scheme(ref_priv):
    """``host_encrypt`` equals (1 + m n) hs^r mod n^2: without the
    obfuscator exactly, with it through the reference's decrypt; a
    plain-Paillier key obfuscates with r^n."""
    pub = _mk_pub(0)
    ms = [0, 1, KD["n"] - 1, 12345, 2 ** 100, 7, 8, 9]
    nsq = KD["n"] ** 2
    assert pub.host_encrypt(ms, False) == [(1 + m * KD["n"]) % nsq
                                           for m in ms]
    cts = pub.host_encrypt(ms)
    assert cts != pub.host_encrypt(ms)
    assert _ref_decrypt(ref_priv, cts) == ms
    plain = tsch.PublicContext(KD["n"], KD["bits"], False, device=CPU)
    assert _ref_decrypt(ref_priv, plain.host_encrypt(ms)) == ms


# -- the comb registry ---------------------------------------------------------

def test_comb_window_shrinks_to_fit_budget():
    pub_full = _mk_pub(0)
    cfg_saved = tcfg.get_config().encrypt_engine
    tcfg.set_config(encrypt_engine="limb")
    try:
        full_bytes = tcfg.comb_table_bytes(pub_full.randbits, pub_full.L,
                                           pub_full.comb_window)
        tcfg.set_config(comb_hbm_budget_bytes=full_bytes)
        pub_small = _mk_pub(0)
        assert pub_small.comb_window < pub_full.comb_window
        assert tcfg.comb_table_bytes(pub_small.randbits, pub_small.L,
                                     pub_small.comb_window) <= full_bytes // 2
        priv = tsch.PrivateContext(pub_small, KD["p"], KD["q"])
        msgs = [int(v) for v in np.random.default_rng(0).integers(
            0, 1000, size=4)]
        ct = pub_small.encrypt(msgs)
        assert priv.decrypt_to_ints(ct, 4) == msgs
    finally:
        tcfg.set_config(encrypt_engine=cfg_saved)


@pytest.fixture()
def small_combs():
    """A comb window of 4 on the CPU: 32 windows of 16 entries a key."""
    saved = tcfg.get_config().comb_window_cpu
    tcfg.set_config(comb_window_cpu=4)
    yield
    tcfg.set_config(comb_window_cpu=saved)


@pytest.mark.parametrize("table", ["comb_table", "comb_rns"])
def test_comb_registry_evicts_lru_under_budget(table, small_combs):
    attr = "_comb" if table == "comb_table" else "_comb_rns"
    probe = _mk_pub(0)
    one = getattr(probe, table)
    one_table = one.numel() * one.element_size()
    probe.free()
    assert getattr(probe, attr) is None
    tcfg.set_config(comb_hbm_budget_bytes=3 * one_table)
    before = len(tcfg.comb_registry)
    pubs = [_mk_pub(i) for i in range(5)]
    for p in pubs:
        getattr(p, table)
        assert tcfg.comb_registry.total_bytes <= 3 * one_table
    assert getattr(pubs[0], attr) is None
    assert getattr(pubs[-1], attr) is not None
    # an evicted key rebuilds at its next use and still round-trips
    priv = tsch.PrivateContext(pubs[0], KD["p"], KD["q"])
    msgs = [7, 11, 13, 17]
    saved = tcfg.get_config().encrypt_engine
    tcfg.set_config(encrypt_engine="limb" if table == "comb_table"
                    else "auto")
    try:
        ct = pubs[0].encrypt(msgs)
    finally:
        tcfg.set_config(encrypt_engine=saved)
    assert getattr(pubs[0], attr) is not None
    assert priv.decrypt_to_ints(ct, 4) == msgs
    for p in pubs:
        p.free()
    assert len(tcfg.comb_registry) <= before


def test_touch_keeps_hot_keys_resident_and_bytes_are_real(small_combs):
    probe = _mk_pub(0)
    one_table = probe.comb_table.numel() * 4
    assert one_table == tcfg.comb_table_bytes(probe.randbits, probe.L,
                                              probe.comb_window)
    probe.free()
    tcfg.set_config(comb_hbm_budget_bytes=2 * one_table)
    # under the limb engine the window is sized by the limb comb alone
    saved = tcfg.get_config().encrypt_engine
    tcfg.set_config(encrypt_engine="limb")
    try:
        a, b, c = _mk_pub(1), _mk_pub(2), _mk_pub(3)
    finally:
        tcfg.set_config(encrypt_engine=saved)
    assert a.comb_window == probe.comb_window
    base_total = tcfg.comb_registry.total_bytes
    a.comb_table
    b.comb_table
    assert tcfg.comb_registry.total_bytes - base_total <= 2 * one_table
    a.comb_table          # touch a: b becomes least recently used
    c.comb_table          # evicts b, not a
    assert a._comb is not None and b._comb is None and c._comb is not None
    # both tables of one key register as their sum
    rns_bytes = a.comb_rns.numel() * a.comb_rns.element_size()
    ent = tcfg.comb_registry._entries[id(a)]
    assert ent[1] == one_table + rns_bytes
    n = len(tcfg.comb_registry)
    a.free()
    assert len(tcfg.comb_registry) == n - 1 and a._comb_rns is None
    for p in (b, c):
        p.free()


class _Bundle(dict):
    """An operand bundle that a weak reference can watch."""


def test_kernel_operands_built_once_and_retired_with_the_key(monkeypatch):
    """Each key's operand bundle (``rns_kernels.pack``) is built once per
    key and device and memoized on the key (``kernel_operands``); no
    module-level structure of the port keeps it or its modulus, so the
    bundles go with the contexts."""
    import gc
    import sys
    import weakref
    built = []
    real = trk.pack
    monkeypatch.setattr(trk, "pack", lambda mbits, m: built.append(
        _Bundle(real(mbits, m))) or built[-1])
    pub = _mk_pub(0)
    priv = tsch.PrivateContext(pub, KD["p"], KD["q"])
    keys = [(priv.rns_base, priv.rns_p), (priv.rns_base, priv.rns_q),
            pub.rns_plan()]
    ops = [trk.kernel_operands(b, k, CPU) for b, k in keys]
    assert all(trk.kernel_operands(b, k, CPU) is o
               for (b, k), o in zip(keys, ops))
    assert all(k._dev_ops is o for (_, k), o in zip(keys, ops))
    moduli = {KD["p"] ** 2, KD["q"] ** 2, KD["n"] ** 2}
    assert len(built) == 3 and all(
        np.array_equal(bd["vec"], real(b.mbits, k.m)["vec"])
        for bd, (b, k) in zip(built, keys))
    assert {k.m for _, k in keys} == moduli
    watch = [weakref.ref(x) for x in built] + [
        weakref.ref(o["vec"]) for o in ops]
    pub.free()
    del pub, priv, keys, ops, built
    gc.collect()
    assert not [w for w in watch if w() is not None]
    for name, mod in list(sys.modules.items()):
        if not name.startswith("pailliercryptolib_python_tpu_torch"):
            continue
        for val in vars(mod).values():
            if isinstance(val, dict):
                assert not any(
                    k in moduli or isinstance(k, tuple) and moduli & set(k)
                    for k in val if isinstance(k, (int, tuple))), name


# -- profiling, baseconverter, profile_stages ----------------------------------

def test_profiling_hooks(tmp_path):
    sink = []
    with tprof.timed("op", sink):
        with tprof.annotate("he-op"):
            torch.zeros(4).sum()
    assert sink and sink[0][0] == "op" and sink[0][1] >= 0
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("he-op"):
            torch.ones(8).sum()
    files = os.listdir(tmp_path)
    assert files == ["trace_0.json"]
    with open(tmp_path / files[0]) as f:
        assert "he-op" in f.read()


def test_baseconverter_equals_the_reference():
    rng = random.Random(9)
    for _ in range(50):
        v = rng.getrandbits(rng.randrange(1, 600))
        h, d = format(v, "x"), str(v)
        assert tbc.hex2dec(h) == jbc.hex2dec(h) == d
        assert tbc.dec2hex(d) == jbc.dec2hex(d) == h
        assert tbc.BN2dec(tpt.BigNumber(v)) == jbc.BN2dec(
            jpt.BigNumber(v)) == d
        base = rng.choice([2, 8, 16, 36])
        s = np.base_repr(v, base).lower()
        assert tbc.getbase(s, base) == jbc.getbase(s, base) == v
        assert tbc.getdec(s, base) == jbc.getdec(s, base) == d
    assert tbc.hex2dec("") == jbc.hex2dec("") == "0"
    assert tbc.dec2hex("") == jbc.dec2hex("") == "0"


def test_profile_stages_and_rns_digits_match_the_reference(keys, ref_priv):
    pk, sk = keys
    tpriv = sk.prikey.context
    msgs = [3, 1 << 40, KD["n"] - 2, 0, 99, 100, 101, 102]
    tct = pk.pubkey.context.encrypt(msgs)
    jct = ref_priv.pub.import_cts(pk.pubkey.context.export_cts(tct, 8))
    jst = ref_priv.profile_stages(jct, 8)
    tst = tpriv.profile_stages(tct, 8)
    assert sorted(tst) == sorted(jst)
    for name, thunk in tst.items():
        out = thunk()
        if name == "stage5_to_ints":
            assert out == tpriv.decrypt_to_ints(tct, 8) == msgs
            assert out == jst[name]()
        elif name == "stage4_d2h":
            assert isinstance(out, np.ndarray)
            assert np.array_equal(out.astype(np.int64),
                                  np.asarray(jst[name]()).astype(np.int64))
        else:
            assert np.array_equal(out.numpy().astype(np.int64),
                                  np.asarray(jst[name]()).astype(np.int64))
    # the fixed-window digits the private context prepares for K6
    assert tpriv.rns_window == ref_priv.rns_window == \
        tcfg.get_config().rns_exp_window
    assert np.array_equal(tpriv.rdig_p, np.asarray(ref_priv.rdig_p))
    assert np.array_equal(tpriv.rdig_q, np.asarray(ref_priv.rdig_q))
    # the limb engines' stage names
    tcfg.set_config(rns_exp_window=4)
    saved = tcfg.get_config().decrypt_engine
    tcfg.set_config(decrypt_engine="limb")
    try:
        lpriv = tsch.PrivateContext(pk.pubkey.context, KD["p"], KD["q"])
    finally:
        tcfg.set_config(decrypt_engine=saved)
    lst = lpriv.profile_stages(tct, 8)
    assert "stage2_exp" in lst and lst["stage5_to_ints"]() == msgs
    wpriv = tsch.PrivateContext(pk.pubkey.context, KD["p"], KD["q"])
    assert wpriv.rns_window == 4 and len(wpriv.rdig_p) == -(-(
        max((KD["p"] - 1).bit_length(), (KD["q"] - 1).bit_length())) // 4)


def test_decrypt_device_equals_the_per_half_stages_and_the_reference(
        keys, ref_priv):
    """On the RNS route ``decrypt_device`` runs stage 2's CRT halves in
    one K2 launch (``rns_crt_exp_sched_pair``; its twins on the CPU).
    Its limbs equal those of ``profile_stages``' per-half stage-2 thunks
    chained through stage 3 (the p half's runs the launch, the q half's
    reads it), each half that of the one-half route
    (``rns_crt_exp_sched``), and the reference's decrypt."""
    pk, sk = keys
    tpriv = sk.prikey.context
    assert tpriv.use_rns
    msgs = [7, 1 << 50, KD["n"] - 1, 0, 5, 6, 1 << 100, 42]
    tct = pk.pubkey.context.encrypt(msgs)
    got = tpriv.decrypt_device(tct)
    base_m = tsch._crt_stage_reduce(tct, tpriv)
    st = tpriv._stage2(base_m)
    assert list(st) == ["stage2_rns_p_half", "stage2_rns_q_half"]
    u = torch.cat([st["stage2_rns_p_half"](), st["stage2_rns_q_half"]()],
                  dim=1)
    assert torch.equal(got, tsch._crt_stage_recombine(u, tpriv))
    for h, v, key, sq in ((0, base_m[:, :8], tpriv.rns_p, tpriv._sq_p),
                          (1, base_m[:, 8:], tpriv.rns_q, tpriv._sq_q)):
        one_half = tsch._rns.rns_crt_exp_sched(
            v, tpriv.rsched_q if h else tpriv.rsched_p, tpriv.rns_base, key,
            sq, tpriv.rns_sched_window, tpriv.Lh)
        assert torch.equal(u[:, 8 * h:8 * (h + 1)], one_half)
    jct = ref_priv.pub.import_cts(pk.pubkey.context.export_cts(tct, 8))
    assert np.array_equal(got.numpy().astype(np.int64),
                          np.asarray(ref_priv.decrypt_device(jct))
                          .astype(np.int64))
    assert tpriv.decrypt_to_ints(tct, 8) == msgs


def test_from_jax_state_takes_the_fixed_window_digits(ref_priv):
    jcfg_saved = jcfg.get_config().encrypt_engine
    jcfg.set_config(encrypt_engine="rns")
    try:
        state = _jax_state(ref_priv.pub, ref_priv)
    finally:
        jcfg.set_config(encrypt_engine=jcfg_saved)
    state["priv"].update(rdig_p=np.asarray(ref_priv.rdig_p)[::-1].copy(),
                         rdig_q=np.asarray(ref_priv.rdig_q),
                         rns_window=ref_priv.rns_window)
    _, tpriv = tpt.from_jax_state(state, CPU)
    assert tpriv.rns_window == ref_priv.rns_window
    assert np.array_equal(tpriv.rdig_p, np.asarray(ref_priv.rdig_p)[::-1])
    assert np.array_equal(tpriv.rdig_q, np.asarray(ref_priv.rdig_q))
    assert tpriv.rdig_p.dtype == np.int32
    # without them the port's own digits stand
    for f in ("rdig_p", "rdig_q", "rns_window"):
        del state["priv"][f]
    _, own = tpt.from_jax_state(state, CPU)
    assert np.array_equal(own.rdig_p, np.asarray(ref_priv.rdig_p))
