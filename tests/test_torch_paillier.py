"""The port's scheme and API layers against the JAX package on the CPU, at
the 256-bit fixed key: the frozen KAT vector, encryption with injected
obfuscator digits, ``+``, ``sum`` and decryption, state carried across
with ``from_jax_state``, pickle state tuples, and the import boundary."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pailliercryptolib_python_tpu as jpt
from pailliercryptolib_python_tpu.models import paillier as jsch
from pailliercryptolib_python_tpu.utils import config as jcfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import rns as trns

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
CPU = torch.device("cpu")
KD = fixed_key_ints(256)


@pytest.fixture(autouse=True)
def _jax_rns_encrypt():
    """The JAX package on the CPU takes the limb encrypt engine unless
    told otherwise; the port has only the RNS one."""
    prev = jcfg.get_config().encrypt_engine
    jcfg.set_config(encrypt_engine="rns")
    yield
    jcfg.set_config(encrypt_engine=prev)


def _digits(n_win, window, B):
    rng = np.random.default_rng(1000 + B)
    return rng.integers(0, 1 << window, size=(n_win, B)).astype(np.uint16)


def _inject_digits(monkeypatch, jctx, tctx):
    """Same obfuscator digits in both packages (keyed by batch width)."""
    w, nw = tctx.comb_window, -(-tctx.randbits // tctx.comb_window)
    assert (jctx.comb_window, jctx.randbits) == (w, tctx.randbits)
    monkeypatch.setattr(jctx, "sample_obfuscator_digits",
                        lambda b, as_numpy=False: _digits(nw, w, b))
    monkeypatch.setattr(tctx, "sample_obfuscator_digits",
                        lambda b: _digits(nw, w, b))


def _keys():
    jpub = jpt.ipclPublicKey(KD["n"], KD["bits"], True, KD["hs"],
                             KD["randbits"])
    tpub = tpt.ipclPublicKey(KD["n"], KD["bits"], True, KD["hs"],
                             KD["randbits"], device=CPU)
    jpk, tpk = jpt.PaillierPublicKey(jpub), tpt.PaillierPublicKey(tpub)
    return (jpk, jpt.PaillierPrivateKey(jpk, KD["p"], KD["q"]),
            tpk, tpt.PaillierPrivateKey(tpk, KD["p"], KD["q"]))


def _cts(enc):
    return [v.value() for v in enc.ciphertextBN()]


def test_kat_256_through_rns_comb():
    with open(os.path.join(HERE, "kat_vectors.json")) as f:
        vec = next(v for v in json.load(f)["vectors"] if v["bits"] == 256)
    p, q = int(vec["p"], 16), int(vec["q"], 16)
    n = p * q
    pub = tsch.PublicContext(n, n.bit_length(), True, int(vec["hs"], 16),
                             vec["randbits"], device=CPU)
    priv = tsch.PrivateContext(pub, p, q)
    msgs = [int(m, 16) for m in vec["messages"]]
    rs = [int(r, 16) for r in vec["obfuscator_r"]]
    raw = pub.encrypt(msgs, apply_obfuscator=False)
    assert pub.export_cts(raw, len(msgs)) == [int(c, 16) for c in
                                              vec["raw_ciphertexts"]]
    w, nw = pub.comb_window, -(-pub.randbits // pub.comb_window)
    m_dev = pub.encodings_to_device(msgs)
    digits = np.zeros((nw, m_dev.shape[1]), dtype=np.int64)
    for b, r in enumerate(rs):
        for j in range(nw):
            digits[j, b] = (r >> (w * j)) & ((1 << w) - 1)
    base, key = pub.rns_plan()
    ct = trns.rns_comb_product(
        tsch._encrypt_raw_canonical(m_dev, pub.n_limbs, pub.L),
        pub.comb_rns, torch.from_numpy(digits), base, key, pub.ctx, pub.L)
    djn = [int(c, 16) for c in vec["djn_ciphertexts"]]
    assert pub.export_cts(ct, len(msgs)) == djn
    assert priv.decrypt_to_ints(pub.import_cts(djn), len(msgs)) == msgs


def test_encrypt_with_injected_digits(monkeypatch):
    jpub = jsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"])
    tpub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"], device=CPU)
    _inject_digits(monkeypatch, jpub, tpub)
    rng = np.random.default_rng(5)
    msgs = [int.from_bytes(rng.bytes(31), "little") % KD["n"]
            for _ in range(7)]
    jct = np.asarray(jpub.encrypt(msgs)).astype(np.int64)
    tct = tpub.encrypt(msgs).numpy().astype(np.int64)
    assert np.array_equal(tct, jct)               # Montgomery limbs, exact
    assert tpub.export_cts(torch.from_numpy(tct), 7) == \
        jpub.export_cts(jpub.encrypt(msgs), 7)
    # comb states equal too
    assert np.array_equal(tpub.comb_rns.numpy().astype(np.int64),
                          np.asarray(jpub.comb_rns).astype(np.int64))


def test_add_sum_decrypt_floats(monkeypatch):
    jpk, jsk, tpk, tsk = _keys()
    _inject_digits(monkeypatch, jpk.pubkey.context, tpk.pubkey.context)
    rng = np.random.default_rng(11)
    x = rng.uniform(-100.0, 100.0, 7)        # every batch is 8 wide:
    y = rng.uniform(-100.0, 100.0, 7)        # JAX compiles decrypt once
    y[3] = 7                                   # an int-valued float
    jx, jy, tx, ty = jpk.encrypt(x), jpk.encrypt(y), tpk.encrypt(x), \
        tpk.encrypt(y)
    assert _cts(tx) == _cts(jx) and tx.exponent() == jx.exponent()
    for jres, tres, want in ((jx + jy, tx + ty, x + y),
                             (jx.sum(), tx.sum(), x.sum()),
                             (jx + 2.5, tx + 2.5, x + 2.5)):
        assert _cts(tres) == _cts(jres)
        assert tres.exponent() == jres.exponent()
        jd, td = np.asarray(jsk.decrypt(jres)), np.asarray(tsk.decrypt(tres))
        np.testing.assert_allclose(td, jd, rtol=1e-12)
        np.testing.assert_allclose(td, want, rtol=1e-12)
        assert tsk.raw_decrypt(tres) == jsk.raw_decrypt(jres)
    # ct * non-negative plaintext (limb route) and indexing
    assert _cts(tx[2:5] * 3) == _cts(jx[2:5] * 3)
    np.testing.assert_allclose(tsk.decrypt(tx[4]), x[4], rtol=1e-12)


def test_out_of_slice_operators_raise(monkeypatch):
    """What the port still lacks raises NotImplementedError: the limb
    encrypt engine (the limb comb) and, on a context without mm3 weights,
    the limb decrypt's per-element-moduli branch (kernels K9/K10)."""
    from pailliercryptolib_python_tpu_torch.utils import config as tcfg
    _, _, tpk, tsk = _keys()
    ct = tpk.encrypt(np.array([1.5, 2.0]))
    monkeypatch.setattr(tcfg.get_config(), "encrypt_engine", "limb")
    with pytest.raises(NotImplementedError, match="encrypt_engine"):
        tpk.encrypt(np.array([1.0]))
    with pytest.raises(NotImplementedError, match="encrypt_engine"):
        tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                           KD["randbits"], device=CPU)
    monkeypatch.setattr(tcfg.get_config(), "encrypt_engine", "auto")
    monkeypatch.setattr(tcfg.get_config(), "decrypt_engine", "limb")
    priv = tsch.PrivateContext(tpk.pubkey.context, KD["p"], KD["q"])
    assert priv._sq_p.wmu is None and not priv.use_rns
    with pytest.raises(NotImplementedError, match="K9/K10"):
        priv.decrypt_to_ints(ct.ciphertext().device_array(), 2)
    np.testing.assert_allclose(tsk.decrypt(ct), [1.5, 2.0])  # RNS still


def test_port_reads_no_file_of_the_jax_package():
    """Outside docstrings and comments, no source of the port names the
    JAX package: it neither imports it nor builds a file of it (the
    native helpers build the port's own copy of sieve.c)."""
    import ast
    import re
    from pailliercryptolib_python_tpu_torch import native
    pkg = os.path.join(ROOT, "pailliercryptolib_python_tpu_torch")
    jax_pkg = re.compile(r"pailliercryptolib_python_tpu(?!_torch)")
    assert os.path.dirname(native._SRC) == os.path.join(pkg, "native")
    assert os.path.exists(native._SRC)
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            tree = ast.parse(open(path).read())
            docs = {id(n.body[0].value) for n in ast.walk(tree)
                    if isinstance(n, (ast.Module, ast.ClassDef,
                                      ast.FunctionDef))
                    and n.body and isinstance(n.body[0], ast.Expr)
                    and isinstance(n.body[0].value, ast.Constant)}
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Constant) and isinstance(
                        node.value, str) and id(node) not in docs:
                    names = [node.value]
                elif isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                offenders += [(path, v) for v in names if jax_pkg.search(v)]
    assert offenders == []


def _mont(ctx):
    return {f: np.asarray(getattr(ctx, f)) for f in
            ("n_limbs", "n0inv", "r2", "one", "wmu", "wm", "off1", "off2")
            if getattr(ctx, f) is not None}


def _jax_state(jpub, jpriv):
    """The JAX contexts' per-key arrays as numpy (from_jax_state input)."""
    from pailliercryptolib_python_tpu.ops import pallas_rns
    base, key = jpub._rns_enc_plan()
    rkey = lambda k: {f: np.asarray(getattr(k, f)) for f in trns.KEY_ARRAYS}
    priv = {f: np.asarray(getattr(jpriv, f)) for f in
            ("Cp_lo", "Cp_hi", "Cq_lo", "Cq_hi", "f2_p", "f2_q", "pinv_R",
             "qinv_R", "hpR", "hqR", "pinvqR", "p_limbs", "q_limbs",
             "rsched_p", "rsched_q")}
    priv.update(sq_p=_mont(jpriv._sq_p), sq_q=_mont(jpriv._sq_q),
                p_ctx=_mont(jpriv._p_ctx), q_ctx=_mont(jpriv._q_ctx),
                rns_p=rkey(jpriv.rns_p), rns_q=rkey(jpriv.rns_q),
                pack_p=pallas_rns.pack(jpriv.rns_base.mbits, jpriv.rns_p.m),
                pack_q=pallas_rns.pack(jpriv.rns_base.mbits, jpriv.rns_q.m),
                rns_sched_window=jpriv.rns_sched_window)
    pub = dict(ctx=_mont(jpub.ctx), rns_key=rkey(key),
               rns_pack=pallas_rns.pack(base.mbits, key.m),
               comb_window=jpub.comb_window,
               comb_rns=np.asarray(jpub.comb_rns))
    return dict(n=jpub.n, p=jpriv.p, q=jpriv.q, hs=jpub.hs, bits=jpub.bits,
                randbits=jpub.randbits, pub=pub, priv=priv)


def test_from_jax_state(monkeypatch):
    jpub = jsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"])
    jpriv = jsch.PrivateContext(jpub, KD["p"], KD["q"])
    state = _jax_state(jpub, jpriv)
    tpub, tpriv = tpt.from_jax_state(state, CPU)
    # the port's own host builders make the same arrays
    opub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                              KD["randbits"], device=CPU)
    opriv = tsch.PrivateContext(opub, KD["p"], KD["q"])
    eq = lambda port, ref: np.array_equal(
        (port.numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port)).astype(np.int64),
        np.asarray(ref).astype(np.int64))
    for f, ref in state["pub"]["ctx"].items():
        assert eq(getattr(opub.ctx, f) if f != "n0inv"
                  else [opub.ctx.n0inv], ref), f
    for f in trns.KEY_ARRAYS:
        assert eq(getattr(opub.rns_plan()[1], f), state["pub"]["rns_key"][f])
        assert eq(getattr(opriv.rns_p, f), state["priv"]["rns_p"][f])
        assert eq(getattr(opriv.rns_q, f), state["priv"]["rns_q"][f])
    for f, ref in state["priv"].items():
        if isinstance(ref, np.ndarray):
            assert eq(getattr(opriv, f), ref), f
    for f in ("sq_p", "sq_q", "p_ctx", "q_ctx"):
        for g, ref in state["priv"][f].items():
            got = getattr(getattr(opriv, "_" + f), g)
            assert eq(got if g != "n0inv" else [got], ref), (f, g)
    assert opriv.rns_sched_window == state["priv"]["rns_sched_window"]
    assert opub.comb_window == state["pub"]["comb_window"]
    # and the carried-over contexts compute what JAX computes
    _inject_digits(monkeypatch, jpub, tpub)
    msgs = [(i * 0x9E3779B97F4A7C15) % KD["n"] for i in range(7)]
    jct = jpub.encrypt(msgs)
    tct = tpub.encrypt(msgs)
    assert np.array_equal(tct.numpy().astype(np.int64),
                          np.asarray(jct).astype(np.int64))
    assert tpriv.decrypt_to_ints(tct, 7) == jpriv.decrypt_to_ints(jct, 7) \
        == msgs


def test_pickle_state_tuples_cross_packages(monkeypatch):
    from pailliercryptolib_python_tpu_torch import device
    monkeypatch.setattr(device, "_default", CPU)  # unpickled keys' device
    jpk, jsk, tpk, tsk = _keys()
    # public key: JAX state -> port object and back
    tkey = tpt.ipclPublicKey.__new__(tpt.ipclPublicKey)
    tkey.__setstate__(jpk.pubkey.__getstate__())
    assert tkey.__getstate__() == jpk.pubkey.__getstate__()
    # private key and ciphertext states
    assert tsk.prikey.__getstate__() == jsk.prikey.__getstate__()
    x = np.array([3.25, -1.0, 40.0])
    jct = jpk.encrypt(x)
    tct = tpt.ipclCipherText.__new__(tpt.ipclCipherText)
    tct.__setstate__(jct.ciphertext().__getstate__())
    dev = tct.device_array()
    assert tct.host_ints() == _cts(jct)
    got = tsk.prikey.context.decrypt_to_ints(dev, 3)
    assert got == jsk.prikey.context.decrypt_to_ints(
        jct.ciphertext().device_array(), 3)


def test_default_device_is_cuda_without_fallback():
    assert tpt.get_device() == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                           KD["randbits"])


def test_import_does_not_load_jax():
    code = ("import sys, pailliercryptolib_python_tpu_torch as p; "
            "p.PaillierPublicKey; "
            "import pailliercryptolib_python_tpu_torch.kernels; "
            "print('jax' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("parallel", ["0", "1"])
def test_keygen(parallel, monkeypatch):
    """Host keygen, serial and through the 2-process prime pool."""
    from pailliercryptolib_python_tpu_torch.utils import config as tcfg
    monkeypatch.setattr(tcfg.get_config(), "keygen_parallel", parallel)
    kd = tsch.generate_key_ints(256)
    p, q, n = kd["p"], kd["q"], kd["n"]
    assert p * q == n and n.bit_length() == 256 and p != q
    assert p.bit_length() == q.bit_length() == 128
    assert tsch.is_probable_prime(p) and tsch.is_probable_prime(q)
    lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
    assert pow(kd["hs"], lam, n * n) == 1      # hs is an n-th residue
    if parallel == "0":
        pk, sk = tpt.PaillierKeypair.generate_keypair(256, device=CPU)
        x = np.array([0.5, -3.25, 1e3])
        np.testing.assert_allclose(sk.decrypt(pk.encrypt(x)), x, rtol=1e-12)
