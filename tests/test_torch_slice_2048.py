"""The port's whole main path at a 2048-bit key on the CPU (plain twins of
the kernels): the frozen 2048-bit KAT vector through the RNS comb and CRT
decrypt, float encrypt -> ``+`` -> ``sum`` -> decrypt through the public
API against numpy, and ct*pt by mixed-sign weights (the RNS route and the
inversion) with ``dot``.  Marked slow (run with ``-m slow``)."""

import json
import os

import numpy as np
import pytest
import torch

import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import rns as trns
from pailliercryptolib_python_tpu_torch.utils.fixtures import fixed_key_ints

HERE = os.path.dirname(__file__)
CPU = torch.device("cpu")


@pytest.mark.slow
def test_slice_2048_kat_and_api():
    with open(os.path.join(HERE, "kat_vectors.json")) as f:
        vec = next(v for v in json.load(f)["vectors"] if v["bits"] == 2048)
    p, q = int(vec["p"], 16), int(vec["q"], 16)
    n = p * q
    pub = tsch.PublicContext(n, n.bit_length(), True, int(vec["hs"], 16),
                             vec["randbits"], device=CPU)
    priv = tsch.PrivateContext(pub, p, q)
    assert (pub.L, pub.rns_plan()[0].CH, priv.rns_base.CH) == (257, 521, 261)
    msgs = [int(m, 16) for m in vec["messages"]]
    w, nw = pub.comb_window, -(-pub.randbits // pub.comb_window)
    m_dev = pub.encodings_to_device(msgs)
    digits = np.zeros((nw, m_dev.shape[1]), dtype=np.int64)
    for b, r in enumerate(int(r, 16) for r in vec["obfuscator_r"]):
        for j in range(nw):
            digits[j, b] = (r >> (w * j)) & ((1 << w) - 1)
    base, key = pub.rns_plan()
    ct = trns.rns_comb_product(
        tsch._encrypt_raw_canonical(m_dev, pub.n_limbs, pub.L),
        pub.comb_rns, torch.from_numpy(digits), base, key, pub.ctx, pub.L)
    djn = [int(c, 16) for c in vec["djn_ciphertexts"]]
    assert pub.export_cts(ct, len(msgs)) == djn
    assert priv.decrypt_to_ints(pub.import_cts(djn), len(msgs)) == msgs

    kd = fixed_key_ints(2048)
    pk = tpt.PaillierPublicKey(tpt.ipclPublicKey(
        kd["n"], kd["bits"], True, kd["hs"], kd["randbits"], device=CPU))
    sk = tpt.PaillierPrivateKey(pk, kd["p"], kd["q"])
    rng = np.random.default_rng(2048)
    x, y = rng.uniform(-1e3, 1e3, 6), rng.uniform(-1e3, 1e3, 6)
    cx, cy = pk.encrypt(x), pk.encrypt(y)
    np.testing.assert_allclose(sk.decrypt(cx + cy), x + y, rtol=1e-12)
    np.testing.assert_allclose(sk.decrypt(cx.sum()), x.sum(), rtol=1e-12)


@pytest.mark.slow
def test_slice_2048_ctpt_and_dot():
    kd = fixed_key_ints(2048)
    pk = tpt.PaillierPublicKey(tpt.ipclPublicKey(
        kd["n"], kd["bits"], True, kd["hs"], kd["randbits"], device=CPU))
    sk = tpt.PaillierPrivateKey(pk, kd["p"], kd["q"])
    rng = np.random.default_rng(2049)
    x, w = rng.uniform(-1e3, 1e3, 4), rng.uniform(-1.0, 1.0, 4)
    w[0], w[1] = -abs(w[0]), abs(w[1])
    cx = pk.encrypt(x)
    np.testing.assert_allclose(sk.decrypt(cx * w), x * w, rtol=1e-12)
    np.testing.assert_allclose(sk.decrypt(cx.dot(w)), x @ w, rtol=1e-9)
