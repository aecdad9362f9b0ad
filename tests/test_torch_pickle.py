"""Pickles written by the JAX package load in the port
(``pailliercryptolib_python_tpu_torch.api.loads`` / ``load``), on the CPU,
at the 256-bit fixed key: keys, a key pair and a ciphertext vector come
back as the port's classes and decrypt exactly."""

import io
import pickle

import numpy as np
import pytest
import torch

import pailliercryptolib_python_tpu as jpt
from pailliercryptolib_python_tpu.utils import config as jcfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
import pailliercryptolib_python_tpu_torch as tpt
from pailliercryptolib_python_tpu_torch import api as tapi
from pailliercryptolib_python_tpu_torch import device

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
X = np.array([3.25, -1.0, 40.0, 1e-3, -7.5, 123456.0])


@pytest.fixture
def jax_objects(monkeypatch):
    monkeypatch.setattr(device, "_default", CPU)     # where loads build
    prev = jcfg.get_config().encrypt_engine
    jcfg.set_config(encrypt_engine="rns")
    try:
        jpub = jpt.ipclPublicKey(KD["n"], KD["bits"], True, KD["hs"],
                                 KD["randbits"])
        jpk = jpt.PaillierPublicKey(jpub)
        jsk = jpt.PaillierPrivateKey(jpk, KD["p"], KD["q"])
        yield jpk, jsk, jpk.encrypt(X)
    finally:
        jcfg.set_config(encrypt_engine=prev)


@pytest.mark.parametrize("how", ["loads", "load"])
def test_jax_key_pair_and_ciphertext_load_and_decrypt(jax_objects, how):
    jpk, jsk, jct = jax_objects
    blob = pickle.dumps((jpk, jsk, jct))
    assert b"pailliercryptolib_python_tpu_torch" not in blob
    pk, sk, ct = (tapi.loads(blob) if how == "loads"
                  else tapi.load(io.BytesIO(blob)))
    assert isinstance(pk, tpt.PaillierPublicKey)
    assert isinstance(sk, tpt.PaillierPrivateKey)
    assert isinstance(ct, tpt.PaillierEncryptedNumber)
    assert (pk.n, sk.prikey.p, sk.prikey.q) == (KD["n"], KD["p"], KD["q"])
    assert [v.value() for v in ct.ciphertextBN()] == [
        v.value() for v in jct.ciphertextBN()]
    assert np.array_equal(sk.decrypt(ct), X)
    # the loaded key pair works as one: encrypt, add, decrypt
    assert np.array_equal(sk.decrypt(pk.encrypt(X) + ct), X + X)


@pytest.mark.parametrize("which", ["public", "private", "ciphertext"])
def test_each_jax_object_loads_alone(jax_objects, which):
    jpk, jsk, jct = jax_objects
    obj = {"public": jpk, "private": jsk, "ciphertext": jct}[which]
    got = tapi.loads(pickle.dumps(obj))
    want = {"public": tpt.PaillierPublicKey,
            "private": tpt.PaillierPrivateKey,
            "ciphertext": tpt.PaillierEncryptedNumber}[which]
    assert type(got) is want
    assert got.__getstate__() == obj.__getstate__() or which == "ciphertext"
    # plain pickle still gives the writer's classes
    assert type(pickle.loads(pickle.dumps(obj))) is type(obj)
