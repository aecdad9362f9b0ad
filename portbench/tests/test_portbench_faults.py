"""A whole run of each cell's traffic on the CPU (the harness's look for
a card skipped, the port on its plain twins, a 255-bit test key, small
sizes): sound it is correct; with the control in the program's place,
or with the timed path broken underneath, ``correct`` comes out false.

Faults, each where the answer is produced (the port's public API):
a step that returns its state unchanged; half of the batch left out,
the rest standing in for it; one answer altered.  The exchange between
chips does not exist on one card.  Encrypt also breaks its guarantee of
obfuscated ciphertexts: one obfuscator for every value, or an answer
cached and given again."""

import time

import numpy as np
import pytest

from portbench import reference as ref
from portbench import run as R
from portbench import traffic
from portbench.systems import ControlSystem, PortSystem

SMALL = {
    "hetero_lr": dict(rows=8, cols=2, cipher_pool=2, plain_pool=2),
    "decrypt_10k": dict(batch=8, pool=2),
    "encrypt_64_16k": dict(batch={"dist": "loguniform", "low": 4,
                                  "high": 16, "levels": 2}),
    "fedavg_8x4096": dict(parties=3, batch=6, pool=2),
}


def run_small(cfg, name, system=PortSystem, requests=3):
    import torch
    torch.set_num_threads(1)
    mix = traffic.load(name)
    mix["ops"][0].update(SMALL[name])
    return R.run_cell(name, cfg, mix, 2**31 + 99, 60.0, False, system,
                      "cpu", [], time.perf_counter(), max_requests=requests)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(test_config, name):
    res = run_small(test_config, name)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(test_config, name):
    res = run_small(test_config, name, ControlSystem)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0
    if name == "encrypt_64_16k":          # its one fixed obfuscator
        assert res["checks"]["unfresh_ciphertexts"]["value"] > 0


# -- faults planted in the port's API ----------------------------------


def _pt():
    import pailliercryptolib_python_tpu_torch as pt
    return pt


def rebuild(like, ints, exps):
    pt = _pt()
    ct = pt.ipclCipherText(like.public_key.pubkey,
                           [pt.BigNumber(c) for c in ints])
    return pt.PaillierEncryptedNumber(like.public_key, ct, exps, len(ints))


def ints_of(x):
    return [bn.value() for bn in x.ciphertextBN()], list(x.exponent())


def altered(x):
    ints, exps = ints_of(x)
    n = x.public_key.n
    ints[0] = ints[0] * (1 + n) % (n * n)
    return rebuild(x, ints, exps)


def half_left_out(x):
    ints, exps = ints_of(x)
    h = (len(ints) + 1) // 2
    return rebuild(x, ints[:h] + ints[:len(ints) - h],
                   exps[:h] + exps[:len(ints) - h])


def patch_matmul(monkeypatch, fault):
    cls = _pt().PaillierEncryptedNumber
    orig = cls.__matmul__

    def matmul(self, X):
        if fault == "unchanged":
            return self[0:X.shape[1]]
        if fault == "half":
            h = len(self) // 2
            return orig(self[0:h], X[:h]) * 2.0
        return altered(orig(self, X))
    monkeypatch.setattr(cls, "__matmul__", matmul)


def patch_add(monkeypatch, fault):
    cls = _pt().PaillierEncryptedNumber
    orig = cls.__add__

    def add(self, other):
        if fault == "unchanged":
            return self
        out = orig(self, other)
        return half_left_out(out) if fault == "half" else altered(out)
    monkeypatch.setattr(cls, "__add__", add)


def patch_encrypt(monkeypatch, fault):
    cls = _pt().PaillierPublicKey
    orig = cls.encrypt

    def encrypt(self, values, apply_obfuscator=True):
        if fault == "unchanged":           # the obfuscator step skipped
            return orig(self, values, apply_obfuscator=False)
        out = orig(self, values, apply_obfuscator)
        return half_left_out(out) if fault == "half" else altered(out)
    monkeypatch.setattr(cls, "encrypt", encrypt)


def patch_decrypt(monkeypatch, fault):
    cls = _pt().PaillierPrivateKey
    orig = cls.decrypt
    last = {}

    def decrypt(self, num):
        out = np.asarray(orig(self, num), dtype=np.float64)
        if fault == "unchanged":            # the previous answer again
            prev = last.get("out", np.zeros_like(out))
            last["out"] = out
            return prev
        if fault == "half":
            h = (len(out) + 1) // 2
            return np.concatenate([out[:h], out[:len(out) - h]])
        out = out.copy()
        out[0] = np.nextafter(out[0], np.inf)
        return out
    monkeypatch.setattr(cls, "decrypt", decrypt)


PATCH = {"hetero_lr": patch_matmul, "fedavg_8x4096": patch_add,
         "encrypt_64_16k": patch_encrypt, "decrypt_10k": patch_decrypt}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_is_not_correct(test_config, monkeypatch, name, fault):
    if name == "encrypt_64_16k":
        run_small(test_config, name, requests=1)   # comb built unpatched
    PATCH[name](monkeypatch, fault)
    res = run_small(test_config, name)
    assert not res["correct"], (name, fault, res["checks"])


def patch_obfuscator(monkeypatch, key, fault):
    cls = _pt().PaillierPublicKey
    orig = cls.encrypt
    one = key.obfuscator(0x5A5A5A5A)
    cache = {}

    def encrypt(self, values, apply_obfuscator=True):
        if fault == "cached":              # the same input's answer again
            k = np.asarray(values).tobytes()
            if k not in cache:
                cache[k] = orig(self, values, apply_obfuscator)
            return cache[k]
        raw = orig(self, values, apply_obfuscator=False)
        ints, exps = ints_of(raw)
        return rebuild(raw, [c * one % key.nsq for c in ints], exps)
    monkeypatch.setattr(cls, "encrypt", encrypt)


@pytest.mark.parametrize("fault", ["one_obfuscator", "cached"])
def test_encrypt_without_fresh_obfuscators_is_not_correct(
        test_config, monkeypatch, fault):
    """Every value right, the guarantee broken: only the residues show."""
    name = "encrypt_64_16k"
    run_small(test_config, name, requests=1)      # comb built unpatched
    patch_obfuscator(monkeypatch, ref.Key(test_config["key"]), fault)
    res = run_small(test_config, name)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] == 0, res["checks"]
    assert res["checks"]["unfresh_ciphertexts"]["value"] > 0
