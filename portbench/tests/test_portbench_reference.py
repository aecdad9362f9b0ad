"""The plain reference agrees with a 256-bit round trip, both ways
between it and the port (on the CPU, where the port runs its plain
twins), and its judge catches a wrong answer."""

import random

import numpy as np
import pytest

from portbench import reference as ref


@pytest.fixture(scope="module")
def port(test_config):
    import torch
    import pailliercryptolib_python_tpu_torch as pt
    torch.set_num_threads(1)
    k = test_config["key"]
    ipub = pt.ipclPublicKey(k["n"], k["bits"], True, k["hs"], k["randbits"],
                            device="cpu")
    pk = pt.PaillierPublicKey(ipub)
    return pt, pk, pt.PaillierPrivateKey(pk, k["p"], k["q"])


def test_encode_is_the_librarys(port):
    from pailliercryptolib_python_tpu_torch.fixedpoint import FixedPointNumber
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0, 1, 50), rng.normal(0, 1e-9, 10),
                        [0.0, 1e-300, -2.5, 3.0]])
    m, e = ref.encode(x)
    n = port[1].n
    for xi, mi, ei in zip(x, m, e):
        f = FixedPointNumber.encode(float(xi), n, port[1].max_int)
        assert (mi % n, int(ei)) == (f.encoding, f.exponent)
        assert ref.decode(mi, ei) == xi or abs(xi) < 1e-200


def test_reference_round_trip(test_config):
    key = ref.Key(test_config["key"])
    rng = random.Random(5)
    for m in [0, 1, 12345, key.n - 1, key.n // 3]:
        c = key.encrypt(m, key.obfuscator(rng.getrandbits(127)))
        assert key.decrypt(c) == m % key.n
    a, b = 777, -31
    ca = key.encrypt(a, key.obfuscator(3))
    cb = key.encrypt(b, key.obfuscator(4))
    assert key.decrypt(ca * cb % key.nsq) == (a + b) % key.n
    assert key.decrypt(pow(ca, 9, key.nsq)) == 9 * a % key.n


def test_port_ciphertexts_decrypt_in_the_reference(port, test_config):
    pt, pk, sk = port
    key = ref.Key(test_config["key"])
    x = np.random.default_rng(1).normal(0, 1, 8)
    ct = pk.encrypt(x)
    cts = [bn.value() for bn in ct.ciphertextBN()]
    m, e = ref.encode(x)
    assert ct.exponent() == list(e)
    assert [key.decrypt(c) for c in cts] == [v % key.n for v in m]
    assert ref.judge_combined(key, cts, m, random.Random(0))
    assert ref.unfresh(key, [cts]) == 0
    bad = list(cts)
    bad[3] = bad[3] * (1 + key.n) % key.nsq
    assert not ref.judge_combined(key, bad, m, random.Random(0))
    swapped = [cts[1], cts[0]] + cts[2:]
    assert not ref.judge_combined(key, swapped, m, random.Random(0))
    raw = pk.encrypt(x, apply_obfuscator=False)
    assert ref.unfresh(key, [[bn.value() for bn in raw.ciphertextBN()]]) \
        == len(x)
    again = [bn.value() for bn in pk.encrypt(x).ciphertextBN()]
    assert again != cts and ref.unfresh(key, [cts, again]) == 0
    assert ref.unfresh(key, [cts, cts[:2]]) == 4


def test_one_obfuscator_shared_is_unfresh(test_config):
    """Ciphertexts of different plaintexts under one obfuscator share
    their residue mod n; under new obfuscators they do not."""
    key = ref.Key(test_config["key"])
    m = [5, -7, 11, 123456789]
    one = key.obfuscator(99)
    assert ref.unfresh(key, [[key.encrypt(v, one) for v in m]]) == len(m)
    own = [key.encrypt(v, key.obfuscator(i + 2)) for i, v in enumerate(m)]
    assert ref.unfresh(key, [own]) == 0


def test_reference_ciphertexts_decrypt_in_the_port(port, test_config):
    pt, pk, sk = port
    key = ref.Key(test_config["key"])
    x = np.random.default_rng(2).normal(0, 100, 8)
    m, e = ref.encode(x)
    cts = [key.encrypt(v, key.obfuscator(i + 1)) for i, v in enumerate(m)]
    ct = pt.ipclCipherText(pk.pubkey, [pt.BigNumber(c) for c in cts])
    num = pt.PaillierEncryptedNumber(pk, ct, e, len(x))
    assert np.array_equal(np.asarray(sk.decrypt(num)), x)


def test_expected_matmul_and_sum_match_the_port(port, test_config):
    pt, pk, sk = port
    key = ref.Key(test_config["key"])
    rng = np.random.default_rng(4)
    d, X = rng.uniform(-1, 1, 6), rng.normal(0, 1, (6, 3))
    out = pk.encrypt(d) @ X
    sums, tgt = ref.matmul_expected(d, X)
    assert out.exponent() == tgt
    assert ref.judge_each(key, [bn.value() for bn in out.ciphertextBN()],
                          sums)
    ys = [rng.normal(0, 0.01, 5) for _ in range(3)]
    acc = pk.encrypt(ys[0]) + pk.encrypt(ys[1]) + pk.encrypt(ys[2])
    mant, tgt = ref.sum_expected(ys)
    assert acc.exponent() == list(tgt)
    assert ref.judge_each(key, [bn.value() for bn in acc.ciphertextBN()],
                          mant)
    assert np.allclose(sk.decrypt(acc), ys[0] + ys[1] + ys[2])
