"""The traffic is deterministic by seed; seeds change the values and the
order, never the set of sizes."""

import collections

import numpy as np
import pytest

from portbench import kinds, traffic

MIXES = ["hetero_lr", "decrypt_10k", "encrypt_64_16k", "fedavg_8x4096"]


def made(name, seed):
    mix = traffic.load(name)
    ks = kinds.make(mix, seed)
    order = traffic.cycle([k.n_variants for k in ks], seed)
    return ks, order


def inputs(ks):
    out = []
    for k in ks:
        for attr in ("d", "X", "x"):
            val = getattr(k, attr, None)
            if val is not None:
                out.append(np.concatenate([np.ravel(a) for a in val])
                           if isinstance(val[0], np.ndarray) else
                           np.concatenate([np.ravel(b) for a in val
                                           for b in a]))
    return out


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    seed = 2**31 + 12345
    (k1, o1), (k2, o2) = made(name, seed), made(name, seed)
    assert o1 == o2
    for a, b in zip(inputs(k1), inputs(k2)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_sizes_other_values(name):
    (k1, o1), (k2, o2) = made(name, 11), made(name, 12)
    assert collections.Counter(o1) == collections.Counter(o2)
    sizes1 = sorted(k1[0].values(v) for _, v in o1)
    sizes2 = sorted(k2[0].values(v) for _, v in o2)
    assert sizes1 == sizes2
    assert not any(np.array_equal(a, b)
                   for a, b in zip(inputs(k1), inputs(k2)))


def test_loguniform_levels():
    s = traffic.sizes({"dist": "loguniform", "low": 64, "high": 16384,
                       "levels": 32})
    assert len(s) == 32 and s == sorted(s)
    assert 64 <= s[0] < 72 and 15000 < s[-1] <= 16384
    assert 900 < np.median(s) < 1150
    assert traffic.sizes(4096) == [4096]


def test_encrypt_cycle_walks_every_size():
    ks, order = made("encrypt_64_16k", 3)
    assert sorted(v for _, v in order) == list(range(32))
