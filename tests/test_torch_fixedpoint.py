"""The port's fixed-point codec against the JAX package's, bit for bit.

Encode and decode, scalar and vector (``encode_vector``,
``decode_limbs_vector``), on the samples of ``tests/test_fixedpoint.py``
(same seed), with the same error types and messages.  Pure host code:
no device, no file outside the repository.
"""

import math
import random

import numpy as np
import pytest

from pailliercryptolib_python_tpu import fixedpoint as jfp
from pailliercryptolib_python_tpu_torch import fixedpoint as tfp
from pailliercryptolib_python_tpu_torch.ops.limb import ints_to_limbs

rng = random.Random(11)

N = (1 << 255) - 19
MAX_INT = N // 3 - 1

SAMPLES = ([0, 1, -1, 2, -2, 5000, -5000, 10 ** 12, -(10 ** 12)]
           + [0.5, -0.5, 0.2, -0.2, 1234.5678, -1234.5678, 1e-10, -1e-10,
              1e-250, 3.141592653589793, 2 ** 52 + 0.5, 1e100, -1e100]
           + [rng.uniform(-1e6, 1e6) for _ in range(50)]
           + [rng.randint(-10 ** 15, 10 ** 15) for _ in range(50)]
           + [np.float64(7.25), np.int64(42), np.int32(-9), np.float32(1.5)])


def _same_number(a, b):
    assert (a.encoding, a.exponent, a.n, a.max_int) == (
        b.encoding, b.exponent, b.n, b.max_int)


@pytest.mark.parametrize("value", SAMPLES, ids=lambda v: repr(v)[:24])
def test_encode_decode_scalar(value):
    ours = tfp.FixedPointNumber.encode(value, N, MAX_INT)
    ref = jfp.FixedPointNumber.encode(value, N, MAX_INT)
    _same_number(ours, ref)
    d_ours, d_ref = ours.decode(), ref.decode()
    assert type(d_ours) is type(d_ref)
    assert d_ours == d_ref or (math.isnan(d_ours) and math.isnan(d_ref))


def _raises_same(fn_ours, fn_ref, exc):
    with pytest.raises(exc) as e_ours:
        fn_ours()
    with pytest.raises(exc) as e_ref:
        fn_ref()
    assert str(e_ours.value) == str(e_ref.value)


@pytest.mark.parametrize("case", ["bounds", "vector_bounds", "overflow",
                                  "corrupted", "type", "exponent"])
def test_errors_match(case):
    if case == "bounds":
        _raises_same(lambda: tfp.FixedPointNumber.encode(N, N, MAX_INT),
                     lambda: jfp.FixedPointNumber.encode(N, N, MAX_INT),
                     ValueError)
    elif case == "vector_bounds":
        _raises_same(lambda: tfp.encode_vector([1, N], N, MAX_INT),
                     lambda: jfp.encode_vector([1, N], N, MAX_INT),
                     ValueError)
    elif case == "overflow":
        bad = MAX_INT + 5
        _raises_same(lambda: tfp.FixedPointNumber(bad, 0, N, MAX_INT).decode(),
                     lambda: jfp.FixedPointNumber(bad, 0, N, MAX_INT).decode(),
                     OverflowError)
    elif case == "corrupted":
        _raises_same(lambda: tfp.FixedPointNumber(N, 0, N, MAX_INT).decode(),
                     lambda: jfp.FixedPointNumber(N, 0, N, MAX_INT).decode(),
                     ValueError)
    elif case == "type":
        _raises_same(lambda: tfp.FixedPointNumber.encode("1", N, MAX_INT),
                     lambda: jfp.FixedPointNumber.encode("1", N, MAX_INT),
                     TypeError)
    else:
        a = tfp.FixedPointNumber.encode(12.75, N, MAX_INT)
        b = jfp.FixedPointNumber.encode(12.75, N, MAX_INT)
        _raises_same(lambda: a.increase_exponent_to(a.exponent - 1),
                     lambda: b.increase_exponent_to(b.exponent - 1),
                     ValueError)


VECTORS = {
    "samples": SAMPLES,
    "floats": np.array([0.5, -0.25, 1234.5678, 1e-300, 0.0, -1e9]),
    "ints": np.array([0, 1, -1, 10 ** 14, -(10 ** 14)], dtype=np.int64),
    "mixed": [1, 2.5, -3, -0.125],
    "uniform": np.random.default_rng(5).uniform(-1000.0, 1000.0, 257),
}


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_encode_vector_and_decode_limbs(name):
    vals = VECTORS[name]
    encs, exps = tfp.encode_vector(vals, N, MAX_INT)
    r_encs, r_exps = jfp.encode_vector(vals, N, MAX_INT)
    assert list(encs) == list(r_encs)
    assert np.array_equal(np.asarray(exps), np.asarray(r_exps))
    # the vector path equals the scalar encoder
    for v, e, x in zip(vals, encs, exps):
        s = jfp.FixedPointNumber.encode(v, N, MAX_INT)
        assert (e, int(x)) == (s.encoding, s.exponent)
    # decode straight off the limb array, as the decrypt's host tail does
    L = -(-N.bit_length() // 16)
    limbs = ints_to_limbs(list(encs) + [0, 1], L)
    ours = tfp.decode_limbs_vector(limbs, len(encs), np.asarray(exps), N,
                                   MAX_INT)
    ref = jfp.decode_limbs_vector(limbs, len(encs), np.asarray(exps), N,
                                  MAX_INT)
    assert list(ours) == list(ref)
    assert list(ours) == tfp.decode_vector(encs, exps, N, MAX_INT)
