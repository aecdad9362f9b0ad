"""Fixed-point codec: float/int <-> (encoding mod n, base-2 exponent).

A copy of ``pailliercryptolib_python_tpu/fixedpoint.py`` (pure Python and
numpy); the JAX package's module cannot be imported without ``jax``.
The behaviour is the same bit for bit:

* BASE = 2; float exponents derive from the IEEE mantissa via frexp:
  exponent = floor((53 - frexp(x)[1]) / log2(BASE)); int exponents are 0;
* encode: round(x * BASE^exponent) mod n, ValueError outside +/- max_int;
  values below 1e-200 collapse to integer zero;
* decode: encoding <= max_int -> positive, >= n - max_int -> negative,
  else OverflowError.

``encode_vector`` / ``decode_vector`` / ``decode_limbs_vector`` are the
batched paths used by the API layer; ``encode_vector`` and
``decode_limbs_vector`` run inside the spans ``pct.fixedpoint.encode`` and
``pct.fixedpoint.decode`` (``utils/profiling.py``).
"""

from __future__ import annotations

import math
import sys

import numpy as np

from .utils.profiling import annotate


class FixedPointNumber:
    """Scalar fixed-point encoding (reference-compatible)."""

    BASE = 2
    LOG2_BASE = math.log(BASE, 2)
    FLOAT_MANTISSA_BITS = sys.float_info.mant_dig

    Q = 293973345475167247070445277780365744413 ** 2

    def __init__(self, encoding, exponent, n=None, max_int=None):
        if n is None:
            self.n = FixedPointNumber.Q
            self.max_int = self.n // 2
        else:
            self.n = n
            self.max_int = max_int if max_int is not None else n // 2
        self.encoding = encoding
        self.exponent = exponent

    # -- encode / decode ----------------------------------------------------

    @classmethod
    def calculate_exponent_from_precision(cls, precision):
        return math.floor(math.log(precision, cls.BASE))

    @classmethod
    def encode(cls, scalar, n=None, max_int=None, precision=None,
               max_exponent=None):
        if np.abs(scalar) < 1e-200:
            scalar = 0

        if n is None:
            n = cls.Q
            max_int = n // 2

        if precision is None:
            if isinstance(scalar, (int, np.int16, np.int32, np.int64)):
                exponent = 0
            elif isinstance(scalar, (float, np.float16, np.float32,
                                     np.float64)):
                flt_exponent = math.frexp(scalar)[1]
                lsb_exponent = cls.FLOAT_MANTISSA_BITS - flt_exponent
                exponent = math.floor(lsb_exponent / cls.LOG2_BASE)
            else:
                raise TypeError(
                    "Don't know the precision of type %s." % type(scalar))
        else:
            exponent = cls.calculate_exponent_from_precision(precision)

        if max_exponent is not None:
            exponent = max(max_exponent, exponent)

        int_fixpoint = int(round(scalar * pow(cls.BASE, exponent)))

        if abs(int_fixpoint) > max_int:
            raise ValueError(
                f"Integer needs to be within +/- {max_int},"
                f"but got {int_fixpoint}, basic info: scalar={scalar}, "
                f"base={cls.BASE}, exponent={exponent}")

        return cls(int_fixpoint % n, exponent, n, max_int)

    def decode(self):
        if self.encoding >= self.n:
            raise ValueError("Attempted to decode corrupted number")
        elif self.encoding <= self.max_int:
            mantissa = self.encoding
        elif self.encoding >= self.n - self.max_int:
            mantissa = self.encoding - self.n
        else:
            raise OverflowError(
                f"Overflow detected in decode number, encoding: "
                f"{self.encoding}, {self.exponent} {self.n}")
        return mantissa * pow(self.BASE, -self.exponent)

    def increase_exponent_to(self, new_exponent):
        if new_exponent < self.exponent:
            raise ValueError(
                "New exponent %i should be greater than"
                "old exponent %i" % (new_exponent, self.exponent))
        factor = pow(self.BASE, new_exponent - self.exponent)
        return FixedPointNumber(self.encoding * factor % self.n,
                                new_exponent, self.n, self.max_int)

    # -- scalar arithmetic (reference-compatible operator set) --------------

    def _align(self, other):
        x, y = self, other
        if x.exponent < y.exponent:
            x = x.increase_exponent_to(y.exponent)
        elif x.exponent > y.exponent:
            y = y.increase_exponent_to(x.exponent)
        return x, y

    def _coerce(self, other):
        if other.n != self.n:
            return self.encode(other.decode(), n=self.n, max_int=self.max_int)
        return other

    def _add_fixed(self, other):
        other = self._coerce(other)
        x, y = self._align(other)
        return FixedPointNumber((x.encoding + y.encoding) % self.n,
                                x.exponent, self.n, self.max_int)

    def _sub_fixed(self, other):
        other = self._coerce(other)
        x, y = self._align(other)
        return FixedPointNumber((x.encoding - y.encoding) % self.n,
                                x.exponent, self.n, self.max_int)

    def __add__(self, other):
        if isinstance(other, FixedPointNumber):
            return self._add_fixed(other)
        if type(other).__name__ == "PaillierEncryptedNumber":
            return other + self.decode()
        return self._add_fixed(
            self.encode(other, n=self.n, max_int=self.max_int))

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if isinstance(other, FixedPointNumber):
            return self._sub_fixed(other)
        if type(other).__name__ == "PaillierEncryptedNumber":
            return (other - self.decode()) * -1
        return self._add_fixed(
            self.encode(-1 * other, n=self.n, max_int=self.max_int))

    def __rsub__(self, other):
        if type(other).__name__ == "PaillierEncryptedNumber":
            return other - self.decode()
        x = self.__sub__(other)
        return self.encode(-1 * x.decode(), n=self.n, max_int=self.max_int)

    def __mul__(self, other):
        if isinstance(other, FixedPointNumber):
            return self._mul_scalar(other.decode())
        if type(other).__name__ == "PaillierEncryptedNumber":
            return other * self.decode()
        return self._mul_scalar(other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def _mul_scalar(self, scalar):
        return FixedPointNumber.encode(self.decode() * scalar, n=self.n,
                                       max_int=self.max_int)

    def __truediv__(self, other):
        scalar = other.decode() if isinstance(other, FixedPointNumber) else other
        return self.__mul__(1 / scalar)

    def __rtruediv__(self, other):
        res = 1.0 / self.__truediv__(other).decode()
        return FixedPointNumber.encode(res, n=self.n, max_int=self.max_int)

    def _cmp_value(self, other):
        y = other.decode() if isinstance(other, FixedPointNumber) else other
        return self.decode(), y

    def __lt__(self, other):
        x, y = self._cmp_value(other)
        return x < y

    def __gt__(self, other):
        x, y = self._cmp_value(other)
        return x > y

    def __le__(self, other):
        x, y = self._cmp_value(other)
        return x <= y

    def __ge__(self, other):
        x, y = self._cmp_value(other)
        return x >= y

    def __eq__(self, other):
        x, y = self._cmp_value(other)
        return x == y

    def __ne__(self, other):
        x, y = self._cmp_value(other)
        return x != y

    def __abs__(self):
        if self.encoding <= self.max_int:
            return self
        elif self.encoding >= self.n - self.max_int:
            return self * -1

    def __mod__(self, other):
        return FixedPointNumber(self.encoding % other, self.exponent,
                                n=self.n, max_int=self.max_int)


# ---------------------------------------------------------------------------
# Vectorized encode/decode — the batched fast path for the API layer.
# ---------------------------------------------------------------------------

def encode_vector(values, n: int, max_int: int):
    """Encode a 1-D batch.  Returns (encodings, exponents).

    encodings: list of Python ints (arbitrary precision, already mod n);
    exponents: np.int64 array.  Bit-exact with FixedPointNumber.encode
    applied per element.
    """
    with annotate("pct.fixedpoint.encode"):
        return _encode_vector(values, n, max_int)


def _encode_vector(values, n: int, max_int: int):
    if not isinstance(values, np.ndarray):
        # Python sequences keep per-element types (a list may mix ints and
        # floats, and int vs float changes the exponent rule) — use the
        # exact scalar path, as the reference does.
        encs, exps = [], []
        for v in values:
            e = FixedPointNumber.encode(v, n, max_int)
            encs.append(e.encoding)
            exps.append(e.exponent)
        return encs, np.asarray(exps, dtype=np.int64)

    arr = values
    if arr.dtype == object or arr.dtype.kind not in "fiu":
        encs, exps = [], []
        for v in arr.tolist():
            e = FixedPointNumber.encode(v, n, max_int)
            encs.append(e.encoding)
            exps.append(e.exponent)
        return encs, np.asarray(exps, dtype=np.int64)

    flat = arr.reshape(-1)
    if arr.dtype.kind in "iu":
        mantissas = flat.tolist()   # C-speed scalar conversion
        exps = np.zeros(flat.shape[0], dtype=np.int64)
        if max_int >= (1 << 64):
            # machine ints can never exceed max_int (n >= 128 bits):
            # skip the per-element bound check, fold the sign
            return [m if m >= 0 else m + n for m in mantissas], exps
    else:
        f = flat.astype(np.float64)
        tiny = np.abs(f) < 1e-200
        _, fexp = np.frexp(f)
        exps = (FixedPointNumber.FLOAT_MANTISSA_BITS
                - fexp.astype(np.int64))
        # LOG2_BASE == 1 for BASE 2; floor() is exact on integers.
        exps = np.where(tiny, 0, exps)
        # round(x * 2^e): exact via ldexp (result magnitude <= 2^53) with
        # numpy's round-half-even == Python round on floats.
        scaled = np.ldexp(f, exps.astype(np.int64))
        mant = np.rint(scaled)
        mant = np.where(tiny, 0.0, mant)
        mantissas = [int(v) for v in mant]

    out = []
    for m in mantissas:
        if abs(m) > max_int:
            raise ValueError(
                f"Integer needs to be within +/- {max_int},but got {m}")
        out.append(m % n)
    return out, exps


def decode_vector(encodings, exponents, n: int, max_int: int):
    """Decode a batch of (encoding, exponent) pairs -> list of numbers."""
    out = []
    for enc, expo in zip(encodings, exponents):
        out.append(FixedPointNumber(int(enc), int(expo), n, max_int).decode())
    return out


def decode_limbs_vector(limbs, count: int, exponents, n: int, max_int: int):
    """Decode straight off a (L, B) canonical uint32 limb array (the
    decrypt host tail): the C extension classifies sign, extracts
    |mantissa| and converts per element in one pass — bit-identical to
    decode_vector over unpacked ints, which remains the fallback."""
    from . import native

    with annotate("pct.fixedpoint.decode"):
        out = native.decode_limbs16(limbs, count, exponents, n, max_int)
        if out is not None:
            return out
        ints = native.unpack_limbs16(limbs)[:count]
        return decode_vector(ints, exponents[:count], n, max_int)


class FixedPointEndec:
    """Tensor-level encode/decode/truncate (reference fixedpoint.py:304-367).

    The reference hard-imports FATE's `is_table` (dead outside FATE); here
    the FATE table hook degrades gracefully when fate_arch is absent.
    """

    def __init__(self, n=None, max_int=None, precision=None, *args, **kwargs):
        if n is None:
            self.n = FixedPointNumber.Q
            self.max_int = self.n // 2
        else:
            self.n = n
            self.max_int = max_int if max_int is not None else n // 2
        self.precision = precision

    @classmethod
    def _transform_op(cls, tensor, op):
        def _transform(x):
            arr = np.zeros(shape=x.shape, dtype=object)
            view = arr.view().reshape(-1)
            x_array = x.view().reshape(-1)
            for i in range(arr.size):
                view[i] = op(x_array[i])
            return arr

        if isinstance(tensor, (int, np.int16, np.int32, np.int64,
                               float, np.float16, np.float32, np.float64,
                               FixedPointNumber)):
            return op(tensor)
        if isinstance(tensor, np.ndarray):
            return _transform(tensor)
        try:
            from fate_arch.session import is_table  # optional FATE hook
        except ImportError:
            is_table = None
        if is_table is not None and is_table(tensor):
            import functools
            return tensor.mapValues(functools.partial(_transform))
        raise ValueError(f"unsupported type: {type(tensor)}")

    def _encode(self, scalar):
        return FixedPointNumber.encode(scalar, n=self.n, max_int=self.max_int,
                                       precision=self.precision)

    def _decode(self, number):
        return number.decode()

    def _truncate(self, number):
        scalar = number.decode()
        return FixedPointNumber.encode(scalar, n=self.n, max_int=self.max_int)

    def encode(self, float_tensor):
        return self._transform_op(float_tensor, op=self._encode)

    def decode(self, integer_tensor):
        return self._transform_op(integer_tensor, op=self._decode)

    def truncate(self, integer_tensor, *args, **kwargs):
        return self._transform_op(integer_tensor, op=self._truncate)
