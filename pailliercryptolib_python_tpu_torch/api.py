"""Public HE API: PaillierKeypair / PublicKey / PrivateKey /
EncryptedNumber, on the port's contexts.

Counterpart of ``pailliercryptolib_python_tpu/api.py`` for the main path:
encrypt / raw_encrypt, decrypt / raw_decrypt, ciphertext ``+`` (with
exponent alignment through ct*pt by powers of two), ``sum``, indexing,
ct*pt by non-negative plaintexts, and pickling with the same state
tuples.  Operators outside this slice -- ``*`` by a negative plaintext,
``dot``, ``@``, ``mean`` and ``apply_obfuscator`` -- raise
NotImplementedError; ROADMAP.md lists them as still to be ported.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from .fixedpoint import FixedPointNumber, encode_vector, decode_limbs_vector
from .bindings.containers import (
    BigNumber, ipclBigNumber, ipclKeypair, ipclPublicKey, ipclPrivateKey,
    ipclCipherText)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not in the port yet (see ROADMAP.md, queue of kernels "
        f"and modules still to be ported)")


class BNUtils:
    """Python int <-> BigNumber converters."""

    @staticmethod
    def int2Bytes(val: int) -> bytes:
        return val.to_bytes((val.bit_length() + 7) // 8, byteorder="little")

    @staticmethod
    def bytes2Int(val: bytes) -> int:
        return int.from_bytes(val, "little")

    @staticmethod
    def int2BN(val: int) -> BigNumber:
        if val == 0:
            return ipclBigNumber.Zero
        if val == 1:
            return ipclBigNumber.One
        if val == 2:
            return ipclBigNumber.Two
        return BigNumber(BNUtils.int2Bytes(val))

    @staticmethod
    def BN2int(val: BigNumber) -> int:
        return BNUtils.bytes2Int(val.to_bytes())


class PaillierKeypair:
    @staticmethod
    def generate_keypair(n_length: int = 1024, enable_DJN: bool = True,
                         device=None
                         ) -> Tuple["PaillierPublicKey", "PaillierPrivateKey"]:
        pub, pri = ipclKeypair.generate_keypair(n_length, enable_DJN, device)
        return PaillierPublicKey(pub), PaillierPrivateKey(pri)


class PaillierPublicKey:
    def __init__(self, key, n_length: Optional[int] = None,
                 enable_DJN: Optional[bool] = None, device=None):
        if isinstance(key, ipclPublicKey):
            self.n = key.context.n
            self.pubkey = key
        elif isinstance(key, PaillierPublicKey):
            self.n = key.n
            self.pubkey = key.pubkey
        elif isinstance(key, int) and n_length is not None \
                and enable_DJN is not None:
            self.n = key
            self.pubkey = ipclPublicKey(key, n_length, enable_DJN,
                                        device=device)
        else:
            raise ValueError(
                "PaillierPublicKey: PubKey should be either key value (n),"
                "PaillierPublicKey or IPP-PaillierPublicKey object")
        self.max_int = self.n // 3 - 1
        self.nsquare = self.n * self.n

    def __getstate__(self):
        return self.pubkey

    def __setstate__(self, state):
        self.pubkey = state
        self.n = self.pubkey.context.n
        self.max_int = self.n // 3 - 1
        self.nsquare = self.n * self.n

    def __repr__(self):
        return repr(self.pubkey)

    def __eq__(self, other):
        return self.n == other.n

    def __hash__(self):
        return hash(self.pubkey)

    def apply_obfuscator(self, x):
        raise _not_ported("apply_obfuscator")

    def raw_encrypt(self, plaintext) -> "PaillierEncryptedNumber":
        return self.encrypt(plaintext, apply_obfuscator=False)

    def encrypt(self, values, apply_obfuscator: bool = True
                ) -> "PaillierEncryptedNumber":
        """Vectorized encrypt of a scalar or 1-D batch."""
        if np.isscalar(values):
            values = [values]
        arr = np.asarray(values)
        if arr.dtype.kind not in "fiu":
            if not all(isinstance(v, (int, float, np.integer, np.floating))
                       for v in values):
                raise ValueError(
                    "PaillierPublicKey.encrypt: input value(s) should be "
                    "integer or float")
        encodings, expos = encode_vector(values, self.n, self.max_int)
        ct_dev = self.pubkey.context.encrypt(encodings, apply_obfuscator)
        ct = ipclCipherText(self.pubkey, _dev=ct_dev, _length=len(encodings))
        return PaillierEncryptedNumber(self, ct, exponents=expos,
                                       length=len(encodings))


class PaillierPrivateKey:
    def __init__(self, key, p: Optional[int] = None, q: Optional[int] = None):
        if isinstance(key, ipclPrivateKey):
            self.prikey = key
            self.__n = key.context.pub.n
        elif isinstance(key, ipclPublicKey) and p is not None \
                and q is not None:
            self.prikey = ipclPrivateKey(key, BNUtils.int2BN(p),
                                         BNUtils.int2BN(q))
            self.__n = key.context.n
        elif isinstance(key, PaillierPublicKey) and p is not None \
                and q is not None:
            self.prikey = ipclPrivateKey(key.pubkey, BNUtils.int2BN(p),
                                         BNUtils.int2BN(q))
            self.__n = key.n
        else:
            raise KeyError(
                "PaillierPrivateKey: key should be either Private key or"
                " Public key (with p and q)")
        self.__max_int = self.__n // 3 - 1

    def __getstate__(self):
        return (self.prikey, self.__n, self.__max_int)

    def __setstate__(self, state):
        (self.prikey, self.__n, self.__max_int) = state

    def __eq__(self, other: "PaillierPrivateKey"):
        return (self.prikey.p == other.prikey.p) and (
            self.prikey.q == other.prikey.q)

    def __hash__(self):
        return hash(self.prikey)

    def __repr__(self):
        return repr(self.prikey)

    def raw_decrypt(self, ciphertext: "PaillierEncryptedNumber"):
        if ciphertext.public_key.n != self.__n:
            raise ValueError(
                "PaillierPrivateKey.raw_decrypt: Public key mismatch")
        ct = ciphertext.ciphertext()
        ret = self.prikey.context.decrypt_to_ints(ct.device_array(), len(ct))
        return ret if len(ciphertext) > 1 else ret[0]

    def decrypt(self, encrypted_number: "PaillierEncryptedNumber"):
        """Batched decrypt + fixed-point decode off the plaintext limbs."""
        if encrypted_number.public_key.n != self.__n:
            raise ValueError("PailierPrivateKey.decrypt: Public key mismatch")
        ct = encrypted_number.ciphertext()
        m_dev = self.prikey.context.decrypt_device(ct.device_array())
        ret = decode_limbs_vector(m_dev.cpu().numpy(), len(ct),
                                  encrypted_number._expos_np(),
                                  self.__n, self.__max_int)
        return ret if len(encrypted_number) > 1 else ret[0]


class PaillierEncryptedNumber:
    """Vectorized ciphertext with per-element fixed-point exponents."""

    __array_priority__ = 1000

    def __init__(self, public_key: PaillierPublicKey,
                 ciphertext: ipclCipherText, exponents, length: int):
        if ciphertext.public_key != public_key.pubkey:
            raise ValueError("PaillierEncryptedNumber: public key mismatch")
        self.__expos = np.asarray(exponents, dtype=np.int64).reshape(-1)
        self.public_key = public_key
        self.__ct = ciphertext
        self.__length = length

    def __repr__(self):
        return repr(self.__ct)

    def __getstate__(self) -> tuple:
        return (self.public_key, len(self), self.exponent(),
                self.__ct.host_ints())

    def __setstate__(self, state: tuple):
        (self.public_key, self.__length, expos, ints) = state
        self.__expos = np.asarray(expos, dtype=np.int64).reshape(-1)
        self.__ct = ipclCipherText(self.public_key.pubkey, _ints=ints)

    def __len__(self) -> int:
        return self.__length

    def length(self) -> int:
        return self.__length

    def ciphertext(self) -> ipclCipherText:
        return self.__ct

    def ciphertextBN(self, idx: Optional[int] = None):
        if idx is None:
            return self.__ct.getTexts()
        if not 0 <= idx < self.__length:
            raise IndexError("ciphertext: idx out of range")
        return self.__ct[idx]

    def exponent(self, idx: Optional[int] = None):
        if idx is None:
            return [int(e) for e in self.__expos]
        if not 0 <= idx < self.__length:
            raise IndexError("exponent: idx out of range")
        return int(self.__expos[idx])

    def _expos_np(self) -> np.ndarray:
        return self.__expos

    def apply_obfuscator(self):
        raise _not_ported("apply_obfuscator")

    def __getitem__(self, key: Union[int, slice]) -> "PaillierEncryptedNumber":
        if isinstance(key, int):
            key = slice(key, key + 1)
        if not 0 <= key.stop <= len(self) or not 0 <= key.start < len(self):
            raise IndexError("__getitem__: key out of range")
        newCT = self.__ct[key]
        return PaillierEncryptedNumber(self.public_key, newCT,
                                       self.__expos[key], len(newCT))

    def _ctx(self):
        return self.public_key.pubkey.context

    def _scale_by_pow2(self, ct_dev, diffs: np.ndarray):
        """ct * BASE^diff per element: one batched ct*pt (kernel K4)."""
        if not np.any(diffs > 0):
            return ct_dev
        exps = [1 << int(d) if d > 0 else 1 for d in diffs]
        return self._ctx().mul_pt(ct_dev, exps)

    # -- addition --------------------------------------------------------------

    def __add__(self, other):
        if self.__length == 1 and isinstance(other, PaillierEncryptedNumber) \
                and len(other) > 1:
            return other.__raw_add(self)
        return self.__raw_add(other)

    def __radd__(self, other):
        return self + other

    def __raw_add(self, other) -> "PaillierEncryptedNumber":
        if isinstance(other, (np.ndarray, list)):
            if self.__length != len(other):
                raise ValueError(
                    "PaillierEncryptedNumber.__raw_add: array(list) size"
                    " mismatch with PaillierEncryptedNumber")
            other = self.public_key.encrypt(other, apply_obfuscator=False)
        elif np.isscalar(other) and isinstance(other, (int, float)):
            other = self.public_key.encrypt(other, apply_obfuscator=False)
        elif isinstance(other, PaillierEncryptedNumber):
            if self.public_key != other.public_key:
                raise ValueError(
                    "PaillierEncryptedNumber.__raw_add: PublicKey mismatch")
            if self.__length != len(other) and len(other) > 1:
                raise ValueError(
                    "PaillierEncryptedNumber.__raw_add: CipherText size"
                    " mismatch with PaillierEncryptedNumber")
        ctx = self._ctx()
        b = self.__length
        x_dev = self.__ct.device_array()
        y_dev = other.ciphertext().device_array()
        ex = self.__expos
        ey = other._expos_np()
        if len(other) == 1 and b > 1:
            y_dev = ctx.gather_batch(y_dev, np.zeros(b, dtype=np.int64))
            ey = np.broadcast_to(ey, (b,))
        target = np.maximum(ex, ey)
        x_dev = self._scale_by_pow2(x_dev, target - ex)
        y_dev = self._scale_by_pow2(y_dev, target - ey)
        res = ctx.add_ct(x_dev, y_dev)
        ct = ipclCipherText(self.public_key.pubkey, _dev=res, _length=b)
        return PaillierEncryptedNumber(self.public_key, ct, target, b)

    # -- multiplication --------------------------------------------------------

    def __rmul__(self, other):
        return self * other

    def __mul__(self, other) -> "PaillierEncryptedNumber":
        """ct * non-negative plaintext (scalar or vector) by the limb
        route; a negative plaintext needs the batched inversion, which is
        not ported yet."""
        b = self.__length
        n = self.public_key.n
        if np.isscalar(other):
            enc = FixedPointNumber.encode(other, n, self.public_key.max_int)
            pts = [enc.encoding] * b
            pt_expos = np.full(b, enc.exponent, dtype=np.int64)
        else:
            if len(other) != b:
                raise ValueError(
                    "PaillierEncryptedNumber.__mul__: Multiply size mismatch")
            pts, pt_expos = encode_vector(other, n, self.public_key.max_int)
        for pt in pts:
            if not 0 <= pt < n:
                raise ValueError(f"Scalar out of bounds: {pt}")
            if pt >= n - self.public_key.max_int:
                raise _not_ported("ct * negative plaintext")
        dev = self._ctx().mul_pt(self.__ct.device_array(), pts)
        ct = ipclCipherText(self.public_key.pubkey, _dev=dev, _length=b)
        return PaillierEncryptedNumber(self.public_key, ct,
                                       self.__expos + pt_expos, b)

    # -- reductions -------------------------------------------------------------

    def sum(self) -> "PaillierEncryptedNumber":
        ctx = self._ctx()
        max_expo = int(self.__expos.max())
        dev = self._scale_by_pow2(self.__ct.device_array(),
                                  max_expo - self.__expos)
        red = ctx.tree_reduce(dev, self.__length)
        ct = ipclCipherText(self.public_key.pubkey, _dev=red, _length=1)
        return PaillierEncryptedNumber(self.public_key, ct,
                                       exponents=[max_expo], length=1)

    def mean(self):
        raise _not_ported("mean")

    def dot(self, other):
        raise _not_ported("dot")

    def __matmul__(self, other):
        raise _not_ported("@")

    def __rmatmul__(self, other):
        raise _not_ported("@")

    def __imatmul__(self, other):
        raise _not_ported("@=")
