"""Public HE API: PaillierKeypair / PublicKey / PrivateKey /
EncryptedNumber, on the port's contexts.

Counterpart of ``pailliercryptolib_python_tpu/api.py``: encrypt /
raw_encrypt, decrypt / raw_decrypt, re-randomization, ciphertext ``+``
and ``-`` (with exponent alignment through ct*pt by powers of two),
ct*pt by any plaintext (a negative one through the batched inversion),
``/``, ``sum``, ``mean``, ``dot``, ``@`` / ``@=`` against plaintext
matrices, indexing and iteration, and pickling with the same state
tuples.  ``encrypt`` pipelines a large batch in chunks
(``encrypt_pipeline_chunks``) or splits it between a host thread and the
device (``encrypt_host_ratio``, after ``context.initializeContext``);
``utils/context.py`` maps the hybrid modes onto both knobs.
"""

from __future__ import annotations

import io
import pickle
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .fixedpoint import FixedPointNumber, encode_vector, decode_limbs_vector
from .bindings.containers import (
    BigNumber, ipclBigNumber, ipclKeypair, ipclPublicKey, ipclPrivateKey,
    ipclCipherText)
from .models.paillier import pad_batch
from .utils import config as _config
from .utils.context import context as _context
from .utils.profiling import annotate


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


_HOST_ENC_POOL = None


def _host_pool():
    """The one worker thread of the hybrid split's host leg."""
    global _HOST_ENC_POOL
    if _HOST_ENC_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _HOST_ENC_POOL = ThreadPoolExecutor(max_workers=1)
    return _HOST_ENC_POOL


def _hybrid_split_encrypt(pctx, encodings, apply_obfuscator):
    """Concurrent host/device encrypt split, or None when inactive.

    The last ``encrypt_host_ratio`` of the batch encrypts with Python
    bigints in a worker thread (``PublicContext.host_encrypt``) while the
    device encrypts the rest: the device call only enqueues its work, so
    both legs run at once.  Active only after
    ``context.initializeContext``, and for a batch of two or more."""
    ratio = _config.get_config().encrypt_host_ratio
    B = len(encodings)
    if ratio <= 0 or not _context._initialized or B < 2:
        return None
    nh = B if ratio >= 1 else min(B, max(1, int(B * ratio)))
    fut = _host_pool().submit(pctx.host_encrypt, encodings[B - nh:],
                              apply_obfuscator)
    dev = pctx.encrypt(encodings[:B - nh], apply_obfuscator) \
        if nh < B else None
    host_dev = pctx.import_cts(fut.result())
    if dev is None:
        cols = host_dev[:, :nh]
    else:
        cols = torch.cat([dev[:, :B - nh], host_dev[:, :nh]], dim=1)
    return pctx.pad_columns(cols, B)


def _signed_exponents(pts: list, n: int, max_int: int, out_of_bounds: str):
    """The ct*pt rewrite of signed encodings: (flags, exponents), an
    encoding >= n - max_int standing for a negative value, whose column
    is raised to the small n - pt and then inverted (flags); exponents an
    object array of ints.  An encoding outside [0, n) raises ValueError
    with `out_of_bounds` before it."""
    for pt in pts:
        if not 0 <= pt < n:
            raise ValueError(f"{out_of_bounds}{pt}")
    cond = n - max_int
    flags = np.array([pt >= cond for pt in pts], dtype=bool)
    exps = np.empty(len(pts), dtype=object)
    exps[:] = [int(n - pt) if f else int(pt) for pt, f in zip(pts, flags)]
    return flags, exps


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
        if isinstance(x, int):
            return self.pubkey.apply_obfuscator(BNUtils.int2BN(x))
        return self.pubkey.apply_obfuscator(x)

    def raw_encrypt(self, plaintext) -> "PaillierEncryptedNumber":
        return self.encrypt(plaintext, apply_obfuscator=False)

    def encrypt(self, values, apply_obfuscator: bool = True
                ) -> "PaillierEncryptedNumber":
        """Vectorized encrypt of a scalar or 1-D batch.

        With ``encrypt_pipeline_chunks`` > 1 (and no host share set) a
        batch of at least 256 per chunk runs chunked: each chunk's host
        stage (fixed-point encode, limb pack, entropy) overlaps the
        device work enqueued for the chunk before."""
        with annotate("pct.api.encrypt"):
            if np.isscalar(values):
                values = [values]
            arr = np.asarray(values)
            if arr.dtype.kind not in "fiu":
                if not all(isinstance(v, (int, float, np.integer, np.floating))
                           for v in values):
                    raise ValueError(
                        "PaillierPublicKey.encrypt: input value(s) should be "
                        "integer or float")
            B = len(values)
            cfg = _config.get_config()
            chunks = cfg.encrypt_pipeline_chunks
            split_active = cfg.encrypt_host_ratio > 0
            if chunks > 1 and not split_active and B >= 256 * chunks:
                csize = pad_batch(-(-B // chunks))
                sliceable = arr if arr.dtype.kind in "fiu" else values
                devs, expos_parts = [], []
                for i in range(0, B, csize):
                    encs, exps = encode_vector(sliceable[i:i + csize],
                                               self.n, self.max_int)
                    devs.append(self.pubkey.context.encrypt(
                        encs, apply_obfuscator, pad_to=csize))
                    expos_parts.append(exps)
                ct_dev = torch.cat(devs, dim=1)[:, :pad_batch(B)]
                ct = ipclCipherText(self.pubkey, _dev=ct_dev, _length=B)
                return PaillierEncryptedNumber(
                    self, ct, exponents=np.concatenate(expos_parts), length=B)

            encodings, expos = encode_vector(values, self.n, self.max_int)
            ct_dev = _hybrid_split_encrypt(self.pubkey.context, encodings,
                                           apply_obfuscator)
            if ct_dev is None:
                ct_dev = self.pubkey.context.encrypt(encodings,
                                                     apply_obfuscator)
            ct = ipclCipherText(self.pubkey, _dev=ct_dev,
                                _length=len(encodings))
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
        with annotate("pct.api.decrypt"):
            ret = self.prikey.context.decrypt_to_ints(ct.device_array(),
                                                      len(ct))
        return ret if len(ciphertext) > 1 else ret[0]

    def decrypt(self, encrypted_number: "PaillierEncryptedNumber"):
        """Batched decrypt + fixed-point decode off the plaintext limbs."""
        if encrypted_number.public_key.n != self.__n:
            raise ValueError("PailierPrivateKey.decrypt: Public key mismatch")
        ct = encrypted_number.ciphertext()
        with annotate("pct.api.decrypt"):
            m_dev = self.prikey.context.decrypt_device(ct.device_array())
            with annotate("pct.api.readback"):
                m_host = m_dev.cpu().numpy()
            ret = decode_limbs_vector(m_host, len(ct),
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
        dev = self._ctx().obfuscate(self.__ct.device_array())
        self.__ct = ipclCipherText(self.public_key.pubkey, _dev=dev,
                                   _length=self.__length)

    def __getitem__(self, key: Union[int, slice]) -> "PaillierEncryptedNumber":
        if isinstance(key, int):
            key = slice(key, key + 1)
        key = slice(0 if key.start is None else key.start,
                    len(self) if key.stop is None else key.stop, key.step)
        if not 0 <= key.stop <= len(self) or not 0 <= key.start < len(self):
            raise IndexError("__getitem__: key out of range")
        newCT = self.__ct[key]
        return PaillierEncryptedNumber(self.public_key, newCT,
                                       self.__expos[key], len(newCT))

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def _ctx(self):
        return self.public_key.pubkey.context

    def _scale_by_pow2(self, ct_dev, diffs: np.ndarray):
        """ct * BASE^diff per element, BASE 2: ct^(2^diff), diff
        squarings of each shifted column (``PublicContext.scale_pow2``)."""
        if not np.any(diffs > 0):
            return ct_dev
        with annotate("pct.api.align"):
            return self._ctx().scale_pow2(ct_dev, diffs)

    def increase_exponent_to(self, x_ct: ipclCipherText, x_expo,
                             exponent: int) -> ipclCipherText:
        """Raise the elements below `exponent` to it (each ciphertext to
        BASE^(exponent - x_expo[i])); the others are left unchanged."""
        expo_diff = exponent - np.fromiter(x_expo, np.int64)
        if not np.any(expo_diff > 0):
            return x_ct
        dev = self._scale_by_pow2(x_ct.device_array(),
                                  np.maximum(expo_diff, 0))
        return ipclCipherText(self.public_key.pubkey, _dev=dev,
                              _length=len(x_ct))

    # -- addition --------------------------------------------------------------

    def __add__(self, other):
        if self.__length == 1 and isinstance(other, PaillierEncryptedNumber) \
                and len(other) > 1:
            return other.__raw_add(self)
        return self.__raw_add(other)

    def __radd__(self, other):
        return self + other

    def __sub__(self, other):
        if isinstance(other, list):
            other = np.array(other)
        return self.__raw_add(other * -1.0)

    def __rsub__(self, other):
        if isinstance(other, PaillierEncryptedNumber):
            return other - self
        return (self * (-1.0)).__raw_add(other)

    def __raw_add(self, other) -> "PaillierEncryptedNumber":
        with annotate("pct.api.add"):
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
                    raise ValueError("PaillierEncryptedNumber.__raw_add: "
                                     "PublicKey mismatch")
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

    # -- multiplication / division ---------------------------------------------

    def __rmul__(self, other):
        return self * other

    def __truediv__(self, other):
        if isinstance(other, list):
            other = np.array(other)
        return self * (1.0 / other)

    def __mul__(self, other) -> "PaillierEncryptedNumber":
        """ct * plaintext (scalar or vector).  A negative plaintext
        (encoding >= n - max_int) is rewritten: the column is raised to
        the small n - pt and then inverted."""
        with annotate("pct.api.mul"):
            b = self.__length
            n = self.public_key.n
            max_int = self.public_key.max_int
            if np.isscalar(other):
                enc = FixedPointNumber.encode(other, n, max_int)
                pts = [enc.encoding] * b
                pt_expos = np.full(b, enc.exponent, dtype=np.int64)
                bad = ("PaillierEncryptedNumber.__mul__: Scalar out of"
                       "bounds: ")
            else:
                if len(other) != b:
                    raise ValueError("PaillierEncryptedNumber.__mul__: "
                                     "Multiply size mismatch")
                pts, pt_expos = encode_vector(other, n, max_int)
                bad = "Scalar out of bounds: "
            with annotate("pct.api.flags"):
                flags, exps = _signed_exponents(pts, n, max_int, bad)
            dev = self._ctx().mul_pt(self.__ct.device_array(), exps)
            if flags.any():
                with annotate("pct.api.invert"):
                    dev = self._ctx().invert_columns(dev, flags)
            ct = ipclCipherText(self.public_key.pubkey, _dev=dev, _length=b)
            return PaillierEncryptedNumber(self.public_key, ct,
                                           self.__expos + pt_expos, b)

    # -- reductions -------------------------------------------------------------

    def sum(self) -> "PaillierEncryptedNumber":
        with annotate("pct.api.sum"):
            ctx = self._ctx()
            max_expo = int(self.__expos.max())
            dev = self._scale_by_pow2(self.__ct.device_array(),
                                      max_expo - self.__expos)
            red = ctx.tree_reduce(dev, self.__length)
            ct = ipclCipherText(self.public_key.pubkey, _dev=red, _length=1)
            return PaillierEncryptedNumber(self.public_key, ct,
                                           exponents=[max_expo], length=1)

    def mean(self) -> "PaillierEncryptedNumber":
        return self.sum() / len(self)

    def dot(self, other) -> "PaillierEncryptedNumber":
        if len(other) != len(self):
            raise ValueError(
                "PaillierEncryptedNumber.dot: input size mismatch with"
                " ciphertext")
        return (self * other).sum()

    # -- matmul -------------------------------------------------------------------

    def _matmul_impl(self, other: np.ndarray, m: int, n: int, k: int,
                     rhs: bool = False) -> "PaillierEncryptedNumber":
        """Product with a plaintext matrix: the (m*n*k)-wide column layout
        of the reference's index maps, as batched gathers, one ct*pt, the
        inversion of negative columns, per-group alignment and a segmented
        tree reduce; processed in chunks of whole reduction groups of at
        most matmul_chunk_columns columns (one group if it is wider)."""
        with annotate("pct.api.matmul"):
            ctx = self._ctx()
            G = m * k
            nn = self.public_key.n
            dev_self = self.__ct.device_array()
            flat_pt = other.reshape(-1) if other.ndim == 2 else other
            max_int = self.public_key.max_int
            encs, pt_expos = encode_vector(flat_pt, nn, max_int)
            with annotate("pct.api.flags"):
                flags_flat, exps_flat = _signed_exponents(
                    encs, nn, max_int, "Scalar out of bounds: ")

            g_per = max(1, _config.get_config().matmul_chunk_columns // n)
            red_parts, tg_parts = [], []
            for g0 in range(0, G, g_per):
                gc = min(G, g0 + g_per) - g0
                i = np.arange(g0 * n, (g0 + gc) * n)
                if rhs:
                    idx_self = i % n * k + i // n % k
                    ox, oy = i // (n * k), i % n
                    pidx = ox * n + oy if other.ndim == 2 else oy
                else:
                    idx_self = i // (n * k) * n + i % n
                    ox, oy = i % n, i // n % k
                    pidx = ox * k + oy if other.ndim == 2 else ox
                with annotate("pct.api.flags"):
                    exps = list(exps_flat[pidx])
                temp = ctx.mul_pt(ctx.gather_batch(dev_self, idx_self), exps)
                flags = flags_flat[pidx]
                if flags.any():
                    with annotate("pct.api.invert"):
                        temp = ctx.invert_columns(temp, flags)
                temp_expo = self.__expos[idx_self] + pt_expos[pidx]
                # align each group of n to its largest exponent, then reduce
                tg = temp_expo.reshape(gc, n).max(axis=1)
                diffs = (tg[:, None] - temp_expo.reshape(gc, n)).reshape(-1)
                temp = self._scale_by_pow2(temp, diffs)
                red_parts.append(
                    ctx.segment_tree_reduce(temp, gc, n)[:, :gc])
                tg_parts.append(tg)

            red = ctx.pad_columns(torch.cat(red_parts, dim=1), G)
            ct = ipclCipherText(self.public_key.pubkey, _dev=red, _length=G)
            return PaillierEncryptedNumber(self.public_key, ct,
                                           np.concatenate(tg_parts), G)

    def __matmul__(self, other) -> "PaillierEncryptedNumber":
        if len(self) % len(other) != 0:
            raise ValueError(
                "PaillierEncryptedNumber.__matmul__: "
                "matrix multiply size mismatch")
        other = np.array(other)
        if other.ndim not in (1, 2):
            raise NotImplementedError(
                f"PaillierEncryptedNumber.__matmul__: input ndim {other.ndim}"
                f"not supported")
        n = other.shape[0]
        k = other.shape[1] if other.ndim == 2 else 1
        return self._matmul_impl(other, len(self) // n, n, k)

    def __rmatmul__(self, other) -> "PaillierEncryptedNumber":
        other = np.array(other)
        if other.ndim not in (1, 2):
            raise NotImplementedError(
                f"PaillierEncryptedNumber.__rmatmul__: input ndim "
                f"{other.ndim} not supported")
        m = other.shape[0] if other.ndim == 2 else 1
        n = other.shape[1] if other.ndim == 2 else other.shape[0]
        if len(self) % n != 0:
            raise ValueError(
                "PaillierEncryptedNumber.__rmatmul__: matrix multiply"
                "size mismatch")
        return self._matmul_impl(other, m, n, len(self) // n, rhs=True)

    def __imatmul__(self, other) -> "PaillierEncryptedNumber":
        return self @ other


# ---------------------------------------------------------------------------
# Pickles written by the JAX package.
# ---------------------------------------------------------------------------

# Both packages pickle the same state tuples under their own module
# names; the JAX package's names map onto the port's by string (nothing
# of the JAX package is imported).
_JAX_MODULES = {
    "pailliercryptolib_python_tpu.api": "pailliercryptolib_python_tpu_torch.api",
    "pailliercryptolib_python_tpu.bindings.containers":
        "pailliercryptolib_python_tpu_torch.bindings.containers",
}


class Unpickler(pickle.Unpickler):
    """A ``pickle.Unpickler`` that also reads the JAX package's pickles:
    its keys, key pairs and ciphertexts load as the port's classes (on
    the port's default device, ``device.set_device``)."""

    def find_class(self, module, name):
        return super().find_class(_JAX_MODULES.get(module, module), name)


def loads(data: bytes):
    """``pickle.loads`` that maps the JAX package's classes onto the
    port's (``Unpickler``)."""
    return Unpickler(io.BytesIO(data)).load()


def load(file):
    """``pickle.load`` from an open binary file, as ``loads``."""
    return Unpickler(file).load()
