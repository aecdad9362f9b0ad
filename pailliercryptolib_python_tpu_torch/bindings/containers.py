"""Container and key classes of the binding surface (BigNumber, ipcl*),
backed by Python ints on the host and Montgomery limb tensors on the
device.  Counterpart of ``pailliercryptolib_python_tpu/bindings/
containers.py``; the pickle state tuples are the same, so pickles cross
between the two packages:

  * BigNumber.to_bytes: little-endian, padded to 32-bit words
  * PublicKey state: (1, n_bytes, bits, hs_bytes, randbits) for DJN,
    (0, n_bytes, bits, 0, 0) plain
  * PrivateKey state: (n_bytes, p_bytes, q_bytes)
  * PlainText state: (length, [bytes]); CipherText adds the pubkey tuple

Objects rebuilt by unpickling live on the default device (``device.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import paillier as _scheme


def _bn_to_bytes(v: int) -> bytes:
    """Little-endian bytes padded to whole 32-bit words."""
    words = max(1, (int(v).bit_length() + 31) // 32)
    return int(v).to_bytes(words * 4, byteorder="little")


def _bytes_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


class BigNumber:
    """Arbitrary-precision unsigned integer (ipclBigNumber parity)."""

    __slots__ = ("_v",)

    def __init__(self, data=0):
        if isinstance(data, BigNumber):
            self._v = data._v
        elif isinstance(data, bytes):
            self._v = _bytes_to_int(data)
        elif isinstance(data, (int, np.integer)):
            if data < 0:
                raise ValueError("BigNumber: negative value")
            self._v = int(data)
        elif isinstance(data, np.ndarray):
            self._v = self._from_u32_seq(data.tolist())
        elif isinstance(data, (list, tuple)):
            self._v = self._from_u32_seq(data)
        else:
            raise TypeError(f"BigNumber: unsupported init type {type(data)}")

    @staticmethod
    def _from_u32_seq(seq) -> int:
        v = 0
        for i, w in enumerate(seq):
            v |= (int(w) & 0xFFFFFFFF) << (32 * i)
        return v

    def value(self) -> int:
        return self._v

    def DwordSize(self) -> int:
        return max(1, (self._v.bit_length() + 31) // 32)

    def BitSize(self) -> int:
        return max(1, self._v.bit_length())

    def data(self):
        n = self.DwordSize()
        return (n, [(self._v >> (32 * i)) & 0xFFFFFFFF for i in range(n)])

    def to_bytes(self) -> bytes:
        return _bn_to_bytes(self._v)

    def __getitem__(self, n: int) -> int:
        size = self.DwordSize()
        if n >= size:
            raise IndexError(f"Index is larger than size: {size}")
        return (self._v >> (32 * n)) & 0xFFFFFFFF

    def _other(self, other):
        return other._v if isinstance(other, BigNumber) else int(other)

    def __add__(self, other):
        return BigNumber(self._v + self._other(other))

    def __iadd__(self, other):
        self._v += self._other(other)
        return self

    def __sub__(self, other):
        return BigNumber(self._v - self._other(other))

    def __mul__(self, other):
        return BigNumber(self._v * self._other(other))

    def __eq__(self, other):
        return self._v == self._other(other)

    def __ne__(self, other):
        return self._v != self._other(other)

    def __lt__(self, other):
        return self._v < self._other(other)

    def __le__(self, other):
        return self._v <= self._other(other)

    def __gt__(self, other):
        return self._v > self._other(other)

    def __ge__(self, other):
        return self._v >= self._other(other)

    def __hash__(self):
        return hash(self._v)

    def __repr__(self):
        tag = str(abs(hash(("BigNumber", id(self)))))[:10]
        return f"<BigNumber {tag} val: {self._v}>"

    def __str__(self):
        return str(self._v)

    def __getstate__(self):
        return (self.to_bytes(),)

    def __setstate__(self, state):
        self._v = _bytes_to_int(state[0])


BigNumber.Zero = BigNumber(0)
BigNumber.One = BigNumber(1)
BigNumber.Two = BigNumber(2)
ipclBigNumber = BigNumber


def _as_int_list(data) -> list:
    """Any container constructor input -> list of ints."""
    if isinstance(data, BigNumber):
        return [data._v]
    if isinstance(data, (int, np.integer)):
        return [int(data) & 0xFFFFFFFF]
    if isinstance(data, np.ndarray):
        return [int(x) & 0xFFFFFFFF for x in data.tolist()]
    if isinstance(data, (list, tuple)):
        return [x._v if isinstance(x, BigNumber) else int(x) for x in data]
    raise TypeError(f"unsupported container init type {type(data)}")


class ipclPlainText:
    """Vector-of-bignum plaintext container (host ints)."""

    def __init__(self, data=None, _ints=None):
        if _ints is not None:
            self._ints = list(_ints)
        elif isinstance(data, ipclPlainText):
            self._ints = list(data._ints)
        else:
            self._ints = _as_int_list(data)

    def getSize(self) -> int:
        return len(self._ints)

    def __len__(self) -> int:
        return len(self._ints)

    def getTexts(self):
        return [BigNumber(v) for v in self._ints]

    def getInts(self):
        return list(self._ints)

    def getElementVec(self, n: int):
        v = self._ints[n]
        words = max(1, (v.bit_length() + 31) // 32)
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(words)]

    def getElementHex(self, n: int) -> str:
        return hex(self._ints[n])[2:].upper()

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self._ints))
            if step != 1:
                raise RuntimeError("Step size not supported")
            return ipclPlainText(_ints=self._ints[start:stop])
        return BigNumber(self._ints[key])

    def rotate(self, n: int) -> "ipclPlainText":
        k = n % len(self._ints)
        return ipclPlainText(_ints=self._ints[k:] + self._ints[:k])

    def __eq__(self, other):
        if self.getSize() != other.getSize():
            raise RuntimeError("Size mismatch")
        for a, b in zip(self._ints, other._ints):
            if a != b:
                raise RuntimeError("PlainText mismatch")
        return True

    def __repr__(self):
        tag = str(abs(hash(("ipclPlainText", id(self)))))[:10]
        return f"<ipclPlainText {tag}>"

    __str__ = __repr__

    def __getstate__(self):
        return (len(self._ints), [_bn_to_bytes(v) for v in self._ints])

    def __setstate__(self, state):
        length, l_bytes = state
        self._ints = [_bytes_to_int(b) for b in l_bytes[:length]]


class ipclPublicKey:
    """Public key: a host object owning the device PublicContext."""

    def __init__(self, n, bits: int = 1024, enable_DJN: bool = False,
                 hs: int | None = None, randbits: int | None = None,
                 _context: _scheme.PublicContext | None = None, device=None):
        if _context is not None:
            self._ctx = _context
            return
        n_int = n._v if isinstance(n, BigNumber) else int(n)
        if enable_DJN and hs is None:
            import secrets as _secrets
            x = _secrets.randbelow(n_int - 1) + 1
            h = (-(x * x)) % n_int
            hs = pow(h, n_int, n_int * n_int)
            randbits = randbits or bits // 2
        self._ctx = _scheme.PublicContext(n_int, bits, enable_DJN, hs,
                                          randbits, device=device)

    @property
    def context(self) -> _scheme.PublicContext:
        return self._ctx

    @property
    def n(self) -> BigNumber:
        return BigNumber(self._ctx.n)

    @property
    def length(self) -> int:
        return self._ctx.bits

    @property
    def nsquare(self) -> BigNumber:
        return BigNumber(self._ctx.nsquare)

    def __eq__(self, other):
        return self._ctx.n == other._ctx.n

    def __hash__(self):
        return hash(("ipclPublicKey", self._ctx.n))

    def __repr__(self):
        tag = str(abs(hash(self)))[:10]
        return f"<ipclPublicKey {tag}>"

    def encrypt(self, pt: ipclPlainText, make_secure: bool = True
                ) -> "ipclCipherText":
        ct_dev = self._ctx.encrypt(pt.getInts(), apply_obfuscator=make_secure)
        return ipclCipherText(self, _dev=ct_dev, _length=pt.getSize())

    def encrypt_tolist(self, pt: ipclPlainText, make_secure: bool = True):
        return self.encrypt(pt, make_secure).getTexts()

    def apply_obfuscator(self, ct):
        """Re-randomize: BigNumber -> BigNumber, CipherText -> [BigNumber]."""
        if isinstance(ct, ipclCipherText):
            new_dev = self._ctx.obfuscate(ct.device_array())
            return [BigNumber(v) for v in
                    self._ctx.export_cts(new_dev, len(ct))]
        v = ct._v if isinstance(ct, BigNumber) else int(ct)
        dev = self._ctx.import_cts([v])
        return BigNumber(self._ctx.export_cts(self._ctx.obfuscate(dev), 1)[0])

    def __getstate__(self):
        c = self._ctx
        if c.enable_DJN:
            return (1, _bn_to_bytes(c.n), c.bits, _bn_to_bytes(c.hs),
                    c.randbits)
        return (0, _bn_to_bytes(c.n), c.bits, 0, 0)

    def __setstate__(self, state):
        scheme, n_bytes, bits, hs_b, randbits = state
        n = _bytes_to_int(n_bytes)
        if scheme == 1:
            self._ctx = _scheme.PublicContext(
                n, bits, True, _bytes_to_int(hs_b), randbits)
        else:
            self._ctx = _scheme.PublicContext(n, bits, False)


class ipclPrivateKey:
    """Private key owning the device PrivateContext (CRT decrypt)."""

    def __init__(self, pubkey: ipclPublicKey | None = None, p=None, q=None):
        if pubkey is None:
            return  # unpickling path
        p_i = p._v if isinstance(p, BigNumber) else int(p)
        q_i = q._v if isinstance(q, BigNumber) else int(q)
        self._pub = pubkey
        self._ctx = _scheme.PrivateContext(pubkey.context, p_i, q_i)

    @property
    def context(self) -> _scheme.PrivateContext:
        return self._ctx

    @property
    def public_key(self) -> ipclPublicKey:
        return self._pub

    @property
    def n(self) -> BigNumber:
        return BigNumber(self._pub.context.n)

    @property
    def p(self) -> BigNumber:
        return BigNumber(self._ctx.p)

    @property
    def q(self) -> BigNumber:
        return BigNumber(self._ctx.q)

    def __eq__(self, other):
        return (self._ctx.p == other._ctx.p) and (self._ctx.q == other._ctx.q)

    def __hash__(self):
        return hash(("ipclPrivateKey", self._ctx.p, self._ctx.q))

    def __repr__(self):
        tag = str(abs(hash(self)))[:10]
        return f"<ipclPrivateKey {tag}>"

    def decrypt(self, ct: "ipclCipherText") -> ipclPlainText:
        ints = self._ctx.decrypt_to_ints(ct.device_array(), len(ct))
        return ipclPlainText(_ints=ints)

    def decrypt_tolist(self, ct: "ipclCipherText"):
        return self.decrypt(ct).getTexts()

    def __getstate__(self):
        return (_bn_to_bytes(self._pub.context.n),
                _bn_to_bytes(self._ctx.p), _bn_to_bytes(self._ctx.q))

    def __setstate__(self, state):
        n_b, p_b, q_b = state
        n = _bytes_to_int(n_b)
        self._pub = ipclPublicKey(n, n.bit_length(), False)
        self._ctx = _scheme.PrivateContext(
            self._pub.context, _bytes_to_int(p_b), _bytes_to_int(q_b))


class ipclCipherText:
    """Vectorized ciphertext container: an (L, B_pad) Montgomery limb
    tensor on the key's device; canonical host ints are made lazily at
    serialization or element access."""

    def __init__(self, pk: ipclPublicKey = None, data=None, _dev=None,
                 _length=None, _ints=None):
        self._pk = pk
        self._dev = _dev
        self._ints = list(_ints) if _ints is not None else None
        if _dev is None and _ints is None:
            if isinstance(data, ipclCipherText):
                self._dev = data._dev
                self._ints = data._ints
                self._length = len(data)
                return
            self._ints = _as_int_list(data)
            self._length = len(self._ints)
        else:
            self._length = int(_length if _length is not None
                               else len(self._ints))

    def device_array(self) -> torch.Tensor:
        """Montgomery (L, B_pad) tensor (imports lazily)."""
        if self._dev is None:
            self._dev = self._pk.context.import_cts(self._ints)
        return self._dev

    def host_ints(self) -> list:
        if self._ints is None:
            self._ints = self._pk.context.export_cts(self._dev, self._length)
        return self._ints

    @property
    def public_key(self) -> ipclPublicKey:
        return self._pk

    def getSize(self) -> int:
        return self._length

    def __len__(self) -> int:
        return self._length

    def getTexts(self):
        return [BigNumber(v) for v in self.host_ints()]

    def getCipherText(self):
        return self.getTexts()

    def getElementVec(self, n: int):
        v = self.host_ints()[n]
        words = max(1, (v.bit_length() + 31) // 32)
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(words)]

    def getElementHex(self, n: int) -> str:
        return hex(self.host_ints()[n])[2:].upper()

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._length)
            if step != 1:
                raise RuntimeError("Step size not supported")
            if self._dev is not None and self._ints is None:
                dev = self._pk.context.gather_batch(
                    self._dev, np.arange(start, stop))
                return ipclCipherText(self._pk, _dev=dev, _length=stop - start)
            return ipclCipherText(self._pk,
                                  _ints=self.host_ints()[start:stop])
        return BigNumber(self.host_ints()[key])

    def rotate(self, n: int) -> "ipclCipherText":
        """out[i] = in[(i+n) % len]."""
        b = self._length
        k = n % b
        if self._dev is not None:
            idx = np.concatenate([(np.arange(b) + k) % b,
                                  np.arange(b, self._dev.shape[1])])
            rot = torch.index_select(self._dev, 1,
                                     torch.from_numpy(idx).to(self._dev.device))
            return ipclCipherText(self._pk, _dev=rot, _length=b)
        ints = self.host_ints()
        return ipclCipherText(self._pk, _ints=ints[k:] + ints[:k])

    def __add__(self, other):
        ctx = self._pk.context
        if isinstance(other, ipclCipherText):
            if len(other) != self._length:
                raise RuntimeError("CipherText size mismatch")
            dev = ctx.add_ct(self.device_array(), other.device_array())
            return ipclCipherText(self._pk, _dev=dev, _length=self._length)
        if isinstance(other, ipclPlainText):
            if len(other) != self._length:
                raise RuntimeError("CipherText/PlainText size mismatch")
            enc = ctx.encrypt(other.getInts(), apply_obfuscator=False)
            dev = ctx.add_ct(self.device_array(), enc)
            return ipclCipherText(self._pk, _dev=dev, _length=self._length)
        return NotImplemented

    def __mul__(self, other):
        if not isinstance(other, ipclPlainText):
            return NotImplemented
        pts = other.getInts()
        if len(pts) == 1 and self._length > 1:
            pts = pts * self._length
        if len(pts) != self._length:
            raise RuntimeError("CipherText/PlainText size mismatch")
        dev = self._pk.context.mul_pt(self.device_array(), pts)
        return ipclCipherText(self._pk, _dev=dev, _length=self._length)

    def __repr__(self):
        tag = str(abs(hash(("ipclCipherText", id(self)))))[:10]
        return f"<ipclCipherText {tag}>"

    __str__ = __repr__

    def __getstate__(self):
        return (self._length,
                [_bn_to_bytes(v) for v in self.host_ints()],
                self._pk.__getstate__())

    def __setstate__(self, state):
        length, l_bytes, pk_state = state
        self._pk = ipclPublicKey.__new__(ipclPublicKey)
        self._pk.__setstate__(pk_state)
        self._ints = [_bytes_to_int(b) for b in l_bytes[:length]]
        self._length = length
        self._dev = None


class ipclKeypair:
    """Static keygen entry."""

    @staticmethod
    def generate_keypair(n_length: int = 1024, enable_DJN: bool = True,
                         device=None):
        kd = _scheme.generate_key_ints(n_length, enable_DJN)
        pub_ctx = _scheme.PublicContext(kd["n"], kd["bits"], enable_DJN,
                                        kd.get("hs"), kd.get("randbits"),
                                        device=device)
        pub = ipclPublicKey(None, _context=pub_ctx)
        priv = ipclPrivateKey(pub, kd["p"], kd["q"])
        return pub, priv
