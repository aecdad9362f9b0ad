"""The systems a cell can drive: the port, or the control in its place.

``PortSystem`` is the system under test: ``pailliercryptolib_python_tpu_torch``
through its public API (``PaillierPublicKey.encrypt``,
``PaillierPrivateKey.decrypt``, and the operators of
``PaillierEncryptedNumber`` that the request kinds call) on its default
engines.  From the program the benchmark takes only these calls, the
exported ciphertexts and exponents of their answers, and the launch
counters of ``kernels.COUNTS``.

``ControlSystem`` puts the plain reference in the program's place,
computed one precision below the configuration's: the floats it is
handed are rounded to float32 (24-bit mantissas) before they are
encoded; each request kind computes its own answer on them
(``Kind.control``).  Its answers are ciphertexts too, made by
encrypting the reference's plaintexts under one fixed obfuscator, so
the same judge reads them.  A correct judge must find it wrong.
"""

from __future__ import annotations

import types

import numpy as np

from . import reference as ref


def lower(x: np.ndarray) -> np.ndarray:
    """float64 values rounded to float32, the control's precision."""
    return np.asarray(x, dtype=np.float64).astype(np.float32).astype(
        np.float64)


class PortSystem:
    control = False

    def __init__(self, key: dict, device: str):
        import torch
        import pailliercryptolib_python_tpu_torch as pt
        from pailliercryptolib_python_tpu_torch import kernels
        self._torch = torch
        self._kernels = kernels
        self.device = torch.device(device)
        if self.device.type == "cuda":
            kernels.lib()            # build (first run in a checkout) and load
        ipub = pt.ipclPublicKey(key["n"], key["bits"], True, key["hs"],
                                key["randbits"], device=self.device)
        self.pk = pt.PaillierPublicKey(ipub)
        self.sk = pt.PaillierPrivateKey(self.pk, key["p"], key["q"])

    def encrypt(self, x: np.ndarray):
        return self.pk.encrypt(x)

    def decrypt(self, ct) -> np.ndarray:
        return np.asarray(self.sk.decrypt(ct), dtype=np.float64)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    def export(self, ct) -> tuple:
        """(canonical ciphertext ints, int64 exponents) of an answer."""
        return ([bn.value() for bn in ct.ciphertextBN()],
                np.asarray(ct.exponent(), dtype=np.int64))

    def counters(self) -> dict:
        return dict(self._kernels.COUNTS)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(self._torch.cuda.max_memory_allocated(self.device))


class RefCts:
    """The control's ciphertext: signed mantissas and exponents."""

    def __init__(self, mants: list, exps):
        self.mants = list(mants)
        self.exps = np.asarray(exps, dtype=np.int64)


class ControlSystem:
    control = True
    device = types.SimpleNamespace(type="host")

    def __init__(self, key: dict, device: str = "host"):
        self.key = ref.Key(key)
        self._obf = self.key.obfuscator(0x5A5A5A5A)   # one fixed r

    def encrypt(self, x: np.ndarray) -> RefCts:
        return RefCts(*ref.encode(lower(x)))

    def decrypt(self, ct: RefCts) -> np.ndarray:
        return np.asarray([ref.decode(m, e) for m, e in
                           zip(ct.mants, ct.exps)], dtype=np.float64)

    def sync(self) -> None:
        pass

    def export(self, ct: RefCts) -> tuple:
        return ([self.key.encrypt(m, self._obf) for m in ct.mants],
                ct.exps.copy())

    def counters(self) -> dict:
        return {}

    def memory_peak(self) -> int:
        return 0
