"""The systems a cell can drive: the port, or the control in its place.

``PortSystem`` is the system under test: ``pailliercryptolib_python_tpu_torch``
through its public API (``PaillierPublicKey.encrypt``,
``PaillierPrivateKey.decrypt``, and the operators of
``PaillierEncryptedNumber`` that the request kinds call) on its default
engines.  From the program the benchmark takes only these calls, the
exported ciphertexts and exponents of their answers, and the launch
counters of ``kernels.COUNTS``.

``ShardedPortSystem`` is the port as one rank of a process group, one
card a rank: the group joined through ``parallel.distributed``, a (1,
ranks) mesh from ``parallel.mesh``, and the sharded calls of
``parallel.collective`` on this rank's columns.

``ControlSystem`` puts the plain reference in the program's place,
computed one precision below the configuration's: the floats it is
handed are rounded to float32 (24-bit mantissas) before they are
encoded; each request kind computes its own answer on them
(``Kind.control``).  Its answers are ciphertexts too, made by
encrypting the reference's plaintexts under one fixed obfuscator, so
the same judge reads them.  A correct judge must find it wrong.
"""

from __future__ import annotations

import os
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


class ShardedPortSystem(PortSystem):
    """One rank of a run over several cards (``ranks.py``): the port's
    process group from its launch contract (``PAILLIER_COORDINATOR``,
    ``PAILLIER_NUM_PROCESSES``, ``PAILLIER_PROCESS_ID``; NCCL on a card,
    gloo on the CPU), a (1, ranks) mesh, the key's public context."""

    def __init__(self, key: dict, device: str):
        import torch
        from pailliercryptolib_python_tpu_torch.parallel import (
            collective, distributed, mesh)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        super().__init__(key, device)
        self._collective, self._mesh, self._dist = collective, mesh, \
            distributed
        distributed.initialize(os.environ["PAILLIER_COORDINATOR"],
                               int(os.environ["PAILLIER_NUM_PROCESSES"]),
                               int(os.environ["PAILLIER_PROCESS_ID"]),
                               device=self.device)
        self.rank, self.world = distributed.process_info()
        self.mesh = mesh.make_mesh(1, self.world, self.device.type)
        self.pub = self.pk.pubkey.context

    def columns(self, B: int) -> tuple:
        """(lo, hi): this rank's columns of a B-wide batch."""
        return self._mesh.batch_bounds(self.mesh, B, self.rank)

    def encrypt_ints(self, x: np.ndarray):
        """Obfuscated Montgomery ciphertexts (L, len(x)) of integers."""
        return self.pub.encrypt(x.tolist(), pad_to=len(x))

    def sharded_sum(self, parts: list):
        """The HE sum of every column of the parties' batches, over every
        rank: the parties combined elementwise, then the encrypted
        all-reduce; (L, 1), the same on every rank."""
        agg = self._collective.federated_aggregate(parts, self.pub.ctx,
                                                   self.mesh)
        return self._collective.sharded_he_sum(agg, self.pub.ctx, self.mesh)

    def export_total(self, total) -> list:
        """Canonical ciphertext ints of an (L, k) answer."""
        return self.pub.export_cts(total, total.shape[1])

    def close(self) -> None:
        self._dist.shutdown()


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
