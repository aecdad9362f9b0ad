"""The expensive half of the HE op suite on a rank's own columns.

Counterpart of ``pailliercryptolib_python_tpu/parallel/sharded_ops.py``.
CRT decrypt and ct*pt are elementwise over the batch: every column's
modexp chain is independent and the key is replicated, so a rank runs
the whole chain on its (L, B/n) block and no collective runs inside it.
The reference proves that on the compiled HLO (``lower_sharded_decrypt``
and its audit); PyTorch runs eagerly and has no program to lower, so
that function has no counterpart here.  The check is
``collective.count_collectives`` around the call: it must stay empty
(the tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from .distributed import require_group


def sharded_decrypt(priv, ct_local: torch.Tensor, mesh) -> torch.Tensor:
    """CRT decrypt of this rank's (L_n2, Bloc) Montgomery ciphertexts ->
    (Ln, Bloc) canonical plaintext limbs: ``priv.decrypt_device`` on the
    local columns (the 2*Bloc-wide p | q layout of the fused engine is
    local too)."""
    require_group(ct_local)
    return priv.decrypt_device(ct_local)


def sharded_mul_pt(pub, ct_local: torch.Tensor, exponents_local: list,
                   mesh) -> torch.Tensor:
    """ct^e per column of this rank's block (exponents >= 0, below n):
    ``pub.mul_pt`` over the full window count of the key, as the
    reference runs it, so every rank runs the same chain whatever its
    exponents: equal to ``pub.mul_pt`` under ``fixed_shape_ops``."""
    require_group(ct_local)
    return pub.mul_pt(ct_local, exponents_local, full=True)
