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

from ..models import paillier as sch
from ..ops import montgomery as mg
from ..ops import rns as _rns
from .distributed import require_group


def sharded_decrypt(priv, ct_local: torch.Tensor, mesh) -> torch.Tensor:
    """CRT decrypt of this rank's (L_n2, Bloc) Montgomery ciphertexts ->
    (Ln, Bloc) canonical plaintext limbs: the port's three stages
    (``_crt_stage_reduce``, ``PrivateContext._stage_exp`` on the
    context's engine, ``_crt_stage_recombine``) on the local columns;
    the 2*Bloc-wide p | q layout of the fused engine is local too."""
    require_group(ct_local)
    base_m = sch._crt_stage_reduce(ct_local, priv)
    return sch._crt_stage_recombine(priv._stage_exp(base_m), priv)


def sharded_mul_pt(pub, ct_local: torch.Tensor, exponents_local: list,
                   mesh) -> torch.Tensor:
    """ct^e per column of this rank's block (exponents >= 0, below n):
    ``mul_pt``'s chain, the per-element RNS modexp (kernel K5) when the
    ct*pt RNS plan is on, else the limb modexp (kernel K4, K10 without
    weights), over the full window count of the key as the reference
    runs it, so every rank runs the same chain whatever its exponents:
    equal to ``pub.mul_pt`` under ``fixed_shape_ops``."""
    require_group(ct_local)
    B = ct_local.shape[1]
    exps = list(exponents_local) + [0] * (B - len(exponents_local))
    rplan = pub._rns_mul_plan()
    if rplan is not None:
        base, key, w = rplan
        digits = mg.exponent_digits(exps, -(-pub.bits // w), w)
        return _rns.rns_pow_elem(ct_local, digits, base, key, pub.ctx, w,
                                 pub.L)
    digits = mg.exponent_digits(exps, pub.n_win_ct, sch.WINDOW)
    return mg.mont_exp(ct_local, digits, pub.ctx, window=sch.WINDOW)
