"""Reductions on limb tensors: exact (Hensel) division, the Paillier
L-function L(u) = (u-1)/p as a truncated multiply by p^-1 mod
2^(16*out_limbs); and the HE sum's product tree (``tree_fold``)."""

from __future__ import annotations

import numpy as np
import torch

from .limb import LIMB_DTYPE, big_mul, h2d
from . import montgomery as mg


def exact_div(x, dinv, out_limbs: int):
    """x / d for exact divisions (d | x, x/d < 2^(16*out_limbs)); dinv:
    (out_limbs, 1|B) limbs of pow(d, -1, 2^(16*out_limbs))."""
    return big_mul(x[:out_limbs], dinv, out_limbs=out_limbs)


def tree_fold(x: torch.Tensor, ctx: mg.MontCtx, groups: int = 1,
              seg: int | None = None) -> torch.Tensor:
    """HE sums of `groups` contiguous segments of `seg` columns of x
    (seg defaults to x's width over groups) -> (L, groups): each segment
    padded with the Montgomery one (an encryption of zero) to a power of
    two P, then log2(P) folding rounds, each one product (kernel K3) of
    every segment's upper half into its lower half.  The padding: none
    for an exact fit, one ``torch.cat`` for a single segment, a scatter
    into a filled array for several."""
    L = x.shape[0]
    seg = x.shape[1] // groups if seg is None else seg
    P = 1 << max(0, (seg - 1).bit_length())
    one = ctx.one.to(LIMB_DTYPE)
    if seg == P and groups * P == x.shape[1]:
        arr = x
    elif groups == 1:
        arr = x[:, :seg]
        if P != seg:
            arr = torch.cat([arr, one.expand(L, P - seg)], dim=1)
    else:
        arr = one.expand(L, groups * P).clone()
        dst = np.concatenate([np.arange(g * P, g * P + seg)
                              for g in range(groups)])
        arr[:, h2d(torch.from_numpy(dst), x.device)] = x[:, :groups * seg]
    width = P
    while width > 1:
        half = width // 2
        a3 = arr.reshape(L, groups, width)
        arr = mg.mont_mul(a3[:, :, :half].reshape(L, groups * half),
                          a3[:, :, half:].reshape(L, groups * half), ctx)
        width = half
    return arr
