"""Exact (Hensel) division on limb tensors: the Paillier L-function
L(u) = (u-1)/p as a truncated multiply by p^-1 mod 2^(16*out_limbs)."""

from __future__ import annotations

from .limb import big_mul


def exact_div(x, dinv, out_limbs: int):
    """x / d for exact divisions (d | x, x/d < 2^(16*out_limbs)); dinv:
    (out_limbs, 1|B) limbs of pow(d, -1, 2^(16*out_limbs))."""
    return big_mul(x[:out_limbs], dinv, out_limbs=out_limbs)
