"""Montgomery reduction as int8 nibble matrix products.

Counterpart of ``pailliercryptolib_python_tpu/ops/matmul_mont.py``:

    modmul(a, b) = (T + q*m) / R,   T = a*b,   q = (T mod R) * mu mod R

with mu = -m^-1 mod R at full width.  q and q*m are products by shared
constants, so each is one product of a constant Toeplitz matrix of 4-bit
nibbles with the nibbles of the per-column value: exact in int8 operands
with int32 sums (products <= 225, at most 4L terms a slot).

Layouts (limbs-major, batch along the columns):
  * canonical value: (L, B) 16-bit limbs (int32 tensors, as ``ops/limb``);
  * nibble blocks: int8 (U*L, B); block u, row k holds bits [4u, 4u+4) of
    limb k (weight 2^(16k+4u));
  * product output: (4*T, B) in the same block layout over output limbs
    t < T; recombine = sum_v block_v << 4v.

The two weight products here are plain float64 matrix products
(``limb.idot``, exact): in the reference they are XLA-level work outside
any Pallas kernel.  Kernels K12-K15 (``ops/mont2.py``, ``csrc/mont2.cu``)
do the same two products inside their own bodies.
"""

from __future__ import annotations

import numpy as np
import torch

from .limb import (LIMB_BITS, big_mul, idot, int_to_limbs, limbs_to_int,
                   normalize, to_device)
from ..device import resolve


def const_mult_weights(C: int, in_limbs: int, in_blocks: int,
                       out_limbs: int) -> np.ndarray:
    """Toeplitz nibble weights for y = x * C (mod 2^(16*out_limbs) slots).

    Returns int8[(4*out_limbs, in_blocks*in_limbs)]:
      W[v*out_limbs + t, u*in_limbs + k] = nibble_{4(t-k)+v-u}(C)
    so that  dot(W, nibble_blocks(x, in_blocks)) is the block layout of
    x*C truncated to out_limbs 16-bit limbs.
    """
    c_nibs = np.asarray(int_to_limbs(C, 4 * out_limbs), dtype=np.int64)
    # int_to_limbs gives 16-bit limbs; re-split to 4-bit nibbles
    nibs = np.zeros(4 * 4 * out_limbs, dtype=np.int8)
    for u in range(4):
        nibs[u::4] = (c_nibs >> (4 * u)) & 15

    t = np.arange(out_limbs)
    k = np.arange(in_limbs)
    W = np.zeros((4 * out_limbs, in_blocks * in_limbs), dtype=np.int8)
    for v in range(4):
        for u in range(in_blocks):
            j = 4 * (t[:, None] - k[None, :]) + (v - u)   # (T, K)
            valid = (j >= 0) & (j < nibs.shape[0])
            W[v * out_limbs + t[:, None],
              u * in_limbs + k[None, :]] = np.where(
                  valid, nibs[np.clip(j, 0, nibs.shape[0] - 1)], 0)
    return W


def nibble_blocks(x: torch.Tensor, blocks: int) -> torch.Tensor:
    """(L, B) canonical limbs -> int8 (blocks*L, B) block-nibble layout."""
    x = x.to(torch.int64)
    return torch.cat([((x >> (4 * u)) & 15).to(torch.int8)
                      for u in range(blocks)], dim=0)


def recombine_blocks(y: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """(4*T, B) block-layout slots -> (T, B) redundant int64 limbs
    (below 900L * 4369 < 2^32 for the weights built here, L <= 1092)."""
    y = y.to(torch.int64)
    acc = y[:out_limbs]
    for v in range(1, 4):
        acc = acc + (y[v * out_limbs:(v + 1) * out_limbs] << (4 * v))
    return acc


def mm_reduce(T: torch.Tensor, W_mu: torch.Tensor, W_m: torch.Tensor,
              L: int) -> torch.Tensor:
    """(T + q*m)/R < 2m for a canonical 2L-limb T < mR: the two nibble
    products, q = T*mu mod R canonical, then the high L limbs of
    T + q*m."""
    q = normalize(recombine_blocks(idot(W_mu, nibble_blocks(T[:L], 4)), L))
    s = recombine_blocks(idot(W_m, nibble_blocks(q, 4)), 2 * L)
    return normalize(s + T.to(torch.int64))[L:]


def _mu(m: int, L: int) -> int:
    """-m^-1 mod R, R = 2^(16L)."""
    R = 1 << (LIMB_BITS * L)
    return (-pow(m, -1, R)) % R


class MatmulMontCtx:
    """Per-modulus constants for the matmul-Montgomery path, on a device.

    m odd, R = 2^(16L) with 4m < R (Walter).  W_mu int8 (4L, 4L) reduces
    mod R by mu; W_m int8 (8L, 4L) is the full product by m; m_limbs is
    (L, 1) int32.  Built once per key on the host."""

    def __init__(self, m: int, L: int, device=None):
        if 4 * m >= (1 << (LIMB_BITS * L)):
            raise ValueError("MatmulMontCtx: modulus too large for L")
        self._set(m, L, const_mult_weights(_mu(m, L), L, 4, L),
                  const_mult_weights(m, L, 4, 2 * L),
                  int_to_limbs(m, L)[:, None], resolve(device))

    def _set(self, m, L, W_mu, W_m, m_limbs, dev) -> None:
        self.m = m
        self.L = L
        self.mu = _mu(m, L)
        self.W_mu = torch.from_numpy(np.ascontiguousarray(
            np.asarray(W_mu).astype(np.int8))).to(dev)
        self.W_m = torch.from_numpy(np.ascontiguousarray(
            np.asarray(W_m).astype(np.int8))).to(dev)
        self.m_limbs = to_device(m_limbs, dev)

    @classmethod
    def from_arrays(cls, arrays: dict, device=None) -> "MatmulMontCtx":
        """Context from numpy arrays (e.g. the JAX package's context's
        W_mu, W_m and m_limbs); m and L follow from m_limbs."""
        m_limbs = np.asarray(arrays["m_limbs"])
        ctx = cls.__new__(cls)
        ctx._set(limbs_to_int(m_limbs.reshape(-1)), m_limbs.shape[0],
                 arrays["W_mu"], arrays["W_m"], m_limbs, resolve(device))
        return ctx


def mm_mul(a: torch.Tensor, b: torch.Tensor, W_mu: torch.Tensor,
           W_m: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod m by the nibble reduction, from the
    weights alone: the schoolbook product to 2L limbs, then ``mm_reduce``.
    a, b canonical (L, B|1) limbs < 2m; returns canonical (L, B) < 2m,
    int32.  The plain twin of K12 (``mont2.mm2_mul_plain``)."""
    L = a.shape[0]
    return mm_reduce(big_mul(a, b, out_limbs=2 * L), W_mu, W_m, L)


def mont_mul_mm(a: torch.Tensor, b: torch.Tensor,
                mctx: MatmulMontCtx) -> torch.Tensor:
    """``mm_mul`` on mctx's weights."""
    return mm_mul(a, b, mctx.W_mu, mctx.W_m)

