"""Shared-modulus Montgomery product (K3), per-element modexp (K4) and
shared-exponent modexp (K7).

Counterpart of ``pailliercryptolib_python_tpu/ops/pallas_mont3.py``.

* ``mm3_mul(a, b, ctx)`` -- kernel K3 (``csrc/mont3.cu``) on a CUDA
  tensor, ``mm3_mul_plain`` on a CPU tensor.
* ``mm3_exp(base, digits, ctx, win_start)`` -- kernel K4 on a CUDA
  tensor, ``mm3_exp_plain`` on a CPU tensor.
* ``mm3_exp_shared(base, digits, ctx, window)`` -- kernel K7 on a CUDA
  tensor, ``mm3_exp_shared_plain`` on a CPU tensor.

The plain twins keep the TPU kernel's algorithm: the schoolbook product,
then the Montgomery reduction as two signed-byte Toeplitz matrix products
(q = T*mu mod R, then T + q*m), here as exact float64 matmuls.  The CUDA
kernels use a plain CIOS reduction instead; both give the unique
(a*b + q*m)/R with q = -a*b*m^-1 mod R, so they agree limb for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from .limb import (LIMB_BITS, LIMB_DTYPE, big_mul, idot, int_to_limbs,
                   normalize)
from .. import kernels

BIAS = 1 << 26          # per-limb slot bias: |signed slot| < 2^26

# Window of the shared-exponent modexp.  The JAX package picks it from
# its 16 MB scoped-VMEM tile model; the same rule here makes both
# packages pick the same window (5 at L=129, the 2048-bit key's p^2/q^2
# limbs), hence the same digits.  The model sets nothing inside the CUDA
# kernel, whose table lives in global memory.
_VMEM_BUDGET = 13_500_000
_ROWS_PER_L = 40


def shared_exp_window(L: int) -> int:
    """Window of the shared-exponent modexp at L limbs: the widest of
    5, 4, 3 whose table fits the reference's smallest (128-wide) tile."""
    stride = -(-L // 8) * 8                  # the TPU table's 8-aligned rows
    for w in (5, 4, 3):
        if 4 * 128 * ((1 << w) * stride + _ROWS_PER_L * L) <= _VMEM_BUDGET:
            return w
    return 2


# ---------------------------------------------------------------------------
# Host-side weight/constant construction (ported verbatim).
# ---------------------------------------------------------------------------

def signed_bytes_of(c: int, nbytes: int) -> np.ndarray:
    """Signed-byte digits s_j in [-128,127] with c = sum 256^j s_j
    (mod 256^nbytes)."""
    out = np.zeros(nbytes, dtype=np.int8)
    c = c % (1 << (8 * nbytes))
    carry = 0
    for j in range(nbytes):
        v = ((c >> (8 * j)) & 0xFF) + carry
        if v >= 128:
            out[j] = v - 256
            carry = 1
        else:
            out[j] = v
            carry = 0
    return out


def byte_toeplitz(c: int, in_limbs: int, out_limbs: int) -> np.ndarray:
    """int8 (2*out_limbs, 2*in_limbs) block-layout Toeplitz weights for
    y = x*c truncated to out_limbs 16-bit limbs:
    W[v*T + t, u*K + k] = sb_{2(t-k) + v - u}(c)."""
    sb = signed_bytes_of(c, 2 * out_limbs)
    t = np.arange(out_limbs)
    k = np.arange(in_limbs)
    W = np.zeros((2 * out_limbs, 2 * in_limbs), dtype=np.int8)
    for v in range(2):
        for u in range(2):
            j = 2 * (t[:, None] - k[None, :]) + (v - u)
            valid = (j >= 0) & (j < sb.shape[0])
            W[v * out_limbs + t[:, None], u * in_limbs + k[None, :]] = \
                np.where(valid, sb[np.clip(j, 0, sb.shape[0] - 1)], 0)
    return W


def byte_weights_np(m: int, L: int):
    """(wmu int8 (2L,2L), wm int8 (4L,2L), off1 (L,1), off2 (2L,1)) as
    numpy: the Toeplitz weights of mu = -m^-1 mod R and of m, and the
    folded byte-centering / bias-compensation offsets."""
    R = 1 << (LIMB_BITS * L)
    if 4 * m >= R:
        raise ValueError("byte_weights: modulus too large for L")
    mu = (-pow(m, -1, R)) % R
    S_bytes = ((1 << (8 * 2 * L)) - 1) // 255
    S16_L = (R - 1) // 0xFFFF
    S16_2L = ((1 << (32 * L)) - 1) // 0xFFFF
    off1 = (128 * S_bytes * mu - BIAS * S16_L) % R
    off2 = (128 * S_bytes * m - BIAS * S16_2L) % (1 << (32 * L))
    return (byte_toeplitz(mu, L, L), byte_toeplitz(m, L, 2 * L),
            int_to_limbs(off1, L)[:, None], int_to_limbs(off2, 2 * L)[:, None])


def byte_weights(m: int, L: int, device):
    """byte_weights_np as tensors on `device` (int8 weights, int32 offsets)."""
    wmu, wm, off1, off2 = byte_weights_np(m, L)
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(device)
    return t(wmu, np.int8), t(wm, np.int8), t(off1, np.int32), t(off2, np.int32)


# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------

def _bytes_c(x: torch.Tensor) -> torch.Tensor:
    """(L, B) canonical limbs -> (2L, B) centred bytes (lo block, hi block)."""
    x = x.to(torch.int64)
    return torch.cat([(x & 0xFF) - 128, ((x >> 8) & 0xFF) - 128], dim=0)


def _recombine3(y: torch.Tensor, out_limbs: int, off: torch.Tensor,
                extra: torch.Tensor | None = None) -> torch.Tensor:
    """Signed (2T, B) byte slots -> redundant (T, B) limbs:
    limb t = y0[t] + (y1[t] mod 256)<<8 + (y1[t-1] >> 8) + BIAS + off[t]."""
    y0 = y[:out_limbs]
    y1 = y[out_limbs:2 * out_limbs]
    h1 = y1 >> 8                                    # arithmetic shift
    h1s = torch.cat([torch.zeros_like(h1[:1]), h1[:-1]], dim=0)
    acc = y0 + ((y1 & 0xFF) << 8) + h1s + BIAS + off.to(torch.int64)
    if extra is not None:
        acc = acc + extra.to(torch.int64)
    return acc


def _mm3_reduce(T, wmu, wm, off1, off2, L):
    """(T + q*m)/R for a canonical 2L-limb T < mR, q = T*mu mod R."""
    q = normalize(_recombine3(idot(wmu, _bytes_c(T[:L])), L, off1))[:L]
    s = normalize(_recombine3(idot(wm, _bytes_c(q)), 2 * L, off2, extra=T))
    return s[L:]


def mm3_mul_plain(a, b, wmu, wm, off1, off2) -> torch.Tensor:
    """Plain twin of K3: canonical < 2m in and out."""
    L = a.shape[0]
    T = big_mul(a, b, out_limbs=2 * L)
    return _mm3_reduce(T, wmu, wm, off1, off2, L)


def mm3_exp_plain(base, digits, wmu, wm, off1, off2, one,
                  win_start: int = 0) -> torch.Tensor:
    """Plain twin of K4: 4-bit fixed window, 16-entry table, per-element
    digits (n_win, B), windows before win_start skipped."""
    from .montgomery import fixed_window_exp
    mul = lambda x, y: mm3_mul_plain(x, y, wmu, wm, off1, off2)
    return fixed_window_exp(base, digits, one, mul, 4, win_start)


def mm3_exp_shared_plain(base, digits, wmu, wm, off1, off2, one,
                         window: int) -> torch.Tensor:
    """Plain twin of K7: one exponent for the batch, digits (n_win,)
    MSB-first base-2^window; table T[d] = T[d-1]*base of 2^window
    entries, then per window `window` squarings and one product by T[d]."""
    from .montgomery import fixed_window_exp
    mul = lambda x, y: mm3_mul_plain(x, y, wmu, wm, off1, off2)
    return fixed_window_exp(base, digits.reshape(-1, 1), one, mul, window)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensor -> plain twin; CUDA tensor -> kernel, else raise.
# ---------------------------------------------------------------------------

def _cols(x: torch.Tensor, L: int, B: int) -> torch.Tensor:
    return x.to(LIMB_DTYPE).expand(L, B).contiguous()


def mm3_mul(a: torch.Tensor, b: torch.Tensor, ctx) -> torch.Tensor:
    """a*b*R^-1 mod m (shared m); (L, B|1) canonical limbs < 2m."""
    if a.device.type == "cpu":
        return mm3_mul_plain(a, b, ctx.wmu, ctx.wm, ctx.off1, ctx.off2)
    return _mm3_mul_cuda(a, b, ctx)


def _mm3_mul_cuda(a, b, ctx) -> torch.Tensor:
    kernels.require_cuda(a, b, ctx.n_limbs)
    L = a.shape[0]
    B = max(a.shape[1], b.shape[1])
    a, b = _cols(a, L, B), _cols(b, L, B)
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=a.device)
    n = ctx.n_limbs.contiguous()
    kernels.launch("mm3_mul", a, b, out, n, ctx.n0inv, L, B)
    return out


def mm3_exp(base: torch.Tensor, digits: torch.Tensor, ctx,
            win_start: int = 0) -> torch.Tensor:
    """base^e (Montgomery form) with per-element 4-bit MSB-first digits
    (n_win, B); windows before win_start are skipped inside the loop."""
    if base.device.type == "cpu":
        return mm3_exp_plain(base, digits, ctx.wmu, ctx.wm, ctx.off1,
                             ctx.off2, ctx.one, win_start)
    return _mm3_exp_cuda(base, digits, ctx, win_start)


def _mm3_exp_cuda(base, digits, ctx, win_start) -> torch.Tensor:
    kernels.require_cuda(base, digits, ctx.n_limbs)
    L = base.shape[0]
    n_win = digits.shape[0]
    B = max(base.shape[1], digits.shape[1])
    base = _cols(base, L, B)
    digits = digits.to(torch.int32).expand(n_win, B).contiguous()
    if int(digits.max()) > 15 or int(digits.min()) < 0:
        raise ValueError("mm3_exp: digits must be 4-bit")
    one = ctx.one.contiguous()
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=base.device)
    table = torch.empty((16, L, B), dtype=LIMB_DTYPE, device=base.device)
    kernels.launch("mm3_exp", base, digits, one, out, table, ctx.n_limbs,
                   ctx.n0inv, L, B, n_win, int(win_start))
    return out


def mm3_exp_shared(base: torch.Tensor, digits, ctx,
                   window: int) -> torch.Tensor:
    """base^e (Montgomery form) with one exponent for the batch: digits
    (n_win,) MSB-first base-2^window, on the host (numpy or a CPU
    tensor)."""
    digits = kernels.digit_tensor(digits, window, base.device).reshape(-1)
    if base.device.type == "cpu":
        return mm3_exp_shared_plain(base, digits, ctx.wmu, ctx.wm, ctx.off1,
                                    ctx.off2, ctx.one, window)
    return _mm3_exp_shared_cuda(base, digits, ctx, window)


def _mm3_exp_shared_cuda(base, digits, ctx, window) -> torch.Tensor:
    kernels.require_cuda(base, digits, ctx.n_limbs)
    L, B = base.shape
    base = _cols(base, L, B)
    one = ctx.one.contiguous()
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=base.device)
    table = torch.empty((1 << window, L, B), dtype=LIMB_DTYPE,
                        device=base.device)
    kernels.launch("mm3_exp_shared", base, digits, digits.shape[0], one,
                   out, table, ctx.n_limbs, ctx.n0inv, L, B, window)
    return out
