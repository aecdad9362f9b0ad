"""Montgomery product (K9), per-element modexp (K10) and product chain
(K11) with a modulus per column or one shared modulus, for contexts
without mm3 weights.

Counterpart of ``pailliercryptolib_python_tpu/ops/pallas_mont.py``
(``mont_mul_p``, ``mont_exp_p``, ``mont_chain_p``), with the same broadcasting: operands
(L, B) or (L, 1); n (L, 1) or (L, B); n0 an int or a (1,) / (B,) tensor
of -n^-1 mod 2^16; ``one`` (the Montgomery one) shaped like n.

* ``mont_mul_p(a, b, n, n0)`` -- kernel K9 (``csrc/mont.cu``) on a CUDA
  tensor, ``montgomery.cios_mul`` (the CIOS product of the JAX package's
  ``_mm_val`` / ``_mont_mul_jnp``) on a CPU tensor.
* ``mont_exp_p(base, digits, n, n0, one, win_start)`` -- kernel K10 on a
  CUDA tensor, ``mont_exp_plain`` on a CPU tensor: the table
  ``[one, base, base^2, ...]`` by successive products, then per 4-bit
  window four squarings and one product by the selected entry.
* ``mont_chain_p(factors, acc0, n, n0)`` -- kernel K11 on a CUDA tensor,
  ``mont_chain_plain`` on a CPU tensor: ``acc0 * prod_j factors[j]``, one
  product per pre-gathered factor (the fused form of the limb comb
  encrypt chain, ``montgomery.mont_exp_fixed_base``).

K9, K10 and K11 multiply on one routine (``csrc/coop.cuh``, which K8
and K15 share): 32-bit words, a group of 8-32 lanes per column, the
words in registers, (g, K) picked from L and B
(``kernels.mont_exp_shape``).  ``cios32_mul`` is that product's
arithmetic in plain PyTorch, and ``mont_exp_words`` K10's chain over it,
for the CPU tests.  The wrappers copy a broadcast (L, 1) operand out to
(L, B) before the launch; only the modulus is read at column stride 0.

Digits are MSB-first 4-bit windows (n_win, B) or (n_win, 1), given on
the host (numpy or a CPU tensor) and range-checked there
(``kernels.digit_tensor``).  A CUDA tensor reaches its kernel or raises.
"""

from __future__ import annotations

import torch

from .limb import LIMB_DTYPE, LIMB_MASK
from .montgomery import cios_mul, fixed_window_exp
from .. import kernels

MAX_LIMBS = 1040      # csrc/mont.cu kMaxLimbs: n^2 of an 8192-bit key


def mont_exp_plain(base, digits, n, n0, one,
                   win_start: int = 0) -> torch.Tensor:
    """Plain twin of K10 (digits a CPU or device tensor)."""
    return fixed_window_exp(base, digits, one,
                            lambda x, y: cios_mul(x, y, n, n0), 4,
                            win_start)


_M32 = (1 << 32) - 1


def _words(x: torch.Tensor, W: int) -> torch.Tensor:
    """(L, B) 16-bit limbs -> (W, B) 32-bit words (int64), limb pairs."""
    L, B = x.shape
    x = x.to(torch.int64)
    if 2 * W > L:
        x = torch.cat([x, x.new_zeros((2 * W - L, B))])
    return x[0::2] | (x[1::2] << 16)


def _mul_lo_hi(x: torch.Tensor, y: torch.Tensor):
    """Low and high 32-bit words of x*y for x, y in [0, 2^32), exact in
    int64 (x split into 16-bit halves)."""
    p0 = (x & LIMB_MASK) * y                    # < 2^48
    p1 = (x >> 16) * y                          # < 2^48
    lo = p0 + ((p1 & LIMB_MASK) << 16)          # < 2^49
    return lo & _M32, (lo >> 32) + (p1 >> 16)


def cios32_mul(a, b, n, n0) -> torch.Tensor:
    """a*b*R^-1 mod n (R = 2^(16L)) as kernels K8-K11 and K15 compute
    it, in plain PyTorch (K8 and K15's squarings as ``cios32_mul(a, a,
    n, n0)``): the limbs paired into W = ceil(L/2) 32-bit words, W word
    steps t = (t + a_i b + q n) / 2^32 with q = t_0 n' mod 2^32 and
    n' = -n^-1 mod 2^32 from the 16-bit n0 by one Newton step,
    n' = n0 (2 + n n0).  For odd L the outer operand enters as a 2^16
    (word i = a_i << 16 | a_(i-1) >> 16), so the W steps divide by
    2^(32W) = 2^16 R and the result is the unique (a b + q n)/R, equal
    to ``cios_mul`` limb for limb.  The running sum is carry-save in
    int64.  Shapes as ``cios_mul``."""
    L = a.shape[0]
    B = max(a.shape[1], b.shape[1], n.shape[1])
    W = (L + 1) // 2
    A = _words(a, W).expand(W, B)
    if L % 2:
        A = ((A << 16) & _M32) | torch.cat([A.new_zeros((1, B)),
                                           A[:-1] >> 16])
    Bw = _words(b, W).expand(W, B)
    Nw = _words(n, W)
    h = torch.as_tensor(n0, dtype=torch.int64).reshape(-1).to(a.device)
    np_ = _mul_lo_hi(h, (2 + _mul_lo_hi(Nw[0], h)[0]) & _M32)[0]
    t = torch.zeros((W + 2, B), dtype=torch.int64, device=a.device)
    for i in range(W):
        lo, hi = _mul_lo_hi(A[i], Bw)
        t[:W] += lo
        t[1:W + 1] += hi
        q = _mul_lo_hi(t[0] & _M32, np_)[0]
        lo, hi = _mul_lo_hi(q, Nw)
        t[:W] += lo
        t[1:W + 1] += hi
        t[1] += t[0] >> 32                       # word 0 is now 0 mod 2^32
        t = torch.cat([t[1:], t.new_zeros((1, B))])
    for i in range(W + 1):                       # resolve the carries
        t[i + 1] += t[i] >> 32
        t[i] &= _M32
    limbs = torch.stack([t[:W] & LIMB_MASK, t[:W] >> 16], 1).reshape(2 * W, B)
    return limbs[:L].to(LIMB_DTYPE)


def mont_exp_words(base, digits, n, n0, one,
                   win_start: int = 0) -> torch.Tensor:
    """K10's chain over ``cios32_mul`` (the kernel's order of products:
    the table by T[d] = T[d-1] base, then four squarings and one product
    by T[digit] a window); equals ``mont_exp_plain``."""
    return fixed_window_exp(base, torch.as_tensor(digits), one,
                            lambda x, y: cios32_mul(x, y, n, n0), 4,
                            win_start)


def mont_chain_plain(factors, acc0, n, n0) -> torch.Tensor:
    """Plain twin of K11: factors (n_win, L, B), acc0 (L, B|1)."""
    acc = acc0
    for j in range(factors.shape[0]):
        acc = cios_mul(acc, factors[j], n, n0)
    return acc.to(LIMB_DTYPE)


def mont_chain_p(factors: torch.Tensor, acc0: torch.Tensor,
                 n: torch.Tensor, n0) -> torch.Tensor:
    """acc0 * prod_j factors[j] * R^-n_win mod n per column: factors
    (n_win, L, B) and acc0 (L, B|1) canonical limbs < 2n."""
    if factors.device.type == "cpu":
        return mont_chain_plain(factors, acc0, n, n0)
    return _mont_chain_cuda(factors, acc0, n, n0)


def mont_mul_p(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
               n0) -> torch.Tensor:
    """a*b*R^-1 mod n per column; canonical (L, B) limbs < 2n in and out."""
    if a.device.type == "cpu":
        return cios_mul(a, b, n, n0)
    return _mont_mul_cuda(a, b, n, n0)


def mont_exp_p(base: torch.Tensor, digits, n: torch.Tensor, n0,
               one: torch.Tensor, win_start: int = 0) -> torch.Tensor:
    """base^e (Montgomery form) per column; windows before win_start are
    skipped inside the loop."""
    digits = kernels.digit_tensor(digits, 4, base.device)
    if base.device.type == "cpu":
        return mont_exp_plain(base, digits, n, n0, one, win_start)
    return _mont_exp_cuda(base, digits, n, n0, one, win_start)


def _operands(n, n0, B: int, dev, *others):
    """(per_elem, n, n0, others...) as the kernels read them: per-element
    (n (L, B), n0 (B,), each other (L, B)) when any of them varies by
    column, else shared (n (L, 1), n0 (1,), each other (L, 1))."""
    L = n.shape[0]
    if isinstance(n0, int):
        n0 = torch.full((1,), n0, dtype=LIMB_DTYPE, device=dev)
    kernels.require_cuda(n, n0, *others)
    per_elem = int(n.shape[1] > 1 or n0.numel() > 1
                   or any(o.shape[1] > 1 for o in others))
    W = B if per_elem else 1
    return (per_elem, n.to(LIMB_DTYPE).expand(L, W).contiguous(),
            n0.to(LIMB_DTYPE).reshape(-1).expand(W).contiguous(),
            *(o.to(LIMB_DTYPE).expand(L, W).contiguous() for o in others))


def _check_limbs(L: int) -> None:
    if not 2 <= L <= MAX_LIMBS:
        raise ValueError(f"K9/K10/K11 take 2 <= L <= {MAX_LIMBS} limbs; "
                         f"got {L}")


def _mont_mul_cuda(a, b, n, n0) -> torch.Tensor:
    L = a.shape[0]
    _check_limbs(L)
    kernels.require_cuda(a, b)
    B = max(a.shape[1], b.shape[1], n.shape[1])
    per_elem, n, n0 = _operands(n, n0, B, a.device)
    a = a.to(LIMB_DTYPE).expand(L, B).contiguous()
    b = b.to(LIMB_DTYPE).expand(L, B).contiguous()
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=a.device)
    kernels.launch("mont_mul", a, b, out, n, n0, per_elem, L, B)
    return out


def _mont_exp_cuda(base, digits, n, n0, one, win_start) -> torch.Tensor:
    L = base.shape[0]
    _check_limbs(L)
    kernels.require_cuda(base, digits)
    n_win = digits.shape[0]
    B = max(base.shape[1], digits.shape[1], n.shape[1], one.shape[1])
    per_elem, n, n0, one = _operands(n, n0, B, base.device, one)
    base = base.to(LIMB_DTYPE).expand(L, B).contiguous()
    digits = digits.expand(n_win, B).contiguous()
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=base.device)
    kernels.launch("mont_exp", base, digits, one, out, n, n0, per_elem, L,
                   B, n_win, int(win_start))
    return out


def _mont_chain_cuda(factors, acc0, n, n0) -> torch.Tensor:
    n_win, L, B = factors.shape
    _check_limbs(L)
    kernels.require_cuda(factors, acc0)
    per_elem, n, n0 = _operands(n, n0, B, factors.device)
    factors = factors.to(LIMB_DTYPE).contiguous()
    acc0 = acc0.to(LIMB_DTYPE).expand(L, B).contiguous()
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=factors.device)
    kernels.launch("mont_chain", factors, acc0, out, n, n0, per_elem, n_win,
                   L, B)
    return out
