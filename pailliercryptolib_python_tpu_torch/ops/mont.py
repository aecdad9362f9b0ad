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

Digits are MSB-first 4-bit windows (n_win, B) or (n_win, 1), given on
the host (numpy or a CPU tensor) and range-checked there
(``kernels.digit_tensor``).  A CUDA tensor reaches its kernel or raises.
"""

from __future__ import annotations

import torch

from .limb import LIMB_DTYPE
from .montgomery import cios_mul, fixed_window_exp
from .. import kernels

MAX_LIMBS = 1040      # csrc/mont.cu kMaxLimbs: n^2 of an 8192-bit key


def mont_exp_plain(base, digits, n, n0, one,
                   win_start: int = 0) -> torch.Tensor:
    """Plain twin of K10 (digits a CPU or device tensor)."""
    return fixed_window_exp(base, digits, one,
                            lambda x, y: cios_mul(x, y, n, n0), 4,
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
    table = torch.empty((16, L, B), dtype=LIMB_DTYPE, device=base.device)
    kernels.launch("mont_exp", base, digits, one, out, table, n, n0,
                   per_elem, L, B, n_win, int(win_start))
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
