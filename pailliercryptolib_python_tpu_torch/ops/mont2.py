"""Matmul-Montgomery (nibble, "v2") product (K12), square (K13),
per-element modexp (K14) and shared-exponent modexp (K15).

Counterpart of ``pailliercryptolib_python_tpu/ops/pallas_mont2.py``, with
its signatures: the modulus enters only through the nibble weights of
``ops/matmul_mont.MatmulMontCtx`` (wmu int8 (4L, 4L), wm int8 (8L, 4L)),
and the chains take the Montgomery one as an (L, 1) column.

* ``mm2_mul(a, b, wmu, wm)`` -- kernel K12 (``csrc/mont2.cu``) on a CUDA
  tensor, ``mm2_mul_plain`` (``matmul_mont.mm_mul``: the schoolbook
  ``limb.big_mul``, then ``matmul_mont.mm_reduce``) on a CPU tensor.
* ``mm2_sqr(a, wmu, wm)`` -- K13, or ``mm2_sqr_plain`` (the symmetric
  ``mont3.big_sqr``, in ``_mm2_square``'s order, then the reduction).
* ``mm2_exp(base, digits, wmu, wm, one, win_start)`` -- K14, or
  ``mm2_exp_plain``: 4-bit windows, a 16-entry table, per-element digits
  (n_win, B|1) MSB-first.
* ``mm2_exp_shared(base, digits, wmu, wm, one, window)`` -- K15, or
  ``mm2_exp_shared_plain``: one exponent for the batch, digits (n_win,)
  MSB-first base-2^window.

All four kernels run on the cooperative 32-bit-word routine of
``csrc/coop.cuh`` (``mont.cios32_mul``), their modulus and n' recovered
from column 0 of ``wm`` (``wm_words``); K14 runs K10's chain
(``coop::exp_chain``).  ``mm2_mul_words``, ``mm2_sqr_words``,
``mm2_exp_words`` and ``mm2_exp_shared_words`` are their arithmetic in
plain PyTorch, for the CPU tests.  The nibble reduction of the
reference's kernels (``matmul_mont.mm_reduce``) runs only in the plain
twins ``mm2_mul_plain`` / ``mm2_sqr_plain`` and the chains over them.

Digits are given on the host (numpy or a CPU tensor) and range-checked
there (``kernels.digit_tensor``).  Every result is the unique
(T + q*m)/R < 2m of each product, so the kernels, the twins, the TPU
kernels and the mm3 / CIOS kernels agree limb for limb.
"""

from __future__ import annotations

import torch

from .limb import LIMB_DTYPE
from .matmul_mont import mm_mul, mm_reduce
from .mont import cios32_mul, mont_exp_words
from .mont3 import big_sqr
from .montgomery import fixed_window_exp
from .. import kernels

# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------

# Plain twin of K12: canonical < 2m in and out.
mm2_mul_plain = mm_mul


def mm2_sqr_plain(a, wmu, wm) -> torch.Tensor:
    """Plain twin of K13: a*a*R^-1 mod m, canonical < 2m in and out."""
    return mm_reduce(big_sqr(a), wmu, wm, a.shape[0])


def mm2_exp_plain(base, digits, wmu, wm, one,
                  win_start: int = 0) -> torch.Tensor:
    """Plain twin of K14 (digits a tensor (n_win, B|1))."""
    return fixed_window_exp(base, digits, one,
                            lambda x, y: mm2_mul_plain(x, y, wmu, wm), 4,
                            win_start)


def mm2_exp_shared_plain(base, digits, wmu, wm, one,
                         window: int) -> torch.Tensor:
    """Plain twin of K15 (digits a tensor (n_win,))."""
    return fixed_window_exp(base, digits.reshape(-1, 1), one,
                            lambda x, y: mm2_mul_plain(x, y, wmu, wm),
                            window)


def wm_words(wm: torch.Tensor, L: int) -> tuple:
    """(words, n') as kernels K12, K13 and K15 recover them from the
    weights wm = ``const_mult_weights(m, L, 4, 2L)``: row v*2L + t of
    column 0 holds nibble 4t+v of m, so limb t is sum_v wm[v*2L + t, 0]
    << 4v; word i of the (W,) int64 words (W = ceil(L/2)) holds limbs 2i
    and 2i+1 (0 past L), as the block builds them in shared memory; n' =
    -m^-1 mod 2^32 from word 0 by four Newton steps y = y (2 + m y) from
    y = -m mod 2^32."""
    col = wm[:, 0].to(torch.int64)
    limbs = sum(col[v * 2 * L:v * 2 * L + L] << (4 * v) for v in range(4))
    W = (L + 1) // 2
    limbs = torch.cat([limbs, limbs.new_zeros(2 * W - L)]).reshape(W, 2)
    words = limbs[:, 0] | (limbs[:, 1] << 16)
    m0 = int(words[0])
    y = -m0 % (1 << 32)
    for _ in range(4):
        y = y * (2 + m0 * y) % (1 << 32)
    return words, y


def wm_modulus(wm: torch.Tensor, L: int) -> tuple:
    """(m, n'): m's (L, 1) limbs split from ``wm_words`` and its n'."""
    words, np_ = wm_words(wm, L)
    limbs = torch.stack([words & 0xFFFF, words >> 16], 1).reshape(-1)[:L]
    return limbs.reshape(L, 1).to(LIMB_DTYPE), np_


def mm2_mul_words(a, b, wm) -> torch.Tensor:
    """K12's product in plain PyTorch: ``cios32_mul`` with m and n' from
    ``wm_words`` (n' mod 2^16 as its n0).  Equals ``mm2_mul_plain`` limb
    for limb."""
    m, np_ = wm_modulus(wm, a.shape[0])
    return cios32_mul(a, b, m, np_ & 0xFFFF)


def mm2_sqr_words(a, wm) -> torch.Tensor:
    """K13's square in plain PyTorch: ``mm2_mul_words(a, a, wm)``, one
    operand, as the kernel's ``coop_mul(x, x, x)``."""
    return mm2_mul_words(a, a, wm)


def mm2_exp_words(base, digits, wm, one, win_start: int = 0) -> torch.Tensor:
    """K14's chain in plain PyTorch: K10's chain (``mont.mont_exp_words``:
    the table T[d] = T[d-1] base, then four squarings and one product by
    T[digit] a window from win_start, each a ``cios32_mul``) with m and
    n' from ``wm_modulus`` (n' mod 2^16 as its n0); digits (n_win, B|1).
    Equals ``mm2_exp_plain`` limb for limb."""
    m, np_ = wm_modulus(wm, base.shape[0])
    return mont_exp_words(base, digits, m, np_ & 0xFFFF, one,
                          win_start).to(LIMB_DTYPE)


def mm2_exp_shared_words(base, digits, wm, one, window: int) -> torch.Tensor:
    """K15's chain in plain PyTorch: m from ``wm_modulus`` (its n' taken
    mod 2^16 as ``mont.cios32_mul``'s n0), the table T[0] = one, T[1] =
    base, T[d] = T[d-1] base, acc = one, then per window `window`
    squarings acc * acc and one product by T[digit], each a
    ``cios32_mul``; digits (n_win,).  Equals ``mm2_exp_shared_plain``
    limb for limb."""
    L, B = base.shape
    m, np_ = wm_modulus(wm, L)
    mul = lambda x, y: cios32_mul(x, y, m, np_ & 0xFFFF)
    one = one.expand(L, B)
    table = [one, base]
    for _ in range((1 << window) - 2):
        table.append(mul(table[-1], base))
    acc = one
    for d in torch.as_tensor(digits).reshape(-1).tolist():
        for _ in range(window):
            acc = mul(acc, acc)
        acc = mul(acc, table[d])
    return acc.to(LIMB_DTYPE)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensor -> plain twin; CUDA tensor -> kernel, else raise.
# ---------------------------------------------------------------------------

def mm2_mul(a: torch.Tensor, b: torch.Tensor, wmu: torch.Tensor,
            wm: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod m; a, b (L, B|1) canonical limbs < 2m."""
    if a.device.type == "cpu":
        return mm2_mul_plain(a, b, wmu, wm)
    return _mm2_mul_cuda(a, b, wmu, wm)


def _mm2_mul_cuda(a, b, wmu, wm) -> torch.Tensor:
    L = a.shape[0]
    B = max(a.shape[1], b.shape[1])
    kernels.require_cuda(a, b, wmu, wm)
    w = _weights(wmu, wm, L)
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=a.device)
    kernels.launch("mm2_mul", _cols(a, L, B), _cols(b, L, B), out, *w, L, B)
    return out


def mm2_sqr(a: torch.Tensor, wmu: torch.Tensor,
            wm: torch.Tensor) -> torch.Tensor:
    """a*a*R^-1 mod m; a (L, B) canonical limbs < 2m.  Equals
    ``mm2_mul(a, a, wmu, wm)`` limb for limb."""
    if a.device.type == "cpu":
        return mm2_sqr_plain(a, wmu, wm)
    return _mm2_sqr_cuda(a, wmu, wm)


def _mm2_sqr_cuda(a, wmu, wm) -> torch.Tensor:
    L, B = a.shape
    kernels.require_cuda(a, wmu, wm)
    w = _weights(wmu, wm, L)
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=a.device)
    kernels.launch("mm2_sqr", _cols(a, L, B), out, *w, L, B)
    return out


def mm2_exp(base: torch.Tensor, digits, wmu: torch.Tensor, wm: torch.Tensor,
            one: torch.Tensor, win_start: int = 0) -> torch.Tensor:
    """base^e (Montgomery form) with per-element 4-bit MSB-first digits
    (n_win, B|1) on the host; windows before win_start are skipped."""
    digits = kernels.digit_tensor(digits, 4, base.device)
    if base.device.type == "cpu":
        return mm2_exp_plain(base, digits, wmu, wm, one, win_start)
    return _mm2_exp_cuda(base, digits, wmu, wm, one, win_start)


def _mm2_exp_cuda(base, digits, wmu, wm, one, win_start) -> torch.Tensor:
    L = base.shape[0]
    n_win = digits.shape[0]
    B = max(base.shape[1], digits.shape[1])
    kernels.require_cuda(base, digits, wmu, wm, one)
    w = _weights(wmu, wm, L)
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=base.device)
    kernels.launch("mm2_exp", _cols(base, L, B),
                   digits.expand(n_win, B).contiguous(), _cols(one, L, B),
                   out, *w, L, B, n_win, int(win_start))
    return out


def mm2_exp_shared(base: torch.Tensor, digits, wmu: torch.Tensor,
                   wm: torch.Tensor, one: torch.Tensor,
                   window: int = 5) -> torch.Tensor:
    """base^e (Montgomery form) with one exponent for the batch: digits
    (n_win,) MSB-first base-2^window on the host.  The digit indexes the
    table, as on the TPU (key-derived exponent, ROADMAP C5)."""
    digits = kernels.digit_tensor(digits, window, base.device).reshape(-1)
    if base.device.type == "cpu":
        return mm2_exp_shared_plain(base, digits, wmu, wm, one, window)
    return _mm2_exp_shared_cuda(base, digits, wmu, wm, one, window)


def _mm2_exp_shared_cuda(base, digits, wmu, wm, one, window) -> torch.Tensor:
    L, B = base.shape
    kernels.require_cuda(base, digits, wmu, wm, one)
    w = _weights(wmu, wm, L)
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=base.device)
    # the table in the kernel's own layout: 2^window entries of K words
    # for every thread of the launch
    table = torch.empty((kernels.mm2_exp_shared_table_words(L, B, window),),
                        dtype=LIMB_DTYPE, device=base.device)
    kernels.launch("mm2_exp_shared", _cols(base, L, B), digits,
                   digits.shape[0], _cols(one, L, B), out, table, *w, L, B,
                   window)
    return out


def _cols(x: torch.Tensor, L: int, B: int) -> torch.Tensor:
    return x.to(LIMB_DTYPE).expand(L, B).contiguous()


def _weights(wmu: torch.Tensor, wm: torch.Tensor, L: int) -> tuple:
    """The weights as the kernels read them: contiguous int8 rows of 4L
    bytes, each row read as L 32-bit words (so 4-byte aligned)."""
    if tuple(wmu.shape) != (4 * L, 4 * L) or tuple(wm.shape) != (8 * L,
                                                               4 * L):
        raise ValueError(f"mm2 weights must be (4L, 4L) and (8L, 4L) at "
                         f"L={L}; got {tuple(wmu.shape)}, {tuple(wm.shape)}")
    out = []
    for w in (wmu, wm):
        w = w.to(torch.int8).contiguous()
        if w.data_ptr() % 4:
            w = w.clone()
        out.append(w)
    return tuple(out)
