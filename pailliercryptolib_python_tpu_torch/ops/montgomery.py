"""Batched Montgomery arithmetic over 16-bit-limb tensors.

Counterpart of ``pailliercryptolib_python_tpu/ops/montgomery.py`` (the
shared-modulus subset the main path runs).  Values live in the
Montgomery domain below 2m (Walter's bound: R = 2^(16L) > 4m keeps
product chains closed without conditional subtracts).

Dispatch mirrors the JAX package: a context that carries the mm3 byte
weights (always the case on CUDA) routes every product through
``ops/mont3.py`` -- kernel K3 on a CUDA tensor, its plain twin on a CPU
tensor -- and a weightless CPU context runs the plain CIOS product.
Every variant returns the same limbs: the output (a*b + q*m)/R with
q = -a*b*m^-1 mod R is unique.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .limb import (LIMB_BITS, LIMB_DTYPE, LIMB_MASK, cond_sub, int_to_limbs,
                   limbs_for_bits, normalize, to_device)
from ..device import resolve


@dataclasses.dataclass(frozen=True)
class MontCtx:
    """Shared-modulus Montgomery context.  Limb vectors are (L, 1) int32.

    wmu/wm/off1/off2 are the mm3 signed-byte Toeplitz weights and folded
    offsets (``ops/mont3.byte_weights``); the plain twin of kernel K3
    reduces with them."""

    n_limbs: torch.Tensor
    n0inv: int                      # -n^-1 mod 2^16
    r2: torch.Tensor                # R^2 mod n
    one: torch.Tensor               # R mod n
    wmu: torch.Tensor | None = None
    wm: torch.Tensor | None = None
    off1: torch.Tensor | None = None
    off2: torch.Tensor | None = None

    MXU_MAX_LIMBS = 520

    @property
    def num_limbs(self) -> int:
        return self.n_limbs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.n_limbs.device

    @classmethod
    def for_modulus(cls, n: int, min_bits: int | None = None,
                    mxu: bool | None = None, device=None) -> "MontCtx":
        """Host-built context for odd n; L sized so R > 4n.  mxu=None
        carries the mm3 weights exactly when the device is CUDA."""
        dev = resolve(device)
        bits = max(n.bit_length() + 2, min_bits or 0)
        L = limbs_for_bits(bits)
        R = 1 << (LIMB_BITS * L)
        n0inv = (-pow(n, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        if mxu is None:
            mxu = dev.type == "cuda" and 16 <= L <= cls.MXU_MAX_LIMBS
        w = (None,) * 4
        if mxu:
            from . import mont3
            w = mont3.byte_weights(n, L, dev)
        col = lambda v: to_device(int_to_limbs(v, L)[:, None], dev)
        return cls(col(n), int(n0inv), col(R * R % n), col(R % n), *w)

    @classmethod
    def from_arrays(cls, arrays: dict, device=None) -> "MontCtx":
        """Context from numpy arrays (e.g. the JAX package's MontCtx
        leaves): n_limbs, n0inv, r2, one and optionally the weights."""
        dev = resolve(device)
        opt = lambda k, dt: (None if arrays.get(k) is None else
                             torch.from_numpy(np.ascontiguousarray(
                                 np.asarray(arrays[k]).astype(dt))).to(dev))
        return cls(to_device(arrays["n_limbs"], dev),
                   int(np.asarray(arrays["n0inv"]).reshape(-1)[0]),
                   to_device(arrays["r2"], dev), to_device(arrays["one"], dev),
                   opt("wmu", np.int8), opt("wm", np.int8),
                   opt("off1", np.int32), opt("off2", np.int32))


def _uses_mm3(x: torch.Tensor, ctx: MontCtx) -> bool:
    if x.is_cuda:
        if ctx.wmu is None:
            raise ValueError("mont_mul: CUDA context built without mm3 "
                             "weights (MontCtx.for_modulus(mxu=False))")
        return True
    return ctx.wmu is not None


def mont_mul(a: torch.Tensor, b: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod n; inputs and output < 2n,
    canonical (L, B) int32 limbs.  a, b may be (L, 1) broadcasts."""
    if _uses_mm3(a, ctx):
        from . import mont3
        return mont3.mm3_mul(a, b, ctx)
    return mont_mul_plain(a, b, ctx)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   ctx: MontCtx) -> torch.Tensor:
    """CIOS Montgomery product with carry-save accumulators (port of
    ``_mont_mul_jnp``): L steps, each two (L, B) limb products split in
    halves; carries resolve once at the end.  Accumulators stay < 2^27."""
    L = a.shape[0]
    B = max(a.shape[1], b.shape[1])
    a = a.to(torch.int64).expand(L, B)
    b = b.to(torch.int64).expand(L, B)
    n = ctx.n_limbs.to(torch.int64)
    t = torch.zeros((L + 2, B), dtype=torch.int64, device=a.device)
    for i in range(L):
        p = a[i:i + 1] * b
        t[:L] += p & LIMB_MASK
        t[1:L + 1] += p >> LIMB_BITS
        t = _redc_step(t, n, ctx.n0inv, L)
    return normalize(t)[:L]


def _redc_step(t: torch.Tensor, n: torch.Tensor, n0: int,
               L: int) -> torch.Tensor:
    """One 16-bit REDC step: add m*n so limb 0 is 0 mod 2^16, shift down."""
    m = ((t[0] & LIMB_MASK) * n0) & LIMB_MASK
    q = m[None, :] * n
    t[:L] += q & LIMB_MASK
    t[1:L + 1] += q >> LIMB_BITS
    carry0 = t[0] >> LIMB_BITS
    t = torch.cat([t[1:], torch.zeros_like(t[:1])], dim=0)
    t[0] += carry0
    return t


def mont_reduce_wide(T: torch.Tensor, ctx: MontCtx,
                     iters: int | None = None) -> torch.Tensor:
    """Montgomery reduction of a wide value: T (K, B) canonical limbs,
    value < n*R -> T*2^(-16*iters) mod n, < 2n, as (L, B).  iters
    defaults to L (the full R^-1); a short reduction (iters=j) is valid
    when T < 2n * 2^(16j)."""
    L = ctx.num_limbs
    K, B = T.shape
    n = ctx.n_limbs.to(torch.int64)
    t = torch.zeros((max(K, L + 2), B), dtype=torch.int64, device=T.device)
    t[:K] = T.to(torch.int64)
    for _ in range(L if iters is None else iters):
        t = _redc_step(t, n, ctx.n0inv, L)
    return normalize(t)[:L]


def to_mont(a: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """a -> a*R mod n (a canonical, < n)."""
    return mont_mul(a, ctx.r2, ctx)


def from_mont(a: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """aR (< 2n) -> a mod n, fully reduced."""
    L = a.shape[0]
    one_plain = torch.zeros((L, 1), dtype=LIMB_DTYPE, device=a.device)
    one_plain[0, 0] = 1
    return cond_sub(mont_mul(a, one_plain, ctx), ctx.n_limbs)


def fixed_window_exp(base: torch.Tensor, digits: torch.Tensor,
                     one: torch.Tensor, mul, window: int = 4,
                     win_start: int = 0) -> torch.Tensor:
    """Per-element fixed-window modexp over the product `mul`.

    base (L, B) Montgomery values; digits (n_win, B) MSB-first base-2^w
    digits; windows before win_start are skipped.  Table T[d] = base^d,
    then per window: w squarings and one product by the gathered entry.
    Returns base^e in Montgomery form."""
    L = base.shape[0]
    B = max(base.shape[1], digits.shape[1])
    base = base.expand(L, B)
    one = one.expand(L, B)
    entries = [one, base]
    for _ in range((1 << window) - 2):
        entries.append(mul(entries[-1], base))
    table = torch.stack(entries, dim=0)                 # (2^w, L, B)
    digits = digits.to(torch.int64).expand(digits.shape[0], B)
    acc = one
    for j in range(win_start, digits.shape[0]):
        for _ in range(window):
            acc = mul(acc, acc)
        idx = digits[j][None, None, :].expand(1, L, B)
        acc = mul(acc, torch.gather(table, 0, idx)[0])
    return acc


def mont_exp(base: torch.Tensor, digits, ctx: MontCtx, window: int = 4,
             win_start: int = 0) -> torch.Tensor:
    """Per-element modexp dispatcher: window 4 on an mm3 context runs
    kernel K4 (``mont3.mm3_exp``); otherwise the plain CIOS chain."""
    if isinstance(digits, np.ndarray):
        digits = torch.from_numpy(digits.astype(np.int32)).to(base.device)
    if _uses_mm3(base, ctx) and window == 4:
        from . import mont3
        return mont3.mm3_exp(base, digits, ctx, win_start=int(win_start))
    if base.is_cuda:
        raise ValueError(f"mont_exp: no CUDA kernel for window {window}")
    return fixed_window_exp(base, digits, ctx.one,
                            lambda x, y: mont_mul_plain(x, y, ctx),
                            window, int(win_start))


# ---------------------------------------------------------------------------
# Host helpers for exponent digit extraction.
# ---------------------------------------------------------------------------

def exponent_digits(exps, n_win: int, window: int,
                    msb_first: bool = True) -> np.ndarray:
    """Base-2^window digits of Python-int exponents -> (n_win, B) uint32
    (port of the JAX package's function, same fast paths)."""
    emask = (1 << (n_win * window)) - 1
    if window not in (4, 8):
        B = len(exps)
        if window <= 16:
            from .. import native
            rbytes = -(-n_win * window // 8) + 4
            buf = b"".join((int(e) & emask).to_bytes(rbytes, "little")
                           for e in exps)
            digs = native.extract_windows(buf, B, rbytes, window, n_win)
            if digs is not None:
                digs = np.ascontiguousarray(digs.astype(np.uint32))
                if msb_first:
                    digs = np.ascontiguousarray(digs[::-1])
                return digs
        out = np.zeros((n_win, B), dtype=np.uint32)
        mask = (1 << window) - 1
        for b, e in enumerate(exps):
            e = int(e)
            for j in range(n_win):
                out[j, b] = (e >> (window * j)) & mask
        if msb_first:
            out = out[::-1]
        return np.ascontiguousarray(out)

    nbytes = -(-n_win * window // 8)
    buf = b"".join((int(e) & emask).to_bytes(nbytes, "little")
                   for e in exps)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(len(exps), nbytes)
    if window == 8:
        digs = arr[:, :n_win]
    else:
        nib = np.empty((len(exps), nbytes * 2), dtype=np.uint8)
        nib[:, 0::2] = arr & 0xF
        nib[:, 1::2] = arr >> 4
        digs = nib[:, :n_win]
    digs = np.ascontiguousarray(digs.T).astype(np.uint32)   # LSB-first
    if msb_first:
        digs = np.ascontiguousarray(digs[::-1])
    return digs
