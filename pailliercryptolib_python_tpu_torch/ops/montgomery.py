"""Batched Montgomery arithmetic over 16-bit-limb tensors.

Counterpart of ``pailliercryptolib_python_tpu/ops/montgomery.py`` (the
shared-modulus subset: products, per-element and shared-exponent modexp,
batched inversion).  Values live in the Montgomery domain below 2m
(Walter's bound: R = 2^(16L) > 4m keeps product chains closed without
conditional subtracts).

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

from .limb import (LIMB_BITS, LIMB_DTYPE, LIMB_MASK, compare_ge, cond_sub,
                   int_to_limbs, limbs_for_bits, limbs_to_ints, normalize,
                   sub_mod_base, to_device)
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


def mont_exp_shared(base: torch.Tensor, digits, ctx: MontCtx,
                    window: int = 4) -> torch.Tensor:
    """Shared-exponent modexp dispatcher: digits (n_win,) MSB-first
    base-2^window, one exponent for the batch.  An mm3 context runs
    kernel K7 (``mont3.mm3_exp_shared``); otherwise the plain CIOS chain."""
    if _uses_mm3(base, ctx):
        from . import mont3
        return mont3.mm3_exp_shared(base, digits, ctx, window)
    if base.is_cuda:
        raise ValueError("mont_exp_shared: no CUDA kernel without mm3 "
                         "weights (per-element moduli: K9/K10)")
    return _mont_exp_shared_plain(base, digits, ctx, window)


def _mont_exp_shared_plain(base, digits, ctx: MontCtx,
                           window: int = 4) -> torch.Tensor:
    """Fixed-window modexp with a shared exponent over the plain CIOS
    product (port of ``_mont_exp_shared_jnp``)."""
    digits = torch.as_tensor(np.asarray(digits, dtype=np.int64)).reshape(
        -1, 1).to(base.device)
    return fixed_window_exp(base, digits, ctx.one,
                            lambda x, y: mont_mul_plain(x, y, ctx), window)


# ---------------------------------------------------------------------------
# Batched modular inverse (the negative-plaintext ct*pt rewrite).
# ---------------------------------------------------------------------------

def _shr1(w: torch.Tensor) -> torch.Tensor:
    """Whole-number right shift by one bit on canonical limbs."""
    hi = torch.cat([w[1:] & 1, torch.zeros_like(w[:1])], dim=0)
    return (w >> 1) | (hi << (LIMB_BITS - 1))


def mont_inv(x_mont: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """Batched inverse of Montgomery residues: a binary extended GCD of a
    fixed 2*16*L + 4 iterations with per-column branch selection
    (invariants a = u*X, b = v*X mod m, X = x*R), then two products by R^2
    back to Montgomery form.  Requires gcd(x, m) == 1."""
    L = ctx.num_limbs
    B = max(x_mont.shape[1], ctx.n_limbs.shape[1])
    dev = x_mont.device
    m = ctx.n_limbs.to(LIMB_DTYPE).expand(L, B)
    a = cond_sub(x_mont.to(LIMB_DTYPE).expand(L, B), m)          # < m
    b = m
    u = torch.zeros((L, B), dtype=LIMB_DTYPE, device=dev)
    u[0] = 1
    v = torch.zeros((L, B), dtype=LIMB_DTYPE, device=dev)

    def half_mod(w):
        """w/2 mod m for w < m: even -> w>>1, odd -> (w+m)>>1."""
        odd = (w[0:1] & 1) == 1
        wm = normalize(w.to(torch.int64) + m)
        return _shr1(torch.where(odd, wm, w))

    def sub_mod_m(p, q):
        """(p - q) mod m for p, q < m: p + (m - q), one conditional subtract."""
        t = normalize(p.to(torch.int64) + sub_mod_base(m, q))
        return cond_sub(t, m)

    for _ in range(2 * LIMB_BITS * L + 4):
        a_odd = (a[0:1] & 1) == 1
        lt = torch.logical_not(compare_ge(a, b))[None, :]        # a < b
        na, nb = torch.where(lt, b, a), torch.where(lt, a, b)
        nu, nv = torch.where(lt, v, u), torch.where(lt, u, v)
        a_n = torch.where(a_odd, _shr1(sub_mod_base(na, nb)), _shr1(a))
        u_n = torch.where(a_odd, half_mod(sub_mod_m(nu, nv)), half_mod(u))
        b_n = torch.where(a_odd, nb, b)
        v_n = torch.where(a_odd, nv, v)
        done = (a == 0).all(dim=0)[None, :]      # b holds gcd, v the inverse
        a = torch.where(done, a, a_n)
        b = torch.where(done, b, b_n)
        u = torch.where(done, u, u_n)
        v = torch.where(done, v, v_n)
    inv_plain = mont_mul(v, ctx.r2, ctx)       # v = x^-1 R^-1 -> x^-1
    return mont_mul(inv_plain, ctx.r2, ctx)    # -> x^-1 R


def _inv_tree_up(x_mont: torch.Tensor, ctx: MontCtx) -> list:
    """Pairwise Montgomery product tree (up-sweep); all levels."""
    levels = [x_mont]
    cur = x_mont
    while cur.shape[1] > 1:
        cur = mont_mul(cur[:, 0::2], cur[:, 1::2], ctx)
        levels.append(cur)
    return levels


def _inv_tree_down(levels: list, inv_root: torch.Tensor,
                   ctx: MontCtx) -> torch.Tensor:
    """Down-sweep: inv(left) = inv(parent)*right and vice versa."""
    inv = inv_root
    for lvl in levels[-2::-1]:
        L = lvl.shape[0]
        left, right = lvl[:, 0::2], lvl[:, 1::2]
        inv_left = mont_mul(inv, right, ctx)
        inv_right = mont_mul(inv, left, ctx)
        inv = torch.stack([inv_left, inv_right], dim=2).reshape(
            L, lvl.shape[1])
    return inv


def _pad_pow2(x_mont: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """Pad the batch to a power of two with the Montgomery one."""
    L, B = x_mont.shape
    P2 = 1 << max(0, (B - 1).bit_length())
    if P2 == B:
        return x_mont
    return torch.cat([x_mont, ctx.one.to(x_mont.dtype).expand(L, P2 - B)],
                     dim=1)


def mont_inv_tree_hostroot(x_mont: torch.Tensor, ctx: MontCtx,
                           m_int: int) -> torch.Tensor:
    """Batched inverse by Montgomery's product tree, with the root
    inverted on the host by ``pow(r, -1, m)``; every product is kernel K3
    on CUDA.  Every column must be a unit mod m."""
    L, B = x_mont.shape
    levels = _inv_tree_up(_pad_pow2(x_mont, ctx), ctx)
    r = limbs_to_ints(levels[-1][:, :1])[0] % m_int     # rep of P: P*R
    R = 1 << (LIMB_BITS * L)
    inv_rep = pow(r, -1, m_int) * (R * R % m_int) % m_int   # P^-1 * R
    inv0 = to_device(int_to_limbs(inv_rep, L)[:, None], x_mont.device)
    return _inv_tree_down(levels, inv0, ctx)[:, :B]


def mont_inv_tree(x_mont: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """Batched inverse by Montgomery's product tree with the root
    inverted on the device by ``mont_inv``."""
    B = x_mont.shape[1]
    levels = _inv_tree_up(_pad_pow2(x_mont, ctx), ctx)
    return _inv_tree_down(levels, mont_inv(levels[-1], ctx), ctx)[:, :B]


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
