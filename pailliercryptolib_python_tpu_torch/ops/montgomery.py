"""Batched Montgomery arithmetic over 16-bit-limb tensors.

Counterpart of ``pailliercryptolib_python_tpu/ops/montgomery.py``:
shared-modulus and per-element-moduli contexts, products, per-element and
shared-exponent modexp, batched inversion, and the fixed-base comb (the
limb encrypt engine).  Values live in the Montgomery domain below 2m
(Walter's bound: R = 2^(16L) > 4m keeps product chains closed without
conditional subtracts).

Dispatch mirrors the JAX package: a context that carries the mm3 byte
weights (a shared modulus of 16..520 limbs on CUDA) routes products
through ``ops/mont3.py`` (kernels K3/K4/K7); a context without them
(``for_moduli``, ``mxu=False``, or L > 520) routes them through
``ops/mont.py`` (kernels K9/K10).  Each wrapper runs its kernel on a
CUDA tensor and its plain twin on a CPU tensor.  Every variant returns
the same limbs: the output (a*b + q*m)/R with q = -a*b*m^-1 mod R is
unique.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .limb import (LIMB_BITS, LIMB_DTYPE, LIMB_MASK, compare_ge, cond_sub,
                   h2d, int_to_limbs, ints_to_limbs, limbs_for_bits,
                   limbs_to_ints, normalize, sub_mod_base, to_device)
from ..device import resolve


@dataclasses.dataclass(frozen=True)
class MontCtx:
    """Montgomery context.  Limb vectors are int32, (L, 1) for a modulus
    shared by the batch or (L, B) for per-element moduli (``for_moduli``).

    wmu/wm/off1/off2 are the mm3 signed-byte Toeplitz weights and folded
    offsets (``ops/mont3.byte_weights``, shared modulus only); the plain
    twin of kernel K3 reduces with them.  wmu_f/wm_f are the same
    reduction's unsigned Toeplitz bytes in mma fragment order
    (``ops/mont3.tile_weights``), what kernel K3 reads; they live on the
    context, never in a cache keyed by the (secret) modulus."""

    n_limbs: torch.Tensor
    n0inv: int | torch.Tensor       # -n^-1 mod 2^16: an int, or (B,)
    r2: torch.Tensor                # R^2 mod n
    one: torch.Tensor               # R mod n
    wmu: torch.Tensor | None = None
    wm: torch.Tensor | None = None
    off1: torch.Tensor | None = None
    off2: torch.Tensor | None = None
    wmu_f: torch.Tensor | None = None
    wm_f: torch.Tensor | None = None

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
        w = (None,) * 6
        if mxu:
            from . import mont3
            w = mont3.byte_weights(n, L, dev) + mont3.tile_weights(n, L, dev)
        col = lambda v: to_device(int_to_limbs(v, L)[:, None], dev)
        return cls(col(n), int(n0inv), col(R * R % n), col(R % n), *w)

    @classmethod
    def for_moduli(cls, ns: list, L: int, device=None) -> "MontCtx":
        """Per-element context over B odd moduli at L limbs: n_limbs, r2
        and one (L, B), n0inv (B,) int32; no mm3 weights."""
        dev = resolve(device)
        R = 1 << (LIMB_BITS * L)
        if any(4 * n >= R for n in ns):
            raise ValueError("MontCtx.for_moduli: modulus too large for L")
        n0 = np.array([(-pow(n, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
                       for n in ns], dtype=np.int32)
        cols = lambda vals: to_device(ints_to_limbs(vals, L), dev)
        return cls(cols(ns), torch.from_numpy(n0).to(dev),
                   cols([R * R % n for n in ns]), cols([R % n for n in ns]))

    @classmethod
    def from_arrays(cls, arrays: dict, device=None) -> "MontCtx":
        """Context from numpy arrays (e.g. the JAX package's MontCtx
        leaves): n_limbs, n0inv, r2, one and optionally the weights.  A
        one-element n0inv becomes an int; a (B,) one stays whole.  With
        the mm3 weights, K3's tile weights are built from the modulus."""
        dev = resolve(device)
        opt = lambda k, dt: (None if arrays.get(k) is None else
                             torch.from_numpy(np.ascontiguousarray(
                                 np.asarray(arrays[k]).astype(dt))).to(dev))
        n0 = np.asarray(arrays["n0inv"]).reshape(-1)
        tile = (None, None)
        if arrays.get("wmu") is not None:
            from . import mont3
            nl = np.asarray(arrays["n_limbs"])
            nl = nl.reshape(nl.shape[0], -1)[:, :1]
            tile = mont3.tile_weights(limbs_to_ints(nl)[0], nl.shape[0], dev)
        return cls(to_device(arrays["n_limbs"], dev),
                   int(n0[0]) if n0.size == 1 else to_device(n0, dev),
                   to_device(arrays["r2"], dev), to_device(arrays["one"], dev),
                   opt("wmu", np.int8), opt("wm", np.int8),
                   opt("off1", np.int32), opt("off2", np.int32), *tile)


def mont_mul(a: torch.Tensor, b: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod n; inputs and output < 2n,
    canonical (L, B) int32 limbs.  a, b may be (L, 1) broadcasts.  K3
    with mm3 weights, else K9 (plain twins on a CPU tensor)."""
    if ctx.wmu is not None:
        from . import mont3
        return mont3.mm3_mul(a, b, ctx)
    from . import mont
    return mont.mont_mul_p(a, b, ctx.n_limbs, ctx.n0inv)


def mont_sqr(a: torch.Tensor, ctx: MontCtx) -> torch.Tensor:
    """Montgomery square, as the product of a with itself (the dedicated
    square kernel K8 is ``mont3.mm3_sqr``)."""
    return mont_mul(a, a, ctx)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   ctx: MontCtx) -> torch.Tensor:
    """The plain CIOS product over the context's modulus (or moduli)."""
    return cios_mul(a, b, ctx.n_limbs, ctx.n0inv)


def cios_mul(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
             n0) -> torch.Tensor:
    """CIOS Montgomery product with carry-save accumulators (port of
    ``_mont_mul_jnp``): L steps, each two (L, B) limb products split in
    halves; carries resolve once at the end.  Accumulators stay < 2^27.
    n is (L, 1) or (L, B); n0 an int or a (1,) / (B,) tensor."""
    L = a.shape[0]
    B = max(a.shape[1], b.shape[1], n.shape[1])
    a = a.to(torch.int64).expand(L, B)
    b = b.to(torch.int64).expand(L, B)
    n = n.to(torch.int64)
    t = torch.zeros((L + 2, B), dtype=torch.int64, device=a.device)
    for i in range(L):
        p = a[i:i + 1] * b
        t[:L] += p & LIMB_MASK
        t[1:L + 1] += p >> LIMB_BITS
        t = _redc_step(t, n, n0, L)
    return normalize(t)[:L]


def _redc_step(t: torch.Tensor, n: torch.Tensor, n0,
               L: int) -> torch.Tensor:
    """One 16-bit REDC step: add m*n so limb 0 is 0 mod 2^16, shift down.
    n0 is an int or a per-column tensor."""
    if isinstance(n0, torch.Tensor):
        n0 = n0.to(torch.int64)
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
    K = T.shape[0]
    B = max(T.shape[1], ctx.n_limbs.shape[1])
    n = ctx.n_limbs.to(torch.int64)
    t = torch.zeros((max(K, L + 2), B), dtype=torch.int64, device=T.device)
    t[:K] = T.to(torch.int64).expand(K, B)
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
    one_plain[0].fill_(1)           # a kernel, not a host copy
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
    B = max(base.shape[1], digits.shape[1], one.shape[1])
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
    """Per-element modexp dispatcher, digits (n_win, B|1) MSB-first on
    the host.  Window 4 runs kernel K4 (``mont3.mm3_exp``) on an mm3
    context and K10 (``mont.mont_exp_p``) otherwise; other windows run
    the plain CIOS chain on the CPU and raise on CUDA."""
    if window == 4:
        if ctx.wmu is not None:
            from . import mont3
            return mont3.mm3_exp(base, digits, ctx, win_start=int(win_start))
        from . import mont
        return mont.mont_exp_p(base, digits, ctx.n_limbs, ctx.n0inv,
                               ctx.one, int(win_start))
    if base.is_cuda:
        raise ValueError(f"mont_exp: no CUDA kernel for window {window}")
    digits = torch.as_tensor(np.asarray(digits, dtype=np.int64))
    return fixed_window_exp(base, digits, ctx.one,
                            lambda x, y: mont_mul_plain(x, y, ctx),
                            window, int(win_start))


def mont_exp_shared(base: torch.Tensor, digits, ctx: MontCtx,
                    window: int = 4) -> torch.Tensor:
    """Shared-exponent modexp dispatcher: digits (n_win,) MSB-first
    base-2^window on the host, one exponent for the batch.  An mm3
    context runs kernel K7 (``mont3.mm3_exp_shared``).  Without weights,
    on CUDA, window 4 becomes the per-element chain (K10) with the digits
    broadcast, other windows raise; on the CPU the plain CIOS chain."""
    if ctx.wmu is not None:
        from . import mont3
        return mont3.mm3_exp_shared(base, digits, ctx, window)
    if base.is_cuda:
        if window != 4:
            raise ValueError(f"mont_exp_shared: no CUDA kernel for window "
                             f"{window} without mm3 weights")
        return mont_exp(base, digits[:, None], ctx, window=4)
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
    u[0].fill_(1)
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
# Fixed-base comb exponentiation (the limb encrypt engine): the DJN base
# hs is fixed per key, so T[j][d] = hs^(d * 2^(w*j)) is built once and an
# obfuscator hs^r costs one product per window and no squarings.
# ---------------------------------------------------------------------------

def build_pow2_ladder(base_mont: torch.Tensor, ctx: MontCtx,
                      nbits: int) -> torch.Tensor:
    """P[t] = base^(2^t) (Montgomery), t < nbits: (nbits, L, B)."""
    out = []
    cur = base_mont
    for _ in range(nbits):
        out.append(cur)
        cur = mont_mul(cur, cur, ctx)
    return torch.stack(out, dim=0)


def _comb_chunk(lad: torch.Tensor, ctx: MontCtx, j_idx: torch.Tensor,
                d_idx: torch.Tensor, window: int) -> torch.Tensor:
    """Comb entries (j_idx, d_idx) as `window` batched products over
    (L, C) columns: entry (j, d) is the product of ladder rows w*j + s
    over the set bits s of d (rows past the ladder clip to its last)."""
    nbits, L = lad.shape
    acc = ctx.one.to(LIMB_DTYPE).expand(L, j_idx.shape[0])
    for s in range(window):
        bit_set = ((d_idx >> s) & 1) == 1                  # (C,)
        src = torch.clamp(window * j_idx + s, 0, nbits - 1)
        factor = lad[src].T                                # (L, C)
        acc = torch.where(bit_set[None, :], mont_mul(acc, factor, ctx), acc)
    return acc


# Columns of one comb-build chunk (the JAX package's compile unit; here
# it bounds the (L, C) working set of one chunk).
COMB_CHUNK_LANES = 32768


def build_comb_table(ladder: torch.Tensor, ctx: MontCtx,
                     window: int) -> torch.Tensor:
    """Comb table T[j, d] = base^(d * 2^(window*j)) from the pow2 ladder
    (nbits, L, 1): (n_win, L, 2^window), entries along the last axis so a
    per-column selection is one index_select.  Every product is K3 (or
    K9 without weights) over chunks of COMB_CHUNK_LANES entries."""
    nbits, L, _ = ladder.shape
    n_win = -(-nbits // window)
    tsize = 1 << window
    dev = ladder.device
    j_all = torch.arange(n_win, device=dev).repeat_interleave(tsize)
    d_all = torch.arange(tsize, device=dev).repeat(n_win)
    lad = ladder[:, :, 0]
    NE = n_win * tsize
    acc = torch.cat([_comb_chunk(lad, ctx, j_all[c0:c0 + COMB_CHUNK_LANES],
                                 d_all[c0:c0 + COMB_CHUNK_LANES], window)
                     for c0 in range(0, NE, COMB_CHUNK_LANES)], dim=1)
    return acc.reshape(L, n_win, tsize).permute(1, 0, 2).contiguous()


def mont_exp_fixed_base(comb: torch.Tensor, digits, ctx: MontCtx,
                        acc0: torch.Tensor | None = None) -> torch.Tensor:
    """prod_j T[j][digits[j]] (times acc0 when given): fixed-base
    exponentiation with no squarings, one gather and one product (K3 or
    K9) per window.  comb (n_win, L, 2^w); digits (n_win, B)
    LSB-window-first, on the host or the device."""
    n_win = comb.shape[0]
    dig = _comb_digits(digits, comb.device)

    def gather(j):
        return torch.index_select(comb[j], 1, dig[j])     # (L, B)

    start = 0
    acc = acc0
    if acc is None:
        acc, start = gather(0), 1
    for j in range(start, n_win):
        acc = mont_mul(acc, gather(j), ctx)
    return acc


def _comb_digits(digits, device) -> torch.Tensor:
    if isinstance(digits, torch.Tensor):
        return digits.to(device).to(torch.int64)
    return h2d(torch.from_numpy(np.asarray(digits, dtype=np.int64)), device)


def mont_exp_fixed_base_chain(comb: torch.Tensor, digits, ctx: MontCtx,
                              acc0: torch.Tensor) -> torch.Tensor:
    """``mont_exp_fixed_base`` in its fused form: every window's factor
    gathered first into one (n_win, L, B) array, then the whole product
    chain in one call (kernel K11, ``mont.mont_chain_p``).  Same limbs as
    the streamed form; it holds n_win*L*B*4 bytes of factors at once."""
    from . import mont
    dig = _comb_digits(digits, comb.device)
    factors = torch.stack([torch.index_select(comb[j], 1, dig[j])
                           for j in range(comb.shape[0])], dim=0)
    return mont.mont_chain_p(factors, acc0, ctx.n_limbs, ctx.n0inv)


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
