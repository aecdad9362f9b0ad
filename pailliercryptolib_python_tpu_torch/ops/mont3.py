"""Shared-modulus Montgomery product (K3), per-element modexp (K4),
shared-exponent modexp (K7), square (K8) and squaring chain (K16).

Counterpart of ``pailliercryptolib_python_tpu/ops/pallas_mont3.py``.

* ``mm3_mul(a, b, ctx)`` -- kernel K3 (``csrc/mont3.cu`` over
  ``csrc/mm3_tile.cuh``) on a CUDA tensor, ``mm3_mul_plain`` on a CPU
  tensor.
* ``mm3_exp(base, digits, ctx, win_start)`` -- kernel K4 on a CUDA
  tensor, ``mm3_exp_plain`` on a CPU tensor.
* ``mm3_exp_shared(base, digits, ctx, window)`` -- kernel K7 on a CUDA
  tensor, ``mm3_exp_shared_plain`` on a CPU tensor.
* ``mm3_sqr(a, ctx)`` -- kernel K8 on a CUDA tensor, ``mm3_sqr_plain``
  on a CPU tensor.
* ``mm3_sqr_chain(a, cols, d, ctx)`` -- kernel K16 on a CUDA tensor,
  ``mm3_sqr_chain_plain`` on a CPU tensor.

The plain twins keep the TPU kernel's algorithm: the schoolbook product,
then the Montgomery reduction as two signed-byte Toeplitz matrix products
(q = T*mu mod R, then T + q*m), here as exact float64 matmuls.  K3, K4
and K7 (``csrc/mm3_tile.cuh``: one tile product, or a tile's whole
chain of them) reduce with the same two Toeplitz products, on unsigned
bytes (``tile_weights``) as u8 tensor-core products; ``mm3_mul_tile`` is
the product's arithmetic in plain PyTorch, for the CPU tests.  K8 and
K16 use a CIOS reduction instead.  All give the unique (a*b + q*m)/R with
q = -a*b*m^-1 mod R, so they agree limb for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from .limb import (LIMB_BITS, LIMB_DTYPE, LIMB_MASK, big_mul, h2d, idot,
                   int_to_limbs, normalize)
from .rns_kernels import MMA_K, MMA_M, TILE_COLS, fragment_order
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


def toeplitz_u8(c: int, rows: int, cols: int) -> np.ndarray:
    """uint8 (rows, cols) W[p, i] = byte_{p-i}(c), 0 where p < i: row p
    of W . bytes(x) is byte slot p of x*c (for c < 256^rows)."""
    cb = np.frombuffer(c.to_bytes(rows, "little"), dtype=np.uint8)
    d = np.arange(rows)[:, None] - np.arange(cols)[None, :]
    return np.where(d >= 0, cb[np.clip(d, 0, rows - 1)], 0).astype(np.uint8)


def tile_weights_np(m: int, L: int):
    """K3's reduction matrices as unsigned bytes: W_mu (M1, K) with
    W_mu[p, i] = byte_{p-i}(mu), mu = -m^-1 mod R, for p, i < 2L (lower
    triangular), and W_m (M2, K) with W_m[p, i] = byte_{p-i}(m) for
    p < 4L, i < 2L (a band), zero-padded to M1, M2 (multiples of MMA_M)
    rows and K (a multiple of MMA_K) columns."""
    R = 1 << (LIMB_BITS * L)
    if 4 * m >= R:
        raise ValueError("tile_weights: modulus too large for L")
    mu = (-pow(m, -1, R)) % R
    K = -(-2 * L // MMA_K) * MMA_K
    Wmu = np.zeros((-(-2 * L // MMA_M) * MMA_M, K), dtype=np.uint8)
    Wm = np.zeros((-(-4 * L // MMA_M) * MMA_M, K), dtype=np.uint8)
    Wmu[:2 * L, :2 * L] = toeplitz_u8(mu, 2 * L, 2 * L)
    Wm[:4 * L, :2 * L] = toeplitz_u8(m, 4 * L, 2 * L)
    return Wmu, Wm


def tile_weights(m: int, L: int, device):
    """``tile_weights_np`` in mma fragment order (flat uint8 tensors on
    `device`), what K3 reads; kept on the MontCtx (``wmu_f``, ``wm_f``)
    and never in a cache keyed by the modulus, which is key material."""
    return tuple(torch.from_numpy(fragment_order(W)).to(device)
                 for W in tile_weights_np(m, L))


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


def _slot_limbs(S: torch.Tensor, n: int) -> torch.Tensor:
    """Byte slots S (>= 2n rows) -> the kernel's (n+1, B) limb slots:
    the pair (S_2j, S_2j+1) adds S_2j mod 2^16 + (S_2j+1 mod 2^8) 2^8 to
    limb j and S_2j div 2^16 + S_2j+1 div 2^8 to limb j+1."""
    s0, s1 = S[0:2 * n:2], S[1:2 * n:2]
    D = torch.zeros((n + 1, S.shape[1]), dtype=torch.int64, device=S.device)
    D[:n] += (s0 & LIMB_MASK) + ((s1 & 0xFF) << 8)
    D[1:] += (s0 >> 16) + (s1 >> 8)
    return D


def _bytes_u(x: torch.Tensor, K: int) -> torch.Tensor:
    """(n, B) canonical limbs -> (K, B) little-endian bytes, zero-padded."""
    n, B = x.shape
    out = torch.zeros((K, B), dtype=torch.int64, device=x.device)
    out[0:2 * n:2] = x & 0xFF
    out[1:2 * n:2] = x >> 8
    return out


def mm3_mul_tile(a, b, Wmu, Wm) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch (int64): T = a*b; the slots of
    W_mu . bytes(T_lo) as limbs mod R give q; the slots of W_m . bytes(q)
    plus T, carried, give s; out = s / R.  Wmu, Wm are
    ``tile_weights_np``'s (unsigned, padded).  Equals ``mm3_mul_plain``
    limb for limb."""
    L = a.shape[0]
    K = Wmu.shape[1]
    T = big_mul(a, b, out_limbs=2 * L).to(torch.int64)
    S = torch.matmul(Wmu.to(torch.int64), _bytes_u(T[:L], K))
    q = normalize(_slot_limbs(S, L)[:L]).to(torch.int64)
    U = torch.matmul(Wm.to(torch.int64), _bytes_u(q, K))
    s = normalize(_slot_limbs(U, 2 * L)[:2 * L] + T)
    return s[L:]


def big_sqr(a: torch.Tensor) -> torch.Tensor:
    """Canonical 2L-limb a*a by the symmetric schoolbook product: the
    cross products a_i*a_j (i < j) once, doubled, plus the diagonal (the
    order of the TPU's ``_mm2_square``)."""
    L, B = a.shape
    a = a.to(torch.int64)
    acc = torch.zeros((2 * L, B), dtype=torch.int64, device=a.device)
    for i in range(L - 1):
        p = a[i:i + 1] * a[i + 1:]
        acc[2 * i + 1:i + L] += p & 0xFFFF
        acc[2 * i + 2:i + L + 1] += p >> LIMB_BITS
    acc = acc * 2
    d = a * a
    acc[0::2] += d & 0xFFFF
    acc[1::2] += d >> LIMB_BITS
    return normalize(acc)


def mm3_sqr_plain(a, wmu, wm, off1, off2) -> torch.Tensor:
    """Plain twin of K8: a*a*R^-1 mod m, canonical < 2m in and out."""
    return _mm3_reduce(big_sqr(a), wmu, wm, off1, off2, a.shape[0])


def mm3_sqr_chain_plain(a, cols, d, sqr) -> torch.Tensor:
    """Plain twin of K16: a copy of the (L, B) batch a with column cols[i]
    raised to 2^d[i] by d[i] applications of `sqr` (K8's twin); the other
    columns as they are."""
    out = a.clone()
    cols = torch.as_tensor(cols, dtype=torch.int64, device=a.device)
    d = torch.as_tensor(d, dtype=torch.int64, device=a.device)
    x = a[:, cols]
    for s in range(int(d.max()) if len(d) else 0):
        x = torch.where(d > s, sqr(x), x)
    out[:, cols] = x.to(out.dtype)
    return out


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
    kernels.require_cuda(a, b, ctx.wmu_f, ctx.wm_f)
    L = a.shape[0]
    B = max(a.shape[1], b.shape[1])
    a, b = _cols(a, L, B), _cols(b, L, B)
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=a.device)
    kernels.launch("mm3_mul", a, b, out, ctx.wmu_f, ctx.wm_f, L, B)
    return out


def mm3_exp(base: torch.Tensor, digits, ctx,
            win_start: int = 0) -> torch.Tensor:
    """base^e (Montgomery form) with per-element 4-bit MSB-first digits
    (n_win, B|1) on the host (numpy or a CPU tensor); windows before
    win_start are skipped inside the loop."""
    digits = kernels.digit_tensor(digits, 4, base.device)
    if base.device.type == "cpu":
        return mm3_exp_plain(base, digits, ctx.wmu, ctx.wm, ctx.off1,
                             ctx.off2, ctx.one, win_start)
    return _mm3_exp_cuda(base, digits, ctx, win_start)


def _mm3_exp_cuda(base, digits, ctx, win_start) -> torch.Tensor:
    kernels.require_cuda(base, digits, ctx.wmu_f, ctx.wm_f)
    L = base.shape[0]
    n_win = digits.shape[0]
    B = max(base.shape[1], digits.shape[1])
    base = _cols(base, L, B)
    digits = digits.expand(n_win, B).contiguous()
    one = ctx.one.contiguous()
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=base.device)
    # the table, tile by tile: (tiles, 16, L, TILE_COLS) uint16 limbs
    # (int16 storage)
    table = torch.empty((-(-B // TILE_COLS), 16, L, TILE_COLS),
                        dtype=torch.int16, device=base.device)
    kernels.launch("mm3_exp", base, digits, one, out, table, ctx.wmu_f,
                   ctx.wm_f, L, B, n_win, int(win_start))
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
    kernels.require_cuda(base, digits, ctx.wmu_f, ctx.wm_f)
    L, B = base.shape
    base = _cols(base, L, B)
    one = ctx.one.contiguous()
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=base.device)
    # (tiles, 2^window, L, TILE_COLS) uint16 limbs (int16 storage)
    table = torch.empty((-(-B // TILE_COLS), 1 << window, L, TILE_COLS),
                        dtype=torch.int16, device=base.device)
    kernels.launch("mm3_exp_shared", base, digits, digits.shape[0], one,
                   out, table, ctx.wmu_f, ctx.wm_f, L, B, window)
    return out


def mm3_sqr(a: torch.Tensor, ctx) -> torch.Tensor:
    """a*a*R^-1 mod m (shared m); (L, B) canonical limbs < 2m.  Equals
    ``mm3_mul(a, a, ctx)`` limb for limb."""
    if a.device.type == "cpu":
        return mm3_sqr_plain(a, ctx.wmu, ctx.wm, ctx.off1, ctx.off2)
    return _mm3_sqr_cuda(a, ctx)


def _mm3_sqr_cuda(a, ctx) -> torch.Tensor:
    kernels.require_cuda(a, ctx.n_limbs)
    L, B = a.shape
    a = _cols(a, L, B)
    out = torch.empty((L, B), dtype=LIMB_DTYPE, device=a.device)
    kernels.launch("mm3_sqr", a, out, ctx.n_limbs.contiguous(), ctx.n0inv,
                   L, B)
    return out


def coop_shape(L: int, B: int) -> tuple:
    """(g, K) of the cooperative kernels K8-K16 at L limbs and B columns,
    g lanes a column and K 32-bit words a lane: the rule of
    ``csrc/coop.cuh`` ``coop_shape`` (the least padding g*K where the
    batch fills 132 SMs with 4 warps each, else the least K), for a host
    that has no kernel library; ``kernels.mont_exp_shape`` reads the
    library's, and chip_smoke.py holds the two equal."""
    W = (L + 1) // 2
    pad = lat = None
    for K in (3, 5, 9, 17):
        g = 8
        while g * K < W + 1:
            g *= 2
        if g > 32:
            continue
        if pad is None or g * K < pad[0] * pad[1]:
            pad = (g, K)
        lat = lat or (g, K)
    return pad if B * pad[0] // 32 >= 4 * 132 else lat


def sqr_chain_width(d) -> int:
    """The columns K16's (g, K) is chosen for, given the squarings d of
    its listed columns (not all 0): their mean width sum(d) / max(d), the
    columns a squaring step has on average.  At one d for every column
    that is their count, K8's choice; a chain whose few longest columns
    set its time takes the least K, whose square has the least
    latency."""
    return max(1, -(-int(np.sum(d)) // int(np.max(d))))


def mm3_sqr_chain(a: torch.Tensor, cols, d, ctx) -> torch.Tensor:
    """A copy of the (L, B) batch a (Montgomery form, shared modulus m,
    canonical limbs < 2m) with column cols[i] raised to 2^d[i]: d[i]
    Montgomery squarings, each equal to ``mm3_sqr``.  cols (distinct,
    below B) and d (>= 0) are host integer arrays; list the columns by d
    descending, so that the columns of a warp share one d.  The other
    columns are returned as they are."""
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    d = np.asarray(d, dtype=np.int64).reshape(-1)
    B = a.shape[1]
    if cols.shape != d.shape or cols.size and (
            cols.min() < 0 or cols.max() >= B or d.min() < 0
            or d.max() >= 1 << 31 or np.bincount(cols).max() > 1):
        raise ValueError("mm3_sqr_chain: columns must be distinct and in "
                         "[0, B), each with a count in [0, 2^31)")
    if a.device.type == "cpu":
        if ctx.wmu is not None:
            sqr = lambda x: mm3_sqr_plain(x, ctx.wmu, ctx.wm, ctx.off1,
                                          ctx.off2)
        else:                         # K9's twin: the same unique square
            from . import mont
            sqr = lambda x: mont.mont_mul_p(x, x, ctx.n_limbs, ctx.n0inv)
        return mm3_sqr_chain_plain(a, cols, d, sqr)
    return _mm3_sqr_chain_cuda(a, cols, d, ctx)


def _mm3_sqr_chain_cuda(a, cols, d, ctx) -> torch.Tensor:
    kernels.require_cuda(a, ctx.n_limbs)
    L, B = a.shape
    a = _cols(a, L, B)
    out = a.clone()
    if cols.size and d.max() > 0:
        cd = np.empty((2, cols.size), dtype=np.int32)
        cd[0], cd[1] = cols, d
        kernels.launch("mm3_sqr_chain", a, out,
                       h2d(torch.from_numpy(cd), a.device),
                       ctx.n_limbs.contiguous(), ctx.n0inv, L, B, cols.size,
                       sqr_chain_width(d))
    return out
