"""RNS-Montgomery modular arithmetic (PyTorch).

Counterpart of ``pailliercryptolib_python_tpu/ops/rns.py``; the number
system is the same (see that module and ``docs/RNS_DESIGN.md``).  Values
live as residues over two bases of 16-bit prime channels B, B' plus one
redundant channel; states are (CH, batch) with CH = 2k+1, rows
[B | B' | m_r].  One RNS-Montgomery product maps (x, y) -> x*y*M^-1 with
a Bajard-fast first base extension and a Shenoy-Kumaresan exact second.

The host construction is ported verbatim (numpy).  The arithmetic here
is the plain torch path: every function computes in int64 and returns
int32 residues/limbs.  The uint32 wrap-around that the JAX code relies on
is reproduced with ``& MASK32`` exactly where it happens:
``_cmul_shoup`` (a*c - q*m) and ``_combine_planes`` (u = A * -m^-1 mod
2^32, whose 64-bit product is split so int64 never overflows).

The byte-plane dot products (``_plane_dots``, ``_plane_dots_dual``) are
exact float64 matmuls of the uncentred byte planes: every sum is below
2^31 < 2^53, and the integers equal the centred-int8 results of the JAX
code (``_plane_dots`` asserts the bound).  torch refuses integer matmul
on CUDA.

On a CUDA tensor every RNS product goes through kernel K1, the decrypt
chain through K2 (sliding window) or K6 (fixed window) and the
per-element ct*pt chain through K5 (``ops/rns_kernels.py``); the chain
functions below call those wrappers.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .limb import (LIMB_BITS, LIMB_DTYPE, MASK32, idot, int_to_limbs,
                   limbs_for_bits, normalize, sub_mod_base)
from . import montgomery as mg
from ..device import resolve

MASK16 = 0xFFFF
I64 = torch.int64


# ---------------------------------------------------------------------------
# Host-side construction.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _primes_desc():
    """All primes below 2^16, largest first."""
    limit = 1 << 16
    s = np.ones(limit, dtype=bool)
    s[:2] = False
    for i in range(2, 256):
        if s[i]:
            s[i * i::i] = False
    return [int(p) for p in np.nonzero(s)[0][::-1]]


def _channels_for(mbits: int):
    """k and the channel lists for a modulus of `mbits` bits, with
    M, M' >= (k+2)^2 * 2^mbits (closure bound of the fast extension)."""
    primes = _primes_desc()
    k = 0
    while True:
        k += 1
        need = mbits + 2 * (k + 2).bit_length()
        logMk = sum(float(np.log2(primes[2 * i])) for i in range(k))
        if logMk >= need + 1:
            break
    mods_B = [primes[2 * i] for i in range(k)]
    mods_Bp = [primes[2 * i + 1] for i in range(k)]
    m_r = primes[2 * k]
    M = 1
    for p in mods_B:
        M *= p
    Mp = 1
    for p in mods_Bp:
        Mp *= p
    assert M >= (k + 2) ** 2 << mbits and Mp >= (k + 2) ** 2 << mbits
    assert m_r > 2 * (k + 2)
    return k, mods_B, mods_Bp, m_r, M, Mp


def _byte_planes(mat: np.ndarray):
    """(out, k) 16-bit entries -> (lo, hi) int32 byte-plane matrices."""
    return (mat & 0xFF).astype(np.int32), (mat >> 8).astype(np.int32)


def _shoup_pair(c_int, m_int):
    """(c mod m, floor(c * 2^16 / m)) for _cmul_shoup."""
    c = c_int % m_int
    return c, (c << 16) // m_int


# Field order of the per-base arrays (RnsBase tensor fields).
_BASE_ARRAYS = ("mods", "n0", "n032", "C1_lo", "C1_hi", "C2_lo", "C2_hi",
                "W_lo", "W_hi", "K1g", "K2g", "exit_c", "K2s", "K2sh",
                "K1gs", "K1gsh", "D1_lo", "D1_hi", "D2_lo", "D2_hi")


@lru_cache(maxsize=8)
def base_arrays_np(mbits: int) -> dict:
    """Key-independent RNS constants for moduli up to 2^mbits (numpy),
    plus the ints k, M, Mp, m_r, mods_B_int, mods_Bp_int."""
    k, mods_B, mods_Bp, m_r, M, Mp = _channels_for(mbits)
    all_mods = mods_B + mods_Bp + [m_r]
    col = lambda v: np.array(v, dtype=np.uint32)[:, None]
    mods = col(all_mods)
    n0 = col([(-pow(m, -1, 1 << 16)) % (1 << 16) for m in all_mods])
    n032 = col([(-pow(m, -1, 1 << 32)) % (1 << 32) for m in all_mods])
    tgt1 = mods_Bp + [m_r]
    C1 = np.zeros((k + 1, k), dtype=np.uint32)
    for i, mi in enumerate(mods_B):
        Mi = M // mi
        for j, mj in enumerate(tgt1):
            C1[j, i] = Mi % mj
    tgt2 = mods_B + [m_r]
    C2 = np.zeros((k + 1, k), dtype=np.uint32)
    for i, mi in enumerate(mods_Bp):
        Mi = Mp // mi
        for j, mj in enumerate(tgt2):
            C2[j, i] = Mi % mj
    L_W = limbs_for_bits(M.bit_length()) + 1
    W = np.zeros((L_W, k), dtype=np.uint32)
    for i, mi in enumerate(mods_B):
        W[:, i] = int_to_limbs(M // mi, L_W)
    K1g = col([pow((M // mi) % mi, -1, mi) for mi in mods_B])
    K2g = col([pow((Mp // mj) % mj, -1, mj) for mj in mods_Bp])
    # exit_c[0] carries 2^32 (the combine leaves Zh at scale 2^-16).
    exit_c = col([(1 << 32) % m_r * pow(Mp % m_r, -1, m_r) % m_r,
                  pow(Mp % m_r, -1, m_r), 1])
    assert int(exit_c[0, 0]) * Mp % m_r == (1 << 32) % m_r
    # plane accumulators S_A/S_B < 2k*255^2 must fit int32
    assert 2 * k * 255 * 255 < (1 << 31)

    def shoup_col(vals, mlist):
        pairs = [_shoup_pair(int(v) * pow(1 << 16, -1, mi), mi)
                 for v, mi in zip(vals[:, 0], mlist)]
        return col([p[0] for p in pairs]), col([p[1] for p in pairs])

    K2s, K2sh = shoup_col(K2g, mods_Bp)
    K1gs, K1gsh = shoup_col(K1g, mods_B)
    tmods1 = np.array(tgt1, dtype=np.uint64)[:, None]
    tmods2 = np.array(tgt2, dtype=np.uint64)[:, None]
    D1 = ((C1.astype(np.uint64) << 8) % tmods1).astype(np.uint32)
    D2 = ((C2.astype(np.uint64) << 8) % tmods2).astype(np.uint32)
    C1_lo, C1_hi = _byte_planes(C1)
    C2_lo, C2_hi = _byte_planes(C2)
    D1_lo, D1_hi = _byte_planes(D1)
    D2_lo, D2_hi = _byte_planes(D2)
    W_lo, W_hi = _byte_planes(W)
    arrs = dict(mods=mods, n0=n0, n032=n032, C1_lo=C1_lo, C1_hi=C1_hi,
                C2_lo=C2_lo, C2_hi=C2_hi, W_lo=W_lo, W_hi=W_hi, K1g=K1g,
                K2g=K2g, exit_c=exit_c, K2s=K2s, K2sh=K2sh, K1gs=K1gs,
                K1gsh=K1gsh, D1_lo=D1_lo, D1_hi=D1_hi, D2_lo=D2_lo,
                D2_hi=D2_hi)
    ints = dict(k=k, M=M, Mp=Mp, m_r=m_r, mods_B_int=tuple(mods_B),
                mods_Bp_int=tuple(mods_Bp))
    return dict(arrs, **ints)


def _t64(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


@dataclasses.dataclass(frozen=True)
class RnsBase:
    """Key-independent RNS configuration; tensor fields are int64 (small
    constant vectors and byte planes)."""

    mbits: int
    k: int
    M: int
    Mp: int
    m_r: int
    mods_B_int: tuple
    mods_Bp_int: tuple
    mods: torch.Tensor
    n0: torch.Tensor
    n032: torch.Tensor
    C1_lo: torch.Tensor
    C1_hi: torch.Tensor
    C2_lo: torch.Tensor
    C2_hi: torch.Tensor
    W_lo: torch.Tensor
    W_hi: torch.Tensor
    K1g: torch.Tensor
    K2g: torch.Tensor
    exit_c: torch.Tensor
    K2s: torch.Tensor
    K2sh: torch.Tensor
    K1gs: torch.Tensor
    K1gsh: torch.Tensor
    D1_lo: torch.Tensor
    D1_hi: torch.Tensor
    D2_lo: torch.Tensor
    D2_hi: torch.Tensor

    @property
    def CH(self):
        return 2 * self.k + 1

    @property
    def L_W(self):
        return limbs_for_bits(self.M.bit_length()) + 1

    @property
    def device(self):
        return self.mods.device

    @classmethod
    def for_bits(cls, mbits: int, device=None) -> "RnsBase":
        return _base_for(mbits, resolve(device))


@lru_cache(maxsize=8)
def _base_for(mbits: int, device: torch.device) -> RnsBase:
    a = base_arrays_np(mbits)
    return RnsBase(mbits, a["k"], a["M"], a["Mp"], a["m_r"], a["mods_B_int"],
                   a["mods_Bp_int"], *[_t64(a[n], device)
                                       for n in _BASE_ARRAYS])


# Field order of the per-(key, modulus) vectors.
KEY_ARRAYS = ("K1s", "K1sh", "u5", "v5", "w9n", "w9b", "y_enter", "c_enter",
              "K3", "k4_limbs", "one_ch", "k5_limbs")


@dataclasses.dataclass
class RnsModulus:
    """Per-(key, modulus) constant vectors for one modulus m (n^2, p^2 or
    q^2).  k4_limbs/k5_limbs are (L, 1) limbs for the exit fold; the rest
    are (rows, 1) channel vectors.  `packed` holds the kernels' operand
    bundle (``rns_kernels.pack``) when it was supplied from outside;
    `_dev_ops` memoizes its device copy."""

    m: int
    K1s: torch.Tensor
    K1sh: torch.Tensor
    u5: torch.Tensor
    v5: torch.Tensor
    w9n: torch.Tensor
    w9b: torch.Tensor
    y_enter: torch.Tensor
    c_enter: torch.Tensor
    K3: torch.Tensor
    k4_limbs: torch.Tensor
    one_ch: torch.Tensor
    k5_limbs: torch.Tensor
    packed: dict | None = None
    _dev_ops: dict | None = dataclasses.field(default=None, repr=False)

    @classmethod
    def build(cls, base: RnsBase, m: int, L: int) -> "RnsModulus":
        return cls.from_arrays(m, modulus_arrays_np(base.mbits, m, L),
                               base.device)

    @classmethod
    def from_arrays(cls, m: int, arrays: dict, device,
                    packed: dict | None = None) -> "RnsModulus":
        return cls(m, *[_t64(arrays[n], device) for n in KEY_ARRAYS],
                   packed=packed)


def modulus_arrays_np(mbits: int, m: int, L: int) -> dict:
    """All RnsModulus vectors for modulus m (numpy)."""
    a = base_arrays_np(mbits)
    assert m.bit_length() <= mbits and m % 2 == 1
    v = modulus_vectors(mbits, m)
    R = 1 << (LIMB_BITS * L)
    M = a["M"]
    y = M * M % m * pow(R, -1, m) % m
    all_mods = list(a["mods_B_int"]) + list(a["mods_Bp_int"]) + [a["m_r"]]
    col = lambda vals: np.array(vals, dtype=np.uint32)[:, None]
    y_enter = col([(y % mc) * (1 << 16) % mc for mc in all_mods])
    c_enter = col([pow(2, 64, mc) for mc in all_mods])
    ej = _exit_redc_iters(a["k"], M, mbits, L)
    k4 = pow(R, 2, m) * pow(2, 16 * ej, m) % m * pow(M % m, -1, m) % m
    k5 = pow(R, 3, m) * pow(2, 16 * ej, m) % m * pow(M % m, -1, m) % m
    Mm = M % m
    one_ch = col([(Mm % mc) * (1 << 16) % mc for mc in all_mods])
    return dict(K1s=v["K1s"], K1sh=v["K1sh"], u5=v["u5"], v5=v["v5"],
                w9n=v["w9n"], w9b=v["w9b"], y_enter=y_enter, c_enter=c_enter,
                K3=a["K1g"], k4_limbs=int_to_limbs(k4, L)[:, None],
                one_ch=one_ch, k5_limbs=int_to_limbs(k5, L)[:, None])


def modulus_vectors(mbits: int, m: int) -> dict:
    """Per-(base, m) channel constant vectors (numpy).  Not memoized: m
    is key material (p^2, q^2 or n^2); per-key constants live only on
    the key (``RnsModulus``)."""
    a = base_arrays_np(mbits)
    M, Mp, m_r = a["M"], a["Mp"], a["m_r"]
    mods_B, mods_Bp = a["mods_B_int"], a["mods_Bp_int"]
    col = lambda vals: np.array(vals, dtype=np.uint32)[:, None]
    minv_M = [(-pow(m, -1, mi)) % mi for mi in mods_B]
    K1 = col([minv_M[i] * pow((M // mi) % mi, -1, mi) % mi
              for i, mi in enumerate(mods_B)])
    k1p = [_shoup_pair(int(K1[i, 0]) * pow(1 << 16, -1, mi), mi)
           for i, mi in enumerate(mods_B)]
    K1s = col([p[0] for p in k1p])
    K1sh = col([p[1] for p in k1p])
    tgt = list(mods_Bp) + [m_r]
    u5 = col([pow(M % mj, -1, mj) * (1 << 16) % mj for mj in tgt])
    v5 = col([(m % mj) * pow(M % mj, -1, mj) % mj * pow(2, 48, mj) % mj
              for mj in tgt])
    w9a = col([(Mp % mi) * pow(1 << 16, -1, mi) % mi for mi in mods_B])
    w9b = col([pow(2, 48, mi) for mi in mods_B])
    w9n = col([(-int(w9a[i, 0]) * pow(2, 64, mi) * pow(1 << 16, -1, mi)) % mi
               for i, mi in enumerate(mods_B)])
    return {"K1": K1, "K1s": K1s, "K1sh": K1sh, "u5": u5, "v5": v5,
            "w9a": w9a, "w9b": w9b, "w9n": w9n}


# ---------------------------------------------------------------------------
# Channel primitives (elementwise; int64 in, int64 out).
# ---------------------------------------------------------------------------

def _csub(r, mods):
    """One conditional subtract (r < 2m -> < m)."""
    return torch.where(r >= mods, r - mods, r)


def _carry16(tl):
    """Carry of tl + (u*m mod 2^16) in a 16-bit REDC: exactly (tl != 0)."""
    return (tl != 0).to(I64)


def _cmul(a, b, mods, n0):
    """Channel product with 16-bit REDC: a*b*2^-16 mod m, output < m."""
    t = a * b
    tl = t & MASK16
    u = (tl * n0) & MASK16
    um = u * mods
    return _csub((t >> 16) + (um >> 16) + _carry16(tl), mods)


def _redc(t, mods, n0):
    """t * 2^-16 mod m for any t < 2^32; output < m."""
    tl = t & MASK16
    u = (tl * n0) & MASK16
    um = u * mods
    r = (t >> 16) + (um >> 16) + _carry16(tl)
    return _csub(_csub(r, mods), mods)


def _cmul_shoup(a, c, ch, mods):
    """a*c mod m for a constant c with companion ch = floor(c 2^16 / m):
    q = (a*ch) >> 16, r = a*c - q*m wrapped to uint32 (the JAX code's
    uint32 wrap; the true r is in [0, 2m))."""
    q = (a * ch) >> 16
    r = (a * c - q * mods) & MASK32
    return _csub(r, mods)


def _cmul2(a, b, c, d, mods, n0):
    """Paired channel product (a*b + c*d) * 2^-16 mod m, output < m."""
    P = a * b
    Q = c * d
    lo = (P & MASK16) + (Q & MASK16)
    hi = (P >> 16) + (Q >> 16)
    ll = lo & MASK16
    u = (ll * n0) & MASK16
    um = u * mods
    r = hi + (lo >> 16) + (um >> 16) + _carry16(ll)
    return _csub(_csub(r, mods), mods)


def _submod(a, b, mods):
    """(a - b) mod m for a, b < m."""
    return torch.where(a >= b, a - b, a + mods - b)


def _plane_dots(x, W_lo, W_hi):
    """16-bit digits x (k_in, B) against (out, k_in) byte planes ->
    (S00, mid, S11) with the true dot = S00 + 2^8 mid + 2^16 S11."""
    k_in = x.shape[0]
    assert 2 * k_in * 255 * 255 < (1 << 31)
    x = x.to(I64)
    x0, x1 = x & 0xFF, x >> 8
    return idot(W_lo, x0), idot(W_lo, x1) + idot(W_hi, x0), idot(W_hi, x1)


def _plane_dots_dual(x, C_lo, C_hi, D_lo, D_hi):
    """S_A = C_lo.x0 + D_lo.x1 and S_B = C_hi.x0 + D_hi.x1, with
    D = 2^8 C mod m pre-folded: the true dot is S_A + 2^8 S_B."""
    x = x.to(I64)
    x0, x1 = x & 0xFF, x >> 8
    return (idot(C_lo, x0) + idot(D_lo, x1),
            idot(C_hi, x0) + idot(D_hi, x1))


def _combine_dual(S_A, S_B, mods, n0, nlev: int):
    """(S_A + 2^8 S_B) * 2^-16 mod m, < m: one 16-bit REDC of
    t = S_A + (S_B mod 2^8) << 8, plus B1 = S_B >> 8, then an nlev-level
    binary conditional-subtract chain."""
    t = S_A + ((S_B & 0xFF) << 8)
    B1 = S_B >> 8
    tl = t & MASK16
    u = (tl * n0) & MASK16
    um = u * mods
    r = (t >> 16) + (um >> 16) + _carry16(tl) + B1
    for lev in range(nlev - 1, -1, -1):
        mm = mods << lev
        r = torch.where(r >= mm, r - mm, r)
    return r


@lru_cache(maxsize=8)
def combine_levels(mbits: int) -> int:
    """Depth of _combine_dual's subtract chain at this base."""
    a = base_arrays_np(mbits)
    k = a["k"]
    mods = list(a["mods_B_int"]) + list(a["mods_Bp_int"]) + [a["m_r"]]
    t_max = 2 * k * 255 * 255 + 255 * 256
    r_max = t_max // (1 << 16) + max(mods) + 1 + (2 * k * 255 * 255) // 256
    ratio = -(-r_max // min(mods))
    return max(1, (ratio - 1).bit_length())


def _combine_planes(S00, mid, S11, mods, n032):
    """Byte-plane sums -> (true value)*2^-32 mod m, < m, by one radix-2^32
    Montgomery pass.  u = A * -m^-1 mod 2^32 is the JAX code's wrapping
    uint32 expression t*n032 + ((B1*n032) << 16); here n032 is split in
    16-bit halves so every int64 product stays below 2^49."""
    lo = mid & ((1 << 23) - 1)
    hi = mid >> 23
    t = S00 + (lo << 8)
    B1 = (hi << 15) + S11
    n_lo, n_hi = n032 & MASK16, n032 >> 16
    u = (t * n_lo + ((((t * n_hi) + (B1 * n_lo)) & MASK16) << 16)) & MASK32
    A2 = (u & MASK16) * mods
    Bm = (u >> 16) * mods
    C1 = (t >> 16) + (A2 >> 16) + _carry16(t & MASK16)
    r = ((C1 >> 16) + (B1 >> 16) + (Bm >> 16)
         + (((C1 & MASK16) + (B1 & MASK16) + (Bm & MASK16)) >> 16))
    return _csub(r, mods)


# ---------------------------------------------------------------------------
# The RNS-Montgomery multiplication (plain twin of kernel K1).
# ---------------------------------------------------------------------------

def rns_mont_mul(X, Y, base: RnsBase, key: RnsModulus):
    """One RNS-Montgomery product: states (CH, B) -> state of x*y*M^-1.
    Inputs/outputs are channel-Montgomery residues of values < (k+2)m."""
    k = base.k
    nlev = combine_levels(base.mbits)
    mods, n0 = base.mods, base.n0
    mB, n0B = mods[:k], n0[:k]
    mT, n0T = mods[k:], n0[k:]                          # B' ++ m_r
    mR, n0R = mods[2 * k:], n0[2 * k:]
    X, Y = X.to(I64), Y.to(I64)

    S = _cmul(X, Y, mods, n0)
    xi = _cmul_shoup(S[:k], key.K1s, key.K1sh, mB)
    S_A, S_B = _plane_dots_dual(xi, base.C1_lo, base.C1_hi,
                                base.D1_lo, base.D1_hi)
    Q = _combine_dual(S_A, S_B, mT, n0T, nlev)
    Rp = _cmul2(S[k:], key.u5, Q, key.v5, mT, n0T)
    xip = _cmul_shoup(Rp[:k], base.K2s, base.K2sh, mods[k:2 * k])
    T_A, T_B = _plane_dots_dual(xip, base.C2_lo, base.C2_hi,
                                base.D2_lo, base.D2_hi)
    tgt_m = torch.cat([mB, mR], dim=0)
    tgt_n0 = torch.cat([n0B, n0R], dim=0)
    Zh = _combine_dual(T_A, T_B, tgt_m, tgt_n0, nlev)
    a = _cmul(Zh[k:], base.exit_c[0:1], mR, n0R)        # r_hat * M'^-1
    b = _cmul(Rp[k:], base.exit_c[1:2], mR, n0R)        # r'    * M'^-1
    delta = _submod(a, b, mR)                           # true, < k
    Z = _cmul2(Zh[:k], key.w9b, delta.expand(k, delta.shape[1]), key.w9n,
               mB, n0B)
    return torch.cat([Z, Rp], dim=0).to(LIMB_DTYPE)


# ---------------------------------------------------------------------------
# Positional <-> RNS conversions.
# ---------------------------------------------------------------------------

def residue_fold_limbs(T, C_lo, C_hi, Lh: int):
    """(K, B) canonical limbs of X -> (Lh+2, B) canonical limbs of
    V = X (mod m), V < m * 2^(16 + log2 K), via one byte-plane matmul
    group against C[j, l] = limb j of 2^(16l) mod m."""
    S00, mid, S11 = _plane_dots(T, C_lo, C_hi)
    lo = mid & ((1 << 23) - 1)
    hi = mid >> 23
    arr = torch.zeros((Lh + 2, T.shape[1]), dtype=I64, device=T.device)
    arr[:Lh] = S00 + (lo << 8)
    arr[1:Lh + 1] += (hi << 15) + S11
    return normalize(arr)


def _residue_planes_np(m: int, Lh: int, K: int):
    """Byte planes of C[j, l] = limb j of (2^(16l) mod m) (numpy).  Not
    memoized: m is key material (p^2 or q^2)."""
    C = np.zeros((Lh, K), dtype=np.uint32)
    for l in range(K):
        C[:, l] = int_to_limbs(pow(2, 16 * l, m), Lh)
    return _byte_planes(C)


@lru_cache(maxsize=16)
def _enter_planes_np(mbits: int, L: int):
    """Byte planes of P[c, l] = 2^(16l) mod m_c (numpy)."""
    a = base_arrays_np(mbits)
    all_mods = list(a["mods_B_int"]) + list(a["mods_Bp_int"]) + [a["m_r"]]
    P = np.zeros((len(all_mods), L), dtype=np.uint32)
    for c, mc in enumerate(all_mods):
        for l in range(L):
            P[c, l] = pow(2, 16 * l, mc)
    return _byte_planes(P)


@lru_cache(maxsize=16)
def _enter_planes(mbits: int, L: int, device: torch.device):
    """_enter_planes_np on `device` (key-independent; held there so an
    enter copies nothing from the host)."""
    return tuple(_t64(p, device) for p in _enter_planes_np(mbits, L))


@lru_cache(maxsize=8)
def _M_limbs(mbits: int, device: torch.device) -> torch.Tensor:
    """(L_W, 1) limbs of the base product M on `device`."""
    a = base_arrays_np(mbits)
    L_W = limbs_for_bits(a["M"].bit_length()) + 1
    return _t64(int_to_limbs(a["M"], L_W)[:, None], device)


def rns_enter(v_limbs, base: RnsBase, key: RnsModulus):
    """(L, B) positional limbs of v (< 2m) -> RNS state of v*M*R^-1
    (one residue matmul + one RNS product, kernel K1 on CUDA)."""
    from . import rns_kernels
    P_lo, P_hi = _enter_planes(base.mbits, v_limbs.shape[0], v_limbs.device)
    S00, mid, S11 = _plane_dots(v_limbs, P_lo, P_hi)
    V = _combine_planes(S00, mid, S11, base.mods, base.n032)
    V = _cmul(V, key.c_enter, base.mods, base.n0).to(LIMB_DTYPE)
    return rns_kernels.rns_mul(V, key.y_enter.to(LIMB_DTYPE).expand_as(V),
                               base, key)


def exit_redc_iters(base: RnsBase, L: int) -> int:
    return _exit_redc_iters(base.k, base.M, base.mbits, L)


def _exit_redc_iters(k: int, M: int, mbits: int, L: int) -> int:
    """REDC steps of the short SK-exit reduction (see the JAX package)."""
    j1 = -(-((k * M).bit_length() - (mbits - 16) + 2) // 16)
    j2 = limbs_for_bits(M.bit_length()) + 1 - L
    return max(j1, j2, 1)


def _exit_limbs(Z, base: RnsBase):
    """SK-CRT reconstruction of the state's integer value z~ < kM into
    positional limbs (L_W, B)."""
    k = base.k
    mods, n0 = base.mods, base.n0
    mR, n0R = mods[2 * k:], n0[2 * k:]
    Z = Z.to(I64)
    a = base_arrays_np(base.mbits)

    xi = _cmul_shoup(Z[:k], base.K1gs, base.K1gsh, mods[:k])
    S00, mid, S11 = _plane_dots(xi, base.W_lo, base.W_hi)
    lo = mid & ((1 << 23) - 1)
    hi = mid >> 23
    up = (hi << 15) + S11
    up = torch.cat([torch.zeros_like(up[:1]), up[:-1]], dim=0)
    r_hat = normalize(S00 + (lo << 8) + up)
    R00, rmid, R11 = _plane_dots(xi, base.C1_lo[k:k + 1],
                                 base.C1_hi[k:k + 1])
    rr = _combine_planes(R00, rmid, R11, mR, base.n032[2 * k:])
    c48 = pow(2, 48, a["m_r"])
    cMinv16 = pow(a["M"] % a["m_r"], -1, a["m_r"]) * (1 << 16) % a["m_r"]
    rr = _cmul(rr, c48, mR, n0R)                        # true r_hat mod m_r
    z_r = _cmul(Z[2 * k:], base.exit_c[2:3], mR, n0R)   # true z~ mod m_r
    delta = _cmul(_submod(rr, z_r, mR), cMinv16, mR, n0R)   # < k
    dM = normalize(_M_limbs(base.mbits, Z.device) * delta)
    return sub_mod_base(r_hat, dM)


def rns_exit(Z, base: RnsBase, key: RnsModulus, sq_ctx, L: int):
    """State of c^e * M -> canonical limbs of c^e mod m."""
    z_limbs = _exit_limbs(Z, base)
    t = mg.mont_reduce_wide(z_limbs, sq_ctx, iters=exit_redc_iters(base, L))
    u = mg.mont_mul(t, key.k4_limbs.to(LIMB_DTYPE), sq_ctx)
    return mg.from_mont(u, sq_ctx)


# ---------------------------------------------------------------------------
# Sliding-window shared-exponent chain (the decrypt path).
# ---------------------------------------------------------------------------

def rns_one_state(base: RnsBase, key: RnsModulus, B: int):
    """State of M mod m (the RNS-Montgomery rep of 1), (CH, B)."""
    return key.one_ch.to(LIMB_DTYPE).expand(base.CH, B)


def sched_len(ebits: int, window: int) -> int:
    """Key-independent sliding-window schedule length."""
    return ebits + -(-ebits // window)


def sliding_schedule(e: int, window: int, ebits: int) -> np.ndarray:
    """Left-to-right sliding-window schedule for e < 2^ebits: 0 squares
    the accumulator, t > 0 multiplies by c^(2t-1).  Front-padded with
    squarings of `one` to sched_len(ebits, window)."""
    assert 0 <= e < (1 << ebits)
    bits = bin(e)[2:] if e else "0"
    ops = []
    i, n = 0, len(bits)
    while i < n:
        if bits[i] == "0":
            ops.append(0)
            i += 1
        else:
            j = min(i + window, n)
            while bits[j - 1] == "0":
                j -= 1
            ops.extend([0] * (j - i))
            ops.append((int(bits[i:j], 2) + 1) // 2)
            i = j
    pad = sched_len(ebits, window) - len(ops)
    assert pad >= 0
    return np.array([0] * pad + ops, dtype=np.int32)


def rns_exp_sched(X, sched, base: RnsBase, key: RnsModulus, window: int):
    """Plain twin of kernel K2: X the entered state (value c*M), sched
    from sliding_schedule.  Table of the 2^(window-1) odd powers; entry
    0 squares the accumulator; the accumulator starts at `one`."""
    B = X.shape[1]
    mul = lambda a, b: rns_mont_mul(a, b, base, key)
    c2 = mul(X, X)
    table = [X]
    for _ in range((1 << (window - 1)) - 1):
        table.append(mul(table[-1], c2))
    acc = rns_one_state(base, key, B)
    for d in np.asarray(sched.cpu() if isinstance(sched, torch.Tensor)
                        else sched).tolist():
        acc = mul(acc, acc if d == 0 else table[d - 1])
    return acc


def rns_crt_exp_sched(v_limbs, sched, base: RnsBase, key: RnsModulus,
                      sq_ctx, window: int, L: int):
    """One CRT half: Montgomery-limb values (L, B) -> canonical c^e mod m:
    enter, the K2 chain, exit."""
    from . import rns_kernels
    X = rns_enter(v_limbs, base, key)
    Z = rns_kernels.rns_exp_sched_p(X, sched, base, key, window)
    return rns_exit(Z, base, key, sq_ctx, L)


def rns_crt_exp_sched_pair(v_p, v_q, sched_p, sched_q, base: RnsBase,
                           key_p: RnsModulus, key_q: RnsModulus, sq_p, sq_q,
                           window: int, L: int) -> tuple:
    """Both CRT halves, each as ``rns_crt_exp_sched`` computes it: enter
    p, enter q, one K2 launch over both chains, exit p, exit q."""
    from . import rns_kernels
    Xp, Xq = rns_enter(v_p, base, key_p), rns_enter(v_q, base, key_q)
    Zp, Zq = rns_kernels.rns_exp_sched_pair(Xp, Xq, sched_p, sched_q, base,
                                            key_p, key_q, window)
    return (rns_exit(Zp, base, key_p, sq_p, L),
            rns_exit(Zq, base, key_q, sq_q, L))


def rns_exp_shared(X, digits, base: RnsBase, key: RnsModulus, window: int):
    """Fixed-window shared-exponent chain: X the entered state (value
    c*M), digits (n_win,) MSB-first base-2^window digits of the one
    exponent, on the host.  Returns the state of c^e * M: kernel K6 on a
    CUDA tensor, the plain twin on a CPU tensor
    (``rns_kernels.rns_exp_shared_p`` decides)."""
    from . import rns_kernels
    return rns_kernels.rns_exp_shared_p(X, digits, base, key, window)


def rns_exp_shared_plain(X, digits, base: RnsBase, key: RnsModulus,
                         window: int):
    """Plain twin of kernel K6: table [one, X, X^2, ...] of 2^window
    entries by successive products with X, then per window `window`
    squarings and one product by T[digit] (by `one` on a zero digit)."""
    B = X.shape[1]
    mul = lambda a, b: rns_mont_mul(a, b, base, key)
    table = [rns_one_state(base, key, B), X.to(LIMB_DTYPE)]
    for _ in range((1 << window) - 2):
        table.append(mul(table[-1], X))
    acc = table[0]
    for d in np.asarray(digits).reshape(-1).tolist():
        for _ in range(window):
            acc = mul(acc, acc)
        acc = mul(acc, table[d])
    return acc


def rns_crt_exp_half(v_limbs, digits, base: RnsBase, key: RnsModulus,
                     sq_ctx, window: int, L: int):
    """One CRT half on the fixed-window chain: Montgomery-limb values
    (L, B) -> canonical c^e mod m: enter, the K6 chain, exit."""
    X = rns_enter(v_limbs, base, key)
    Z = rns_exp_shared(X, digits, base, key, window)
    return rns_exit(Z, base, key, sq_ctx, L)


def rns_exp_elem(X, digits, base: RnsBase, key: RnsModulus, window: int):
    """Plain twin of kernel K5, the per-element-exponent chain (ct*pt):
    X the entered state (value c*M), digits (n_win, B) tensor of
    MSB-first base-2^window digits, one exponent per column.  Table [one, X, X^2,
    ...] built by successive products with X; each window squares
    `window` times, then multiplies by T[digit] (digit 0 by `one`).
    Returns the state of c^e * M."""
    B = X.shape[1]
    mul = lambda a, b: rns_mont_mul(a, b, base, key)
    entries = [rns_one_state(base, key, B), X.to(LIMB_DTYPE)]
    for _ in range((1 << window) - 2):
        entries.append(mul(entries[-1], X))
    table = torch.stack(entries, dim=0)                 # (2^w, CH, B)
    digits = digits.to(I64)
    acc = entries[0]
    for j in range(digits.shape[0]):
        for _ in range(window):
            acc = mul(acc, acc)
        idx = digits[j][None, None, :].expand(1, base.CH, B)
        acc = mul(acc, torch.gather(table, 0, idx)[0])
    return acc


def rns_pow_elem(v_limbs, digits, base: RnsBase, key: RnsModulus, sq_ctx,
                 window: int, L: int):
    """Per-element modexp mod m (the HE ct*pt contract): Montgomery-limb
    bases (L, B), per-column digits -> Montgomery-limb c^e.  Enter, the
    K5 chain, exit, then one K3 product by R^2 back to Montgomery form."""
    from . import rns_kernels
    X = rns_enter(v_limbs, base, key)
    Z = rns_kernels.rns_exp_elem_p(X, digits, base, key, window)
    out = rns_exit(Z, base, key, sq_ctx, L)             # canonical c^e
    return mg.mont_mul(out, sq_ctx.r2, sq_ctx)


def rns_comb_product(ct_raw, comb_rns, digits, base: RnsBase,
                     key: RnsModulus, sq_ctx, L: int,
                     mont_input: bool = False):
    """The DJN comb chain on the RNS engine.

    ct_raw: (L, B) limbs; comb_rns: (n_win, CH, 2^w) states of the comb
    entries; digits: (n_win, B) LSB-window-first obfuscator digits.
    Enter, one K1 product per window with the gathered factor, then the
    SK exit and one fold.  mont_input=False: ct_raw is canonical (1+mn),
    the encrypt chain, folded by |R^4 M^-1|; mont_input=True: ct_raw is
    a Montgomery-limb ciphertext, re-randomization, folded by
    |R^3 M^-1|.  Returns Montgomery-limb ciphertexts (L, B) < 2m."""
    from . import rns_kernels
    acc = rns_enter(ct_raw, base, key)
    digits = digits.to(I64)
    for j in range(digits.shape[0]):
        fac = torch.index_select(comb_rns[j], 1, digits[j])
        acc = rns_kernels.rns_mul(acc, fac, base, key)
    z_limbs = _exit_limbs(acc, base)
    t = mg.mont_reduce_wide(z_limbs, sq_ctx, iters=exit_redc_iters(base, L))
    fold = key.k4_limbs if mont_input else key.k5_limbs
    return mg.mont_mul(t, fold.to(LIMB_DTYPE), sq_ctx)
