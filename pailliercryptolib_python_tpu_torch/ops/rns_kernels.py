"""Wrappers of the RNS kernels K1 (``rns_mul``), K2 (``rns_exp_sched_p``),
K5 (``rns_exp_elem_p``) and K6 (``rns_exp_shared_p``) and the packing of
their operands.

All four run on the tile routine ``csrc/rns_tile.cuh``: both base
extensions of a product are int8 tensor-core products of the extension
matrices W1, W2 (``tile_weights``) with a tile of digits.
``rns_mul_tile``, ``rns_exp_sched_tile``, ``rns_exp_elem_tile`` and
``rns_exp_shared_tile`` are that routine's arithmetic in plain PyTorch,
matrix product included, for the CPU tests.

Counterpart of ``pailliercryptolib_python_tpu/ops/pallas_rns.py``.  The
packing is ported from the code, not from its comments (which misstate
two constants): ``exit_c[0]`` carries 2^32, and the CS correction rows
are bounded by 65280*k < 2^31 (asserted in ``_pack_static``).

A wrapper runs the plain twin (``ops/rns.py``) only for a CPU tensor;
for a CUDA tensor it launches the kernel (``csrc/rns.cu``) or raises.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch

from .limb import LIMB_DTYPE
from . import rns
from .. import kernels


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


# Window choice of the decrypt chain.  The value follows the JAX
# package's plan_sched (its 16 MB scoped-VMEM model), so both packages
# run the same schedule and their states can be compared; the model sets
# nothing inside the CUDA kernel.
_VMEM_BUDGET = 15_800_000
_WORK_ROWS = 23


def plan_sched(CH: int) -> int | None:
    """Sliding-window width of the decrypt chain at CH channels (6 at
    CH=261, the 2048-bit key's p^2/q^2 base)."""
    rows = lambda w: ((1 << (w - 1)) + 1 + _WORK_ROWS) * _pad8(CH)
    if (CH - 1) // 2 >= 16500:
        return None
    for tb in (256, 128):
        for w in (7, 6, 5, 4, 3):
            if 4 * tb * rows(w) <= _VMEM_BUDGET:
                return w
    return None


# ---------------------------------------------------------------------------
# Operand packing (numpy, as in the JAX package).
# ---------------------------------------------------------------------------

def _center_stack(c_lo, c_hi, d_lo, d_hi):
    """Byte planes -> the centred int8 stack E = [C_lo; C_hi; D_lo; D_hi]
    - 128 ((4o, k)) and CS, which folds every static correction:
    128*(rowsum(C') + rowsum(D')) + 2*128^2*k."""
    k_in = c_lo.shape[1]
    EX = np.concatenate([c_lo, c_hi], axis=0).astype(np.int32) - 128
    EY = np.concatenate([d_lo, d_hi], axis=0).astype(np.int32) - 128
    E = np.concatenate([EX, EY], axis=0)
    CS = (128 * (EX.sum(axis=1, keepdims=True)
                 + EY.sum(axis=1, keepdims=True))
          + 2 * 128 * 128 * k_in).astype(np.int32)
    return E.astype(np.int8), CS


@lru_cache(maxsize=8)
def _pack_static(mbits: int):
    """Key-independent operands: the channel vector table with the key
    columns zeroed, SK constants, centred extension stacks."""
    a = rns.base_arrays_np(mbits)
    k = a["k"]
    CH = 2 * k + 1
    CHP = _pad8(CH)
    vec = np.zeros((CHP, 16), dtype=np.uint32)
    vec[:, 0] = 1                                     # pad-row modulus
    vec[:CH, 0] = a["mods"][:, 0]
    vec[:CH, 1] = a["n0"][:, 0]
    vec[:CH, 2] = a["n032"][:, 0]
    vec[k:2 * k, 3] = a["K2s"][:, 0]                  # xi' Shoup (B' rows)
    vec[k:2 * k, 8] = a["K2sh"][:, 0]
    skc = np.zeros((8, 1), dtype=np.uint32)
    skc[0, 0] = a["exit_c"][0, 0]                     # |2^32 M'^-1|_mr
    skc[1, 0] = a["exit_c"][1, 0]                     # |M'^-1|_mr
    E1, CS1 = _center_stack(a["C1_lo"], a["C1_hi"], a["D1_lo"], a["D1_hi"])
    E2, CS2 = _center_stack(a["C2_lo"], a["C2_hi"], a["D2_lo"], a["D2_hi"])
    # CS = 128*rowsums + 2*128^2*k lies in [0, 65280*k] (each centred
    # entry >= -128): non-negative and below 2^31, exact through uint32
    for cs in (CS1, CS2):
        assert 0 <= cs.min() and cs.max() <= 65280 * k < (1 << 31)
    vec[:CS1.shape[0], 10] = CS1[:, 0].astype(np.uint32)
    vec[:CS2.shape[0], 11] = CS2[:, 0].astype(np.uint32)
    return dict(vec=vec, skc=skc, E1=E1, E2=E2, CHP=CHP)


# Operand bundles keyed by (mbits, m).  m is key material (p^2, q^2 or
# n^2), so the cache is bounded and a retired key's entries can be
# dropped at once; 16 entries hold five keys (n^2 and both CRT halves).
_PACK_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
_PACK_CACHE_MAX = 16


def pack_evict(m: int) -> None:
    """Drop the cached operand bundles of modulus m (key retirement)."""
    for ck in [ck for ck in _PACK_CACHE if ck[1] == m]:
        del _PACK_CACHE[ck]


def pack(mbits: int, m: int) -> dict:
    """Kernel operand bundle for modulus m (numpy; least recently used of
    more than _PACK_CACHE_MAX bundles is dropped)."""
    ck = (mbits, m)
    hit = _PACK_CACHE.get(ck)
    if hit is not None:
        _PACK_CACHE.move_to_end(ck)
        return hit
    out = _pack(mbits, m)
    _PACK_CACHE[ck] = out
    while len(_PACK_CACHE) > _PACK_CACHE_MAX:
        _PACK_CACHE.popitem(last=False)
    return out


def _pack(mbits: int, m: int) -> dict:
    a = rns.base_arrays_np(mbits)
    kv = rns.modulus_vectors(mbits, m)
    k = a["k"]
    CH = 2 * k + 1
    vec = _pack_static(mbits)["vec"].copy()
    vec[:k, 3] = kv["K1s"][:, 0]                      # xi Shoup (B rows)
    vec[:k, 8] = kv["K1sh"][:, 0]
    vec[k:2 * k + 1, 4] = kv["u5"][:, 0]              # B' ++ m_r
    vec[k:2 * k + 1, 5] = kv["v5"][:, 0]
    vec[:k, 6] = kv["w9n"][:, 0]
    vec[:k, 7] = kv["w9b"][:, 0]
    all_mods = list(a["mods_B_int"]) + list(a["mods_Bp_int"]) + [a["m_r"]]
    Mm = a["M"] % m
    vec[:CH, 9] = [(Mm % mc) * (1 << 16) % mc for mc in all_mods]
    return dict(_pack_static(mbits), vec=vec)


def _unpack_c(vec, skc, E1, E2):
    """vec columns + stacks -> the product's constant tuple: mods, n0,
    n032, ximul, u5, v5, w9n, w9b, ximulh, skc, E1, CS1, E2, CS2 (the
    vec and skc columns are what the CUDA kernels read; their W1, W2 are
    ``tile_weights`` of E1, E2)."""
    o2 = E1.shape[0] // 2
    return (vec[:, 0:1], vec[:, 1:2], vec[:, 2:3], vec[:, 3:4], vec[:, 4:5],
            vec[:, 5:6], vec[:, 6:7], vec[:, 7:8], vec[:, 8:9], skc,
            E1, vec[:o2, 10:11].astype(np.int32),
            E2, vec[:o2, 11:12].astype(np.int32))


# The tile kernels' mma instruction (m16n8k32): W is padded to these.
MMA_M, MMA_K = 16, 32
# Columns a CTA of K1 / K2 / K5 owns (rns_tile::kNC).
TILE_COLS = 32


def tile_weights(E: np.ndarray, KP: int) -> np.ndarray:
    """One base extension's matrix for the tile kernels, from its centred
    stack E = [C_lo; C_hi; D_lo; D_hi] - 128 ((4o, k) int8): W (Mp, 2KP)
    uint8 with row 2j = [C_lo[j], D_lo[j]] and row 2j+1 = [C_hi[j],
    D_hi[j]] (the rows of [[C_lo, D_lo], [C_hi, D_hi]] interleaved, so
    S_A[j] and S_B[j] are neighbouring rows of W . X), each part
    zero-padded from k to KP columns and the rows from 2o to Mp, a
    multiple of MMA_M.  The bytes are the planes themselves (E + 128):
    the tensor cores multiply unsigned bytes, and then W . X is the true
    dot with no correction term."""
    o = E.shape[0] // 4
    k = E.shape[1]
    U = (E.astype(np.int16) + 128).astype(np.uint8)
    Mp = -(-2 * o // MMA_M) * MMA_M
    W = np.zeros((Mp, 2 * KP), dtype=np.uint8)
    W[0:2 * o:2, :k] = U[:o]                    # C_lo
    W[1:2 * o:2, :k] = U[o:2 * o]               # C_hi
    W[0:2 * o:2, KP:KP + k] = U[2 * o:3 * o]    # D_lo
    W[1:2 * o:2, KP:KP + k] = U[3 * o:]         # D_hi
    return W


def fragment_order(W: np.ndarray) -> np.ndarray:
    """W (MT*16, KS*32) in mma.m16n8k32 A-fragment order, flat: for
    m-tile mt, k-step ks and lane L = 4g + t, the 16 bytes at
    ((mt*KS + ks)*32 + L)*16 are registers a0..a3: rows mt*16 + g (a0,
    a2) and + 8 (a1, a3), columns ks*32 + 4t + [0, 4) (a0, a1) and + 16
    (a2, a3)."""
    MT, KS = W.shape[0] // MMA_M, W.shape[1] // MMA_K
    # row = mt*16 + h*8 + g, col = ks*32 + c*16 + t*4 + b
    return np.ascontiguousarray(W.reshape(MT, 2, 8, KS, 2, 4, 4).transpose(
        0, 3, 2, 5, 4, 1, 6)).reshape(-1)


def kernel_operands(base: rns.RnsBase, key: rns.RnsModulus,
                    device: torch.device) -> dict:
    """Device copy of the operand bundle, memoized on the key.

    KP is k rounded up to a multiple of 16.  W1, W2 are ``tile_weights``
    of the packed E stacks (uint8 (Mp, 2KP), what ``rns_mul_tile``
    multiplies) and W1f, W2f the same bytes in ``fragment_order`` (what
    the kernels read).  The stacks are key-independent, so the p^2 and
    q^2 bundles of one base hold equal W."""
    ops = key._dev_ops
    if ops is not None and ops["vec"].device == device:
        return ops
    p = key.packed or pack(base.mbits, key.m)
    KP = -(-base.k // 16) * 16
    u32 = lambda x: torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, dtype=np.uint32)).view(np.int32)
    ).to(device)
    W1, W2 = (tile_weights(np.asarray(p[f]), KP) for f in ("E1", "E2"))
    dev = lambda a: torch.from_numpy(a).to(device)
    ops = dict(vec=u32(p["vec"]), skc=u32(p["skc"]), KP=KP, W1=dev(W1),
               W2=dev(W2), W1f=dev(fragment_order(W1)),
               W2f=dev(fragment_order(W2)))
    key._dev_ops = ops
    return ops


# ---------------------------------------------------------------------------
# The tile routine in plain PyTorch (CPU; int64 matrix products).
# ---------------------------------------------------------------------------

def _digit_matrix(xi: torch.Tensor, KP: int) -> torch.Tensor:
    """k digits (k, B) -> X (2KP, B): low bytes in rows [0, k), high
    bytes in rows [KP, KP+k), zero elsewhere (the tile's digit layout)."""
    k, B = xi.shape
    X = torch.zeros((2 * KP, B), dtype=torch.int64, device=xi.device)
    X[:k] = xi & 0xFF
    X[KP:KP + k] = xi >> 8
    return X


def _extend(W: torch.Tensor, xi: torch.Tensor, KP: int, o: int):
    """(S_A, S_B) of one base extension: W . X, rows de-interleaved."""
    P = torch.matmul(W.to(torch.int64), _digit_matrix(xi, KP))
    return P[0:2 * o:2], P[1:2 * o:2]


def rns_mul_tile(X, Y, base: rns.RnsBase, key: rns.RnsModulus,
                 ops: dict) -> torch.Tensor:
    """One RNS-Montgomery product as the tile kernels compute it, with
    the extensions as products of ``ops["W1"]``, ``ops["W2"]`` (from
    ``kernel_operands``) and the digit matrix.  Equals
    ``rns.rns_mont_mul`` limb for limb."""
    k, KP = base.k, ops["KP"]
    nlev = rns.combine_levels(base.mbits)
    mods, n0 = base.mods, base.n0
    mB, n0B = mods[:k], n0[:k]
    mT, n0T = mods[k:], n0[k:]
    mR, n0R = mods[2 * k:], n0[2 * k:]
    S = rns._cmul(X.to(torch.int64), Y.to(torch.int64), mods, n0)
    xi = rns._cmul_shoup(S[:k], key.K1s, key.K1sh, mB)
    S_A, S_B = _extend(ops["W1"], xi, KP, k + 1)
    Q = rns._combine_dual(S_A, S_B, mT, n0T, nlev)
    Rp = rns._cmul2(S[k:], key.u5, Q, key.v5, mT, n0T)
    xip = rns._cmul_shoup(Rp[:k], base.K2s, base.K2sh, mods[k:2 * k])
    T_A, T_B = _extend(ops["W2"], xip, KP, k + 1)
    Zh = rns._combine_dual(T_A, T_B, torch.cat([mB, mR]),
                           torch.cat([n0B, n0R]), nlev)
    delta = rns._submod(rns._cmul(Zh[k:], base.exit_c[0:1], mR, n0R),
                        rns._cmul(Rp[k:], base.exit_c[1:2], mR, n0R), mR)
    Z = rns._cmul2(Zh[:k], key.w9b, delta.expand(k, delta.shape[1]),
                   key.w9n, mB, n0B)
    return torch.cat([Z, Rp], dim=0).to(LIMB_DTYPE)


def rns_exp_sched_tile(X, sched, base: rns.RnsBase, key: rns.RnsModulus,
                       window: int, ops: dict) -> torch.Tensor:
    """K2's chain over ``rns_mul_tile`` in the kernel's order: c^2, the
    odd powers T[t] = T[t-1] c^2, then from `one` every schedule entry
    (0 squares, t multiplies by T[t-1])."""
    mul = lambda a, b: rns_mul_tile(a, b, base, key, ops)
    c2 = mul(X, X)
    table = [X.to(LIMB_DTYPE)]
    for _ in range((1 << (window - 1)) - 1):
        table.append(mul(table[-1], c2))
    acc = rns.rns_one_state(base, key, X.shape[1])
    for d in np.asarray(sched).reshape(-1).tolist():
        acc = mul(acc, acc if d == 0 else table[d - 1])
    return acc


def elem_table_index(t, c, col, CH: int, window: int):
    """Flat index of entry t, channel c, column col in K5's and K6's
    table, laid out tile by tile as (tiles, 2^window, CH, TILE_COLS): one
    entry of one tile is one contiguous block.  Works on ints and on
    tensors."""
    return (((col // TILE_COLS) * (1 << window) + t) * CH + c) * TILE_COLS \
        + col % TILE_COLS


def _tile_table(X, base: rns.RnsBase, key: rns.RnsModulus, window: int,
                mul):
    """The table of K5's and K6's chains as their kernels build it:
    T[0] = one, T[1] = X, T[t] = T[t-1] X, kept flat in the tile-by-tile
    layout (``elem_table_index``).  Returns (table, at, one), at(t) the
    indices of entry t's (CH, B) state."""
    CH, B = base.CH, X.shape[1]
    tab = torch.zeros(-(-B // TILE_COLS) * (1 << window) * CH * TILE_COLS,
                      dtype=torch.int64)
    c = torch.arange(CH)[:, None]
    col = torch.arange(B)[None, :]
    at = lambda t: elem_table_index(t, c, col, CH, window)
    one = rns.rns_one_state(base, key, B)
    entry = X.to(LIMB_DTYPE)
    tab[at(0)] = one.to(torch.int64)
    tab[at(1)] = entry.to(torch.int64)
    for t in range(2, 1 << window):
        entry = mul(entry, X)
        tab[at(t)] = entry.to(torch.int64)
    return tab, at, one


def rns_exp_elem_tile(X, digits, base: rns.RnsBase, key: rns.RnsModulus,
                      window: int, ops: dict) -> torch.Tensor:
    """K5's chain over ``rns_mul_tile`` in the kernel's order: the table
    (``_tile_table``); from `one`, per window `window` squarings, then
    the product by T[d], chosen by the one-hot select (every entry read,
    the one whose index equals the column's digit kept by mask).
    digits (n_win, B)."""
    CH, B = base.CH, X.shape[1]
    mul = lambda a, b: rns_mul_tile(a, b, base, key, ops)
    tab, at, acc = _tile_table(X, base, key, window, mul)
    digits = torch.as_tensor(np.asarray(digits)).to(torch.int64)
    for j in range(digits.shape[0]):
        for _ in range(window):
            acc = mul(acc, acc)
        sel = torch.zeros((CH, B), dtype=torch.int64)
        for t in range(1 << window):
            mask = -(digits[j] == t).to(torch.int64)[None, :]
            sel = sel | (tab[at(t)] & mask)
        acc = mul(acc, sel)
    return acc


def rns_exp_shared_tile(X, digits, base: rns.RnsBase, key: rns.RnsModulus,
                        window: int, ops: dict) -> torch.Tensor:
    """K6's chain over ``rns_mul_tile`` in the kernel's order: the table
    (``_tile_table``); from `one`, per window `window` squarings, then
    the product by T[d] of the batch's shared digit d (one (CH, B) entry
    gathered tile by tile).  digits (n_win,)."""
    mul = lambda a, b: rns_mul_tile(a, b, base, key, ops)
    tab, at, acc = _tile_table(X, base, key, window, mul)
    for d in np.asarray(digits).reshape(-1).tolist():
        for _ in range(window):
            acc = mul(acc, acc)
        acc = mul(acc, tab[at(d)])
    return acc


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _state(x: torch.Tensor, CH: int, B: int) -> torch.Tensor:
    return x.to(LIMB_DTYPE).expand(CH, B).contiguous()


def rns_mul(A: torch.Tensor, Bst: torch.Tensor, base: rns.RnsBase,
            key: rns.RnsModulus) -> torch.Tensor:
    """One RNS-Montgomery product of two (CH, B) states (K1 on CUDA)."""
    if A.device.type == "cpu":
        return rns.rns_mont_mul(A, Bst, base, key)
    return _rns_mul_cuda(A, Bst, base, key)


def _rns_mul_cuda(A, Bst, base, key) -> torch.Tensor:
    kernels.require_cuda(A, Bst)
    CH = base.CH
    B = max(A.shape[1], Bst.shape[1])
    a, b = _state(A, CH, B), _state(Bst, CH, B)
    p = kernel_operands(base, key, a.device)
    out = torch.empty((CH, B), dtype=LIMB_DTYPE, device=a.device)
    kernels.launch("rns_mul", a, b, out, p["vec"], p["skc"], p["W1f"],
                   p["W2f"], base.k, CH, p["KP"],
                   rns.combine_levels(base.mbits), B)
    return out


def schedule_tensor(sched, window: int, device) -> torch.Tensor:
    """The schedule as a contiguous int32 tensor on `device`, each entry
    checked on the host to lie in [0, 2^(window-1)] and copied without a
    host synchronization.  A tensor this function made may be passed
    again (``kernels.digit_tensor``); any other schedule already on a
    device raises: checking it would cost a copy back and a synchronize."""
    below = (1 << (window - 1)) + 1
    if isinstance(sched, torch.Tensor) and sched.device.type != "cpu":
        return kernels.digit_tensor(sched, window, device, below)
    if isinstance(sched, torch.Tensor):
        sched = sched.numpy()
    sched = np.asarray(sched).astype(np.int32).reshape(-1)
    if sched.size and (sched.max() >= below or sched.min() < 0):
        raise ValueError("rns_exp_sched_p: schedule entry out of range")
    return kernels.digit_tensor(sched, window, device, below)


def rns_exp_sched_p(X: torch.Tensor, sched, base: rns.RnsBase,
                    key: rns.RnsModulus, window: int) -> torch.Tensor:
    """The whole sliding-window chain (K2 on CUDA): X (CH, B) entered
    state, sched (n_ops,) from rns.sliding_schedule, on the host (numpy
    or a CPU tensor) or as ``schedule_tensor`` made it.  Returns the
    state of c^e * M."""
    sched = schedule_tensor(sched, window, X.device)
    if X.device.type == "cpu":
        return rns.rns_exp_sched(X, sched, base, key, window)
    return _rns_exp_sched_cuda(X, sched, base, key, window)


def _rns_exp_sched_cuda(X, sched, base, key, window) -> torch.Tensor:
    kernels.require_cuda(X, sched)
    CH, B = base.CH, X.shape[1]
    x = _state(X, CH, B)
    p = kernel_operands(base, key, x.device)
    out = torch.empty((CH, B), dtype=LIMB_DTYPE, device=x.device)
    # the odd powers, tile by tile: (tiles, 2^(window-1), CH, TILE_COLS)
    # uint16 states (int16 storage)
    tab = torch.empty((-(-B // TILE_COLS), 1 << (window - 1), CH,
                       TILE_COLS), dtype=torch.int16, device=x.device)
    kernels.launch("rns_exp_sched", x, sched, sched.shape[0], out, tab,
                   p["vec"], p["skc"], p["W1f"], p["W2f"], base.k, CH,
                   p["KP"], rns.combine_levels(base.mbits), window, B)
    return out


def rns_exp_elem_p(X: torch.Tensor, digits, base: rns.RnsBase,
                   key: rns.RnsModulus, window: int) -> torch.Tensor:
    """The per-element-exponent chain (K5 on CUDA): X (CH, B) entered
    state, digits (n_win, B) MSB-first base-2^window digits on the host
    (numpy or a CPU tensor).  Returns the state of c^e * M.  Raises on a
    digit outside [0, 2^window)."""
    digits = kernels.digit_tensor(digits, window, X.device)
    if X.device.type == "cpu":
        return rns.rns_exp_elem(X, digits, base, key, window)
    return _rns_exp_elem_cuda(X, digits, base, key, window)


def _rns_exp_elem_cuda(X, digits, base, key, window) -> torch.Tensor:
    kernels.require_cuda(X, digits)
    CH, B = base.CH, X.shape[1]
    n_win = digits.shape[0]
    x = _state(X, CH, B)
    digits = digits.expand(n_win, B).contiguous()
    p = kernel_operands(base, key, x.device)
    out = torch.empty((CH, B), dtype=LIMB_DTYPE, device=x.device)
    # the table, tile by tile: (tiles, 2^window, CH, TILE_COLS) uint16
    # states (int16 storage; elem_table_index)
    tab = torch.empty((-(-B // TILE_COLS), 1 << window, CH, TILE_COLS),
                      dtype=torch.int16, device=x.device)
    kernels.launch("rns_exp_elem", x, digits, n_win, out, tab, p["vec"],
                   p["skc"], p["W1f"], p["W2f"], base.k, CH, p["KP"],
                   rns.combine_levels(base.mbits), window, B)
    return out


def rns_exp_shared_p(X: torch.Tensor, digits, base: rns.RnsBase,
                     key: rns.RnsModulus, window: int) -> torch.Tensor:
    """The fixed-window shared-exponent chain (K6 on CUDA): X (CH, B)
    entered state, digits (n_win,) MSB-first base-2^window digits on the
    host (numpy or a CPU tensor).  Returns the state of c^e * M.  Raises
    on a digit outside [0, 2^window).  The 2^window-entry table lies in
    global memory the wrapper allocates, tile by tile (``elem_table_index``),
    so the tile-memory limit that bounds the TPU kernel's window does not
    apply here."""
    digits = kernels.digit_tensor(digits, window, X.device).reshape(-1)
    if X.device.type == "cpu":
        return rns.rns_exp_shared_plain(X, digits.numpy(), base, key, window)
    return _rns_exp_shared_cuda(X, digits, base, key, window)


def _rns_exp_shared_cuda(X, digits, base, key, window) -> torch.Tensor:
    kernels.require_cuda(X, digits)
    CH, B = base.CH, X.shape[1]
    x = _state(X, CH, B)
    p = kernel_operands(base, key, x.device)
    out = torch.empty((CH, B), dtype=LIMB_DTYPE, device=x.device)
    # the table, tile by tile: (tiles, 2^window, CH, TILE_COLS) uint16
    # states (int16 storage; elem_table_index)
    tab = torch.empty((-(-B // TILE_COLS), 1 << window, CH, TILE_COLS),
                      dtype=torch.int16, device=x.device)
    kernels.launch("rns_exp_shared", x, digits, digits.shape[0], out, tab,
                   p["vec"], p["skc"], p["W1f"], p["W2f"], base.k, CH,
                   p["KP"], rns.combine_levels(base.mbits), window, B)
    return out
