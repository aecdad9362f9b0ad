"""Wrappers of the RNS kernels K1 (``rns_mul``), K2 (``rns_exp_sched_p``)
and K5 (``rns_exp_elem_p``) and the packing of their operands.

Counterpart of ``pailliercryptolib_python_tpu/ops/pallas_rns.py``.  The
packing is ported from the code, not from its comments (which misstate
two constants): ``exit_c[0]`` carries 2^32, and the CS correction rows
are bounded by 65280*k < 2^31 (asserted in ``_pack_static``).

A wrapper runs the plain twin (``ops/rns.py``) only for a CPU tensor;
for a CUDA tensor it launches the kernel (``csrc/rns.cu``) or raises.
"""

from __future__ import annotations

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


def pack(mbits: int, m: int) -> dict:
    """Kernel operand bundle for modulus m (numpy)."""
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
    """vec columns + stacks -> the product's constant tuple (the layout
    the CUDA kernels read): mods, n0, n032, ximul, u5, v5, w9n, w9b,
    ximulh, skc, E1, CS1, E2, CS2."""
    o2 = E1.shape[0] // 2
    return (vec[:, 0:1], vec[:, 1:2], vec[:, 2:3], vec[:, 3:4], vec[:, 4:5],
            vec[:, 5:6], vec[:, 6:7], vec[:, 7:8], vec[:, 8:9], skc,
            E1, vec[:o2, 10:11].astype(np.int32),
            E2, vec[:o2, 11:12].astype(np.int32))


def kernel_operands(base: rns.RnsBase, key: rns.RnsModulus,
                    device: torch.device) -> dict:
    """Device copy of the operand bundle, memoized on the key.

    The E stacks are zero-padded along k to KP, a multiple of 16, so the
    kernel reads each row in 16-byte vectors (the pad columns meet zero
    digits and add nothing)."""
    ops = key._dev_ops
    if ops is not None and ops["vec"].device == device:
        return ops
    p = key.packed or pack(base.mbits, key.m)
    k = base.k
    KP = -(-k // 16) * 16

    def stack(E):
        Ep = np.zeros((E.shape[0], KP), dtype=np.int8)
        Ep[:, :k] = E
        return torch.from_numpy(Ep).to(device)

    u32 = lambda x: torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, dtype=np.uint32)).view(np.int32)
    ).to(device)
    ops = dict(vec=u32(p["vec"]), skc=u32(p["skc"]), E1=stack(p["E1"]),
               E2=stack(p["E2"]), KP=KP)
    key._dev_ops = ops
    return ops


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
    kernels.launch("rns_mul", a, b, out, p["vec"], p["skc"], p["E1"],
                   p["E2"], base.k, CH, p["KP"],
                   rns.combine_levels(base.mbits), B)
    return out


def rns_exp_sched_p(X: torch.Tensor, sched, base: rns.RnsBase,
                    key: rns.RnsModulus, window: int) -> torch.Tensor:
    """The whole sliding-window chain (K2 on CUDA): X (CH, B) entered
    state, sched (n_ops,) from rns.sliding_schedule.  Returns the state
    of c^e * M."""
    if X.device.type == "cpu":
        return rns.rns_exp_sched(X, sched, base, key, window)
    return _rns_exp_sched_cuda(X, sched, base, key, window)


def _rns_exp_sched_cuda(X, sched, base, key, window) -> torch.Tensor:
    kernels.require_cuda(X)
    CH, B = base.CH, X.shape[1]
    x = _state(X, CH, B)
    sched = np.asarray(sched.cpu() if isinstance(sched, torch.Tensor)
                       else sched, dtype=np.int32)
    if sched.max() > (1 << (window - 1)) or sched.min() < 0:
        raise ValueError("rns_exp_sched_p: schedule entry out of range")
    sched = torch.from_numpy(sched).to(x.device)
    p = kernel_operands(base, key, x.device)
    out = torch.empty((CH, B), dtype=LIMB_DTYPE, device=x.device)
    tab = torch.empty((1 << (window - 1), CH, B), dtype=LIMB_DTYPE,
                      device=x.device)
    c2 = torch.empty((CH, B), dtype=LIMB_DTYPE, device=x.device)
    kernels.launch("rns_exp_sched", x, sched, sched.shape[0], out, tab, c2,
                   p["vec"], p["skc"], p["E1"], p["E2"], base.k, CH,
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
    tab = torch.empty((1 << window, CH, B), dtype=LIMB_DTYPE,
                      device=x.device)
    kernels.launch("rns_exp_elem", x, digits, n_win, out, tab, p["vec"],
                   p["skc"], p["E1"], p["E2"], base.k, CH, p["KP"],
                   rns.combine_levels(base.mbits), window, B)
    return out
