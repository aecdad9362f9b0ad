"""Limb-array bignum core (PyTorch).

A big number is a little-endian array of 16-bit limbs; a batch of B
numbers is one ``(L, B)`` tensor, limbs-major, as in the JAX package
(``pailliercryptolib_python_tpu/ops/limb.py``).

Storage type.  Every tensor that crosses a function boundary holds
canonical limbs (< 2^16) or channel residues (< 2^16), so it is stored as
``int32`` (``LIMB_DTYPE``): exact, and the type the CUDA kernels read as
``uint32``.  Arithmetic inside the plain functions runs in ``int64``:
torch's ``uint32`` supports few operations, and every intermediate the
JAX package keeps in ``uint32`` is non-negative and below 2^33, so int64
holds it exactly.  Where the JAX code relies on ``uint32`` wrap-around,
the port masks with ``& MASK32`` at that spot (see ``ops/rns.py``).
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = 0xFFFF
MASK32 = 0xFFFFFFFF
LIMB_DTYPE = torch.int32


# ---------------------------------------------------------------------------
# Host-side converters (Python int <-> limb arrays).
# ---------------------------------------------------------------------------

def limbs_for_bits(bits: int) -> int:
    """Number of 16-bit limbs needed to hold `bits` bits."""
    return -(-bits // LIMB_BITS)


def int_to_limbs(x: int, num_limbs: int) -> np.ndarray:
    """Non-negative Python int -> (num_limbs,) uint32 limb array."""
    if x < 0:
        raise ValueError("int_to_limbs: negative value")
    b = int(x).to_bytes(num_limbs * 2, byteorder="little")
    return np.frombuffer(b, dtype="<u2").astype(np.uint32)


def limbs_to_int(a) -> int:
    """(L,) limb array (canonical or redundant) -> Python int."""
    a = np.asarray(a).astype(np.uint64)
    val = 0
    for k in range(a.shape[0] - 1, -1, -1):
        val = (val << LIMB_BITS) + int(a[k])
    return val


def ints_to_limbs(xs, num_limbs: int) -> np.ndarray:
    """Sequence of B ints -> (num_limbs, B) uint32 numpy array."""
    from .. import native
    return native.pack_limbs16(xs, num_limbs)


def limbs_to_ints(arr) -> list:
    """(L, B) limb array (numpy or tensor) -> list of B Python ints."""
    from .. import native
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    if arr.size and arr.min() >= 0 and arr.max() <= LIMB_MASK:
        return native.unpack_limbs16(arr)
    a64 = arr.astype(np.int64)
    return [limbs_to_int(a64[:, b]) for b in range(arr.shape[1])]


def idot(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact integer W @ x through float64 (torch has no integer matmul
    on CUDA): exact while every sum stays below 2^53; callers' sums are
    below 2^31."""
    assert W.shape[1] * 255 * 255 < (1 << 53)
    return torch.matmul(W.to(torch.float64),
                        x.to(torch.float64)).to(torch.int64)


def h2d(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`.  To a CUDA device it goes through pinned
    memory as an asynchronous copy on the current stream: a copy from
    pageable memory would wait for all device work enqueued before it,
    and so serialize a caller that pipelines host and device stages."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host uint32/int numpy limbs (< 2^31) -> int32 tensor on `device`."""
    return h2d(torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr).astype(np.int32))), device)


# ---------------------------------------------------------------------------
# Plain tensor primitives on (L, B) or broadcastable (L, 1) limb arrays.
# "Canonical" = every limb < 2^16; "redundant" = limbs hold partial sums
# (int64) awaiting carry propagation.
# ---------------------------------------------------------------------------

def _shift_down(x: torch.Tensor, d: int) -> torch.Tensor:
    """Rows moved d places toward the top; zeros enter at row 0."""
    if d >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:d]), x[:-d]], dim=0)


def normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry-propagate a redundant limb array (values < 2^32) to
    canonical limbs; the carry out of the top limb is dropped.

    One local pass leaves at most one carry bit per limb; a Kogge-Stone
    scan over (generate, propagate) bits resolves it in log2(K) steps.
    """
    t = t.to(torch.int64)
    K = t.shape[0]
    v = (t & LIMB_MASK) + _shift_down(t >> LIMB_BITS, 1)
    r = v & LIMB_MASK
    G = v >> LIMB_BITS                                  # in {0, 1}
    P = (r == LIMB_MASK).to(torch.int64)
    d = 1
    while d < K:
        G = G | (P & _shift_down(G, d))
        P = P & _shift_down(P, d)
        d <<= 1
    return ((r + _shift_down(G, 1)) & LIMB_MASK).to(LIMB_DTYPE)


def compare_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a >= b per column for canonical limbs -> bool (B,)."""
    a, b = torch.broadcast_tensors(a, b)
    neq = a != b
    rev = torch.flip(neq, dims=[0]).to(torch.int32)
    idx = a.shape[0] - 1 - torch.argmax(rev, dim=0)     # top differing limb
    av = torch.gather(a, 0, idx[None, :])[0]
    bv = torch.gather(b, 0, idx[None, :])[0]
    return torch.where(neq.any(dim=0), av >= bv, torch.ones_like(av >= bv))


def sub_mod_base(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^(16L) for canonical inputs, borrow-free:
    a + (2^(16L) - 1 - b) + 1, one carry pass."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    t = a + (LIMB_MASK - b)
    t = torch.cat([t[:1] + 1, t[1:]], dim=0)
    return normalize(t)


def cond_sub(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Where a >= m (canonical limbs), a - m, else a."""
    ge = compare_ge(a, m)
    d = sub_mod_base(a, m.expand(a.shape[0], a.shape[1]))
    return torch.where(ge[None, :], d, a.to(LIMB_DTYPE))


def big_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a + b (carry out of the top limb dropped)."""
    return normalize(a.to(torch.int64) + b.to(torch.int64))


def big_mul(a: torch.Tensor, b: torch.Tensor,
            out_limbs: int | None = None) -> torch.Tensor:
    """Low `out_limbs` limbs (default La + Lb) of the full product of
    canonical limb arrays a (La, B|1) and b (Lb, B|1).

    Schoolbook: La steps, each an (Lb, B) product of 16-bit limbs split
    into halves and accumulated carry-save (each accumulator gains
    < 2^17 per step, so int64 never comes near overflow).  Rows at or
    above out_limbs are never formed: carries only move upward, so the
    low limbs do not depend on them."""
    La, Lb = a.shape[0], b.shape[0]
    B = max(a.shape[1], b.shape[1])
    if out_limbs is None:
        out_limbs = La + Lb
    a = a.to(torch.int64).expand(La, B)
    b = b.to(torch.int64).expand(Lb, B)
    acc = torch.zeros((out_limbs, B), dtype=torch.int64, device=a.device)
    for i in range(min(La, out_limbs)):
        p = a[i:i + 1] * b
        n_lo = min(Lb, out_limbs - i)
        acc[i:i + n_lo] += p[:n_lo] & LIMB_MASK
        n_hi = min(Lb, out_limbs - i - 1)
        if n_hi > 0:
            acc[i + 1:i + 1 + n_hi] += p[:n_hi] >> LIMB_BITS
    return normalize(acc)


def big_mul_low(a: torch.Tensor, b: torch.Tensor,
                out_limbs: int) -> torch.Tensor:
    """a*b mod 2^(16*out_limbs)."""
    return big_mul(a, b, out_limbs=out_limbs)
