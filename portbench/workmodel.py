"""The frozen work model: each request's least chip time on the card.

``rns_ops``, ``limb_ops`` and ``bound`` are copies of ``chip_smoke.py``'s
(one RNS-Montgomery product of one column is two base extensions of
4(k+1)k int8 multiply-adds; one Montgomery product of L 16-bit limbs is
2L^2 limb products of 4 int8 multiply-adds, a square L(L+1)/2 + L^2; a
multiply-add is 2 operations), against the published NVIDIA H100 SXM
peaks at 700 W: 3.35 TB/s of HBM and 1,979 TOP/s of dense int8.

The work of a request is the reference algorithm's, counted from the
inputs the benchmark made and the configuration's widths, never from
the program, so a later change of kernel or algorithm does not move it:

* encrypt: the fixed-base comb, one product a window of the obfuscator
  r (randbits / comb_window windows) a value, RNS model at n^2;
* decrypt: per CRT half a 4-bit fixed-window power by p-1 (14 table
  products, then 4 squares and 1 product a window), RNS model at p^2;
* ct*pt: the same 4-bit power by |mantissa| a column, RNS model at n^2;
  a negative plaintext adds the batched inversion, 3 products a column,
  limb model;
* alignment by 2^d: d squares a column, limb model at n^2;
* + and the reductions: one product a pair, limb model at n^2.

Bytes count each input read once and each output written once: floats
8 bytes, ciphertexts 2*bits/8, the obfuscator randbits/8, and the comb
entries the batch is expected to select (uniform digits: 2^w (1 -
(1 - 2^-w)^B) of each window), each an n^2 residue.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
TABLE_PRODUCTS = 14          # 2^4 - 2 products build a 4-bit window table
WINDOW = 4


def rns_ops(k: int, products: int, B: int) -> int:
    return products * B * 2 * (2 * 4 * (k + 1) * k)


def limb_ops(L: int, products: int, B: int, squares: int = 0) -> int:
    return B * 2 * 4 * (products * 2 * L * L
                        + squares * (L * (L + 1) // 2 + L * L))


def bound(n_bytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by) for `n_bytes` moved and `ops` int8 operations."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def least_seconds(n_bytes: float, ops: float) -> float:
    return bound(n_bytes, ops)[0] / 1e3


def power_products(bits: int) -> int:
    """Products of a 4-bit fixed-window power by an exponent of `bits`."""
    if bits == 0:
        return 0
    return TABLE_PRODUCTS + -(-bits // WINDOW) * (WINDOW + 1)


class Widths:
    """The configuration's widths, as the work model reads them."""

    def __init__(self, widths: dict, randbits: int):
        self.bits = widths["n_bits"]
        self.k_nsq = (widths["nsq_channels"] - 1) // 2
        self.k_half = (widths["half_channels"] - 1) // 2
        self.L = widths["nsq_limbs"]
        self.comb_window = widths["comb_window"]
        self.randbits = randbits
        self.ct_bytes = 2 * self.bits // 8


def encrypt_work(w: Widths, B: int) -> tuple:
    """(ops, bytes) of encrypting B floats."""
    n_win = -(-w.randbits // w.comb_window)
    size = 1 << w.comb_window
    entries = n_win * size * (1.0 - (1.0 - 1.0 / size) ** B)
    n_bytes = B * (8 + w.randbits // 8 + w.ct_bytes) + entries * w.ct_bytes
    return rns_ops(w.k_nsq, n_win, B), n_bytes


def decrypt_work(w: Widths, B: int) -> tuple:
    """(ops, bytes) of decrypting B ciphertexts to floats."""
    per_half = power_products(w.bits // 2)
    return rns_ops(w.k_half, 2 * per_half, B), B * (w.ct_bytes + 8)


def ctpt_ops(w: Widths, mantissa_bits: list, negatives: int) -> int:
    """ct*pt by plaintexts of these |mantissa| bit lengths, `negatives`
    of them below zero (inverted in one batched tree)."""
    prods = sum(power_products(b) for b in mantissa_bits)
    inv = 3 * max(0, negatives - 1)
    return rns_ops(w.k_nsq, prods, 1) + limb_ops(w.L, inv, 1)


def align_ops(w: Widths, shifts) -> int:
    """Alignment ct -> ct^(2^d) for each shift d: d squares."""
    return limb_ops(w.L, 0, 1, int(sum(shifts)))


def add_ops(w: Widths, products: int) -> int:
    return limb_ops(w.L, products, 1)
