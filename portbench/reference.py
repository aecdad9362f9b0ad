"""The plain reference: what each request's answer must be, and the judge.

Python integers and numpy only.  It imports nothing of the measured
package and nothing of JAX, and takes nothing the program made: the key
comes from the configuration file and the plaintext floats from the
traffic generator, the same inputs the program is handed.  The program's
answers (canonical ciphertext integers, exponents, floats) are read only
to be judged here: a ciphertext by decrypting it with the private key.

Fixed-point rule, a frozen copy of the library's: BASE 2; a float x has
the exponent e = 53 - frexp(x)[1] (0 when |x| < 1e-200) and the mantissa
round(x * 2^e), half to even; its encoding is the mantissa mod n, and
decoding gives mantissa * 2^-e.  DJN Paillier: a ciphertext of m is
(1 + m*n) * hs^r mod n^2; decryption by CRT over p^2 and q^2.
"""

from __future__ import annotations

import random

import numpy as np

MANTISSA_BITS = 53
COEFF_BITS = 10        # random-combination coefficients lie in [1, 2^10)


def encode(x: np.ndarray) -> tuple[list, np.ndarray]:
    """(signed mantissas as Python ints, int64 exponents) of float64 x."""
    f = np.asarray(x, dtype=np.float64).reshape(-1)
    tiny = np.abs(f) < 1e-200
    _, fexp = np.frexp(f)
    exps = np.where(tiny, 0, MANTISSA_BITS - fexp.astype(np.int64))
    mant = np.where(tiny, 0.0, np.rint(np.ldexp(f, exps)))
    return [int(v) for v in mant], exps.astype(np.int64)


def decode(mantissa: int, exponent: int) -> float:
    return mantissa * pow(2, -int(exponent))


class Key:
    """DJN Paillier key material as Python integers."""

    def __init__(self, key: dict):
        self.n, self.p, self.q = int(key["n"]), int(key["p"]), int(key["q"])
        self.hs = int(key["hs"])
        self.nsq = self.n * self.n
        self.psq, self.qsq = self.p * self.p, self.q * self.q
        g = self.n + 1
        self.hp = pow(self._lfun(pow(g, self.p - 1, self.psq), self.p), -1,
                      self.p)
        self.hq = pow(self._lfun(pow(g, self.q - 1, self.qsq), self.q), -1,
                      self.q)
        self.q_inv_p = pow(self.q, -1, self.p)

    @staticmethod
    def _lfun(u: int, m: int) -> int:
        return (u - 1) // m

    def decrypt(self, c: int) -> int:
        """The plaintext mod n of ciphertext c."""
        mp = self._lfun(pow(c % self.psq, self.p - 1, self.psq),
                        self.p) * self.hp % self.p
        mq = self._lfun(pow(c % self.qsq, self.q - 1, self.qsq),
                        self.q) * self.hq % self.q
        return mq + self.q * ((mp - mq) * self.q_inv_p % self.p)

    def encrypt(self, m: int, obfuscator: int) -> int:
        """(1 + m*n) * obfuscator mod n^2, m taken mod n."""
        return (1 + (m % self.n) * self.n) * obfuscator % self.nsq

    def obfuscator(self, r: int) -> int:
        return pow(self.hs, r, self.nsq)


def combine(cts: list, coeffs: list, modulus: int) -> int:
    """prod c_i^a_i mod modulus for small a_i >= 1: bucket the
    ciphertexts by coefficient, then one running product over the
    buckets (len(cts) + 2^(COEFF_BITS+1) products)."""
    buckets = [1] * (1 << COEFF_BITS)
    for c, a in zip(cts, coeffs):
        buckets[a] = buckets[a] * c % modulus
    acc = run = 1
    for a in range(len(buckets) - 1, 0, -1):
        run = run * buckets[a] % modulus
        acc = acc * run % modulus
    return acc


def coefficients(count: int, rng: random.Random) -> list:
    return [rng.randrange(1, 1 << COEFF_BITS) for _ in range(count)]


# -- expected answers of each request kind --------------------------------


def matmul_expected(d: np.ndarray, X: np.ndarray) -> tuple[list, list]:
    """[[d]] @ X for d of B rows and X of (B, F): per output column j the
    exact signed mantissa sum_i dm_i * xm_ij * 2^(t_j - e_i - f_ij) and
    its exponent t_j = max_i (e_i + f_ij)."""
    dm, de = encode(d)
    xm, xe = encode(X)
    return matmul_mantissas(dm, de, xm, xe, *X.shape)


def matmul_mantissas(dm, de, xm, xe, B: int, F: int) -> tuple[list, list]:
    tot = np.asarray(de)[:, None] + np.asarray(xe).reshape(B, F)
    tgt = tot.max(axis=0)
    sums = []
    for j in range(F):
        s = 0
        for i in range(B):
            s += (dm[i] * xm[i * F + j]) << int(tgt[j] - tot[i, j])
        sums.append(s)
    return sums, [int(t) for t in tgt]


def sum_expected(vectors: list) -> tuple[list, np.ndarray]:
    """Elementwise sum of P float vectors: mantissas aligned to the
    largest exponent of each element (the result's exponent)."""
    return sum_mantissas([encode(v) for v in vectors])


def sum_mantissas(enc: list) -> tuple[list, np.ndarray]:
    tgt = np.max(np.stack([np.asarray(e) for _, e in enc]), axis=0)
    out = []
    for i in range(len(tgt)):
        t = int(tgt[i])
        out.append(sum(m[i] << (t - int(e[i])) for m, e in enc))
    return out, tgt


def judge_each(key: Key, cts: list, want: list) -> bool:
    """Every ciphertext decrypts to its expected plaintext (mod n)."""
    return len(cts) == len(want) and all(
        key.decrypt(c) == w % key.n for c, w in zip(cts, want))


def judge_combined(key: Key, cts: list, want: list,
                   rng: random.Random) -> bool:
    """One decryption of a random combination prod c_i^a_i against
    sum a_i * want_i mod n.  One ciphertext that decrypts to another
    plaintext always changes the sum (a_i < p, q); several cancel, as
    two swapped ones do, with a chance of about 2^-COEFF_BITS."""
    if len(cts) != len(want):
        return False
    a = coefficients(len(cts), rng)
    got = key.decrypt(combine(cts, a, key.nsq))
    return got == sum(x * w for x, w in zip(a, want)) % key.n


def unfresh(key: Key, answers: list) -> int:
    """Ciphertexts, over several answers, whose obfuscator is missing or
    not their own.  c = (1 + m*n) * hs^r mod n^2 gives c mod n = hs^r mod
    n: that is 1 where no obfuscator was applied, and two ciphertexts
    whose residues agree share their obfuscator (new draws of r agree
    with a chance of about 2^-1000), whatever their plaintexts."""
    seen = {}
    for cts in answers:
        for c in cts:
            r = c % key.n
            seen[r] = seen.get(r, 0) + 1
    return sum(k for r, k in seen.items() if k > 1 or r == 1)
