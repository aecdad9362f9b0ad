#!/usr/bin/env python3
"""The seeded plain search that froze the benchmark's key material.

    python3 portbench/keysearch.py --bits 3072 --seed 3072

prints the key as JSON: two primes of bits/2 bits with their top two
bits set (so n = p*q has exactly `bits` bits), found by trial division
and 40 Miller-Rabin rounds with bases from the same seeded generator,
and the DJN base hs = h^n mod n^2 with h = -x^2 mod n and x drawn from
that generator.  ``--p`` and ``--q`` take given primes (the 2048-bit
configuration's) and derive only hs.  Python integers only; the result
is copied into ``configs/<name>.json``, so no run searches.
"""

from __future__ import annotations

import argparse
import json
import math
import random

SMALL_PRIMES = [p for p in range(3, 2000)
                if all(p % d for d in range(2, math.isqrt(p) + 1))]


def is_probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def search_prime(bits: int, rng: random.Random) -> int:
    while True:
        cand = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if is_probable_prime(cand, rng):
            return cand


def djn_base(n: int, rng: random.Random) -> int:
    x = rng.randrange(1, n)
    h = (-(x * x)) % n
    return pow(h, n, n * n)


def key_for(bits: int, seed: int, p: int | None = None,
            q: int | None = None) -> dict:
    rng = random.Random(seed)
    if p is None:
        p = search_prime(bits // 2, rng)
        q = search_prime(bits // 2, rng)
        while q == p:
            q = search_prime(bits // 2, rng)
    n = p * q
    if n.bit_length() != bits or math.gcd(n, (p - 1) * (q - 1)) != 1:
        raise ValueError("the primes do not make a valid key of that size")
    return {"bits": bits, "p": p, "q": q, "n": n, "hs": djn_base(n, rng),
            "randbits": bits // 2, "search_seed": seed}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--p", type=int)
    ap.add_argument("--q", type=int)
    a = ap.parse_args()
    print(json.dumps(key_for(a.bits, a.seed, a.p, a.q)))


if __name__ == "__main__":
    main()
