"""The one general traffic generator: a traffic mix is a data file.

A mix (``workloads/<traffic>.json``) lists request kinds under ``ops``.
Each kind names an ``op`` (``kinds/<op>.py``) with its sizes, pools and
value distributions.  A variant is one distinct request: an input pool
entry, or one size of a size distribution.  The generator lays every
variant of every kind once into a cycle, ordered by the seed, and the
closed loop walks that cycle round and round (``cycle``).  So every
seed gives the same set of sizes in another order, and only the
plaintext values differ between seeds.  ``traced_requests`` caps the
requests of a traced run.

Sizes: an integer is fixed; ``{"dist": "loguniform", "low", "high",
"levels"}`` is `levels` sizes at the midpoints of equal steps of log size
(the same sizes for every seed).  Values: ``{"dist": "uniform", "low",
"high"}`` or ``{"dist": "normal", "mean", "std"}``, float64, or
``{"dist": "integers", "low", "high"}``, int64 uniform in [low, high)
(fixed-point values at one shared exponent); an optional
``"magnitude": [lo, hi]`` clips |x| into [lo, hi), so that every seed's
values span the same binary exponents, and the kinds that align
exponents plant lo and hi where a request's alignment takes its widest
shift (``kinds/``): the work of a request does not depend on the seed.
"""

from __future__ import annotations

import json
import math
import os
import random

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Seed streams: one generator per purpose, so adding a draw to one does
# not move the others.
STREAM_VALUES, STREAM_ORDER, STREAM_CHECK = 1, 2, 3
STRATA = 4


def load(name: str) -> dict:
    with open(os.path.join(HERE, "workloads", name + ".json")) as f:
        mix = json.load(f)
    if mix.get("loop") != "closed" or mix.get("callers") != 1:
        raise ValueError(f"{name}: only a closed loop with one caller is "
                         "implemented")
    if not mix.get("ops"):
        raise ValueError(f"{name}: no request kinds under 'ops'")
    return mix


def sizes(spec) -> list:
    """The sizes a size field stands for, in increasing order."""
    if isinstance(spec, int):
        return [spec]
    if spec.get("dist") != "loguniform":
        raise ValueError(f"unknown size distribution {spec!r}")
    lo, hi, k = math.log(spec["low"]), math.log(spec["high"]), spec["levels"]
    return [int(round(math.exp(lo + (hi - lo) * (i + 0.5) / k)))
            for i in range(k)]


def draw(spec: dict, shape, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] == "integers":
        return rng.integers(spec["low"], spec["high"], shape, dtype=np.int64)
    if spec["dist"] == "uniform":
        x = rng.uniform(spec["low"], spec["high"], shape)
    elif spec["dist"] == "normal":
        x = rng.normal(spec.get("mean", 0.0), spec["std"], shape)
    else:
        raise ValueError(f"unknown value distribution {spec!r}")
    if "magnitude" in spec:
        lo, hi = extremes(spec)
        mag = np.clip(np.abs(x), lo, hi)
        x = np.where(x < 0, -mag, mag)
    return x


def extremes(spec: dict) -> tuple:
    """The smallest and the largest magnitude a value spec allows."""
    lo, hi = spec["magnitude"]
    return float(lo), float(np.nextafter(hi, 0.0))


def cycle(n_variants: list, seed: int) -> list:
    """[(kind, variant)] of one cycle in a seeded order.  The cycle, laid
    out by kind and by variant (a kind's variants go up in size), is cut
    into STRATA consecutive parts; each part is shuffled by the seed,
    and the order deals one request from each part in turn.  So any run
    of STRATA requests holds one of each part, and a window that ends
    inside a cycle carries the cycle's mix of sizes."""
    order = [(k, v) for k, n in enumerate(n_variants) for v in range(n)]
    rng = random.Random(seed * 4 + STREAM_ORDER)
    s = max(1, min(STRATA, len(order)))
    parts = [order[len(order) * i // s:len(order) * (i + 1) // s]
             for i in range(s)]
    for p in parts:
        rng.shuffle(p)
    return [p[i] for i in range(max(map(len, parts))) for p in parts
            if i < len(p)]
