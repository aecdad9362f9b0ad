"""``sum_parties``: parties' encrypted vectors summed elementwise with +."""

from __future__ import annotations

import numpy as np

from .. import reference as ref
from .. import traffic
from .. import workmodel as wm
from ..systems import RefCts
from . import Kind, faults, plant


class SumParties(Kind):
    """Sum `parties` encrypted vectors of `batch` values elementwise with
    `+`, left to right; `pool` sets of party vectors, each a variant.
    With magnitudes clipped, `parties` elements (the same in every set)
    are planted so that each `+` shifts both of its operands by the
    widest amount: at element s party 0 is smallest and every other
    largest (the new operand shifts); at element r_p parties 0..p-1 are
    largest and party p smallest (the running sum shifts)."""

    op = "sum_parties"
    keep = 16

    def __init__(self, spec, seed, index):
        super().__init__(spec, seed, index)
        P, B, vs = spec["parties"], spec["batch"], spec["values"]
        where = self.rng.choice(B, P, replace=False)
        self.x = [[traffic.draw(vs, B, self.rng) for _ in range(P)]
                  for _ in range(spec["pool"])]
        if "magnitude" in vs:
            lo, hi = traffic.extremes(vs)
            for xs in self.x:
                plant(xs[0], where[0], lo, self.rng)
                for q in range(1, P):
                    plant(xs[q], where[0], hi, self.rng)
                for p in range(1, P):
                    for q in range(p):
                        plant(xs[q], where[p], hi, self.rng)
                    plant(xs[p], where[p], lo, self.rng)
        self.n_variants = len(self.x)
        self._seen = {}

    def setup(self, system):
        self.pools = [[system.encrypt(x) for x in xs] for xs in self.x]

    def values(self, v):
        return self.spec["parties"] * self.spec["batch"]

    def port(self, system, v):
        acc = self.pools[v][0]
        for c in self.pools[v][1:]:
            acc = acc + c
        system.sync()
        return acc

    def control(self, system, v):
        acc = self.pools[v][0]
        for c in self.pools[v][1:]:
            acc = RefCts(*ref.sum_mantissas([(acc.mants, acc.exps),
                                             (c.mants, c.exps)]))
        return acc

    def expected(self, v):
        return ref.sum_expected(self.x[v])

    def judge(self, key, v, got, rng):
        cts, exps = got
        mant, tgt = self.want(v)
        memo = (v, tuple(cts))
        if memo not in self._seen:
            self._seen[memo] = ref.judge_combined(key, cts, mant, rng)
        return faults(self._seen[memo], bool(np.array_equal(exps, tgt)))

    def work(self, w, v):
        enc = [ref.encode(x)[1] for x in self.x[v]]
        acc, shifts = enc[0], 0
        for e in enc[1:]:
            t = np.maximum(acc, e)
            shifts += int((t - acc).sum() + (t - e).sum())
            acc = t
        P, B = len(enc), len(enc[0])
        ops = wm.align_ops(w, [shifts]) + wm.add_ops(w, (P - 1) * B)
        return ops, (P + 1) * B * w.ct_bytes


KIND = SumParties
