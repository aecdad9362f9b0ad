"""``matmul``: [[d]] @ X, an encrypted vector times a plaintext matrix."""

from __future__ import annotations

from .. import reference as ref
from .. import traffic
from .. import workmodel as wm
from ..systems import RefCts, lower
from . import Kind, faults, plant


class Matmul(Kind):
    """[[d]] @ X: an encrypted vector of `rows` values times a plaintext
    (rows, cols) matrix; `cipher_pool` encrypted vectors, `plain_pool`
    matrices, every pair a variant.  With magnitudes clipped, one row
    (the same in every d and X) holds the smallest d and the smallest X
    values: there the exponents are largest, so every output column's
    alignment shifts by the same widest amount whatever the seed."""

    op = "matmul"

    def __init__(self, spec, seed, index):
        super().__init__(spec, seed, index)
        B, F = spec["rows"], spec["cols"]
        cv, pv = spec["cipher_values"], spec["plain_values"]
        row = int(self.rng.integers(B))
        self.d = [traffic.draw(cv, B, self.rng)
                  for _ in range(spec["cipher_pool"])]
        self.X = [traffic.draw(pv, (B, F), self.rng)
                  for _ in range(spec["plain_pool"])]
        if "magnitude" in cv and "magnitude" in pv:
            for d in self.d:
                plant(d, row, traffic.extremes(cv)[0], self.rng)
            for X in self.X:
                plant(X, row, traffic.extremes(pv)[0], self.rng)
        self.n_variants = len(self.d) * len(self.X)
        self._seen = {}

    def _pair(self, v):
        return divmod(v, len(self.X))

    def setup(self, system):
        self.pools = [system.encrypt(d) for d in self.d]

    def values(self, v):
        return self.spec["rows"] * self.spec["cols"]

    def port(self, system, v):
        a, b = self._pair(v)
        out = self.pools[a] @ self.X[b]
        system.sync()
        return out

    def control(self, system, v):
        a, b = self._pair(v)
        ct, X = self.pools[a], self.X[b]
        xm, xe = ref.encode(lower(X))
        return RefCts(*ref.matmul_mantissas(ct.mants, ct.exps, xm, xe,
                                            *X.shape))

    def expected(self, v):
        a, b = self._pair(v)
        return ref.matmul_expected(self.d[a], self.X[b])

    def judge(self, key, v, got, rng):
        cts, exps = got
        sums, tgt = self.want(v)
        memo = (v, tuple(cts))
        if memo not in self._seen:
            self._seen[memo] = ref.judge_each(key, cts, sums)
        return faults(self._seen[memo], list(map(int, exps)) == tgt)

    def work(self, w, v):
        a, b = self._pair(v)
        B, F = self.X[b].shape
        xm, xe = ref.encode(self.X[b])
        _, de = ref.encode(self.d[a])
        tot = de[:, None] + xe.reshape(B, F)
        shifts = (tot.max(axis=0)[None, :] - tot).reshape(-1)
        ops = (wm.ctpt_ops(w, [abs(m).bit_length() for m in xm],
                           sum(1 for m in xm if m < 0))
               + wm.align_ops(w, shifts) + wm.add_ops(w, F * (B - 1)))
        return ops, B * w.ct_bytes + B * F * 8 + F * w.ct_bytes


KIND = Matmul
