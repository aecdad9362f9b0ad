"""``sharded_sum``: one round of federated aggregation over the cards."""

from __future__ import annotations

import numpy as np

from .. import traffic
from .. import workmodel as wm
from ..systems import RefCts, lower
from . import Kind, faults


class ShardedSum(Kind):
    """One aggregation round (the JAX package's ``bench.py``
    ``federated_1m``): `parties` encrypted updates of `batch` integer
    values each, split by column over the ranks (``columns``), combined
    elementwise and reduced to one encrypted total, the same on every
    rank.  `pool` rounds are encrypted at set-up, each a variant, every
    column its own ciphertext.  The answer is the total's ciphertext; the
    judge decrypts it against the exact sum of every value mod n."""

    op = "sharded_sum"
    keep = 16

    def __init__(self, spec, seed, index):
        super().__init__(spec, seed, index)
        P, B = spec["parties"], spec["batch"]
        if B * spec["values"]["high"] >= 1 << 63:
            raise ValueError("a party's sum must fit in int64")
        self.x = [traffic.draw(spec["values"], (P, B), self.rng)
                  for _ in range(spec["pool"])]
        self.n_variants = len(self.x)
        self.columns, self.world = B, 1

    def setup(self, system):
        if system.control:
            return
        lo, hi = system.columns(self.spec["batch"])
        self.columns, self.world = hi - lo, system.world
        self.pools = [[system.encrypt_ints(row[lo:hi]) for row in xs]
                      for xs in self.x]

    def values(self, v):
        return self.spec["parties"] * self.spec["batch"]

    def port(self, system, v):
        total = system.sharded_sum(self.pools[v])
        system.sync()
        return total

    def control(self, system, v):
        m = sum(int(r.sum()) for r in lower(self.x[v]).astype(np.int64))
        return RefCts([m], [0])

    def collect(self, system, answer):
        if system.control:
            return system.export(answer)[0]
        return system.export_total(answer)

    def expected(self, v):
        return sum(int(r.sum()) for r in self.x[v])

    def judge(self, key, v, got, rng):
        return faults(len(got) == 1
                      and key.decrypt(got[0]) == self.want(v) % key.n)

    def work(self, w, v):
        """This rank's: the parties' elementwise products, the tree over
        its columns, the fold of the ranks' partials; the parties'
        ciphertexts read once, the total written once."""
        P, B = self.spec["parties"], self.columns
        products = (P - 1) * B + (B - 1) + (self.world - 1)
        return wm.add_ops(w, products), (P * B + 1) * w.ct_bytes


KIND = ShardedSum
