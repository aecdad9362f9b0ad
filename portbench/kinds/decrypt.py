"""``decrypt``: a batch of ciphertexts decrypted to floats."""

from __future__ import annotations

import numpy as np

from .. import reference as ref
from .. import traffic
from .. import workmodel as wm
from . import Kind, faults


class Decrypt(Kind):
    """Decrypt a batch of `batch` ciphertexts to floats; `pool` batches
    encrypted at set-up, each a variant."""

    op = "decrypt"

    def __init__(self, spec, seed, index):
        super().__init__(spec, seed, index)
        self.x = [traffic.draw(spec["values"], spec["batch"], self.rng)
                  for _ in range(spec["pool"])]
        self.n_variants = len(self.x)

    def setup(self, system):
        self.pools = [system.encrypt(x) for x in self.x]

    def values(self, v):
        return self.spec["batch"]

    def port(self, system, v):
        return system.decrypt(self.pools[v])

    control = port

    def collect(self, system, answer):
        return answer

    def expected(self, v):
        m, e = ref.encode(self.x[v])
        return np.asarray([ref.decode(a, b) for a, b in zip(m, e)])

    def judge(self, key, v, got, rng):
        want = self.want(v)
        return faults(got.shape == want.shape
                      and bool(np.array_equal(got, want)))

    def work(self, w, v):
        return wm.decrypt_work(w, self.spec["batch"])


KIND = Decrypt
