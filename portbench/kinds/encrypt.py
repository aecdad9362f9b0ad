"""``encrypt``: a vector of floats encrypted, each with a new obfuscator."""

from __future__ import annotations

import numpy as np

from .. import reference as ref
from .. import traffic
from .. import workmodel as wm
from . import Kind, faults


class Encrypt(Kind):
    """Encrypt a vector of floats whose size is drawn from `batch`; each
    size is a variant with its own values.  Every ciphertext carries an
    obfuscator of its own (``fresh``): the run compares them across the
    kept answers, two of one variant among them."""

    op = "encrypt"
    keep = 16
    fresh = True

    def __init__(self, spec, seed, index):
        super().__init__(spec, seed, index)
        self.sizes = traffic.sizes(spec["batch"])
        self.x = [traffic.draw(spec["values"], b, self.rng)
                  for b in self.sizes]
        self.n_variants = len(self.sizes)

    def warm_variants(self):
        return list(range(self.n_variants))

    def values(self, v):
        return self.sizes[v]

    def port(self, system, v):
        out = system.encrypt(self.x[v])
        system.sync()
        return out

    control = port

    def expected(self, v):
        return ref.encode(self.x[v])

    def judge(self, key, v, got, rng):
        cts, exps = got
        mant, want_e = self.want(v)
        return faults(ref.judge_combined(key, cts, mant, rng),
                      bool(np.array_equal(exps, want_e)))

    def work(self, w, v):
        return wm.encrypt_work(w, self.sizes[v])


KIND = Encrypt
