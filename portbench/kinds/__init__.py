"""The request kinds a traffic mix can name, each found by name.

A mix's ``"op": "<op>"`` is the class ``KIND`` of ``kinds/<op>.py``, so
a later mix brings a new kind as a new file.  A kind draws its plaintext
inputs from the seed when it is made, encrypts its input pools through
the system at set-up (traffic set-up), and issues one request a
``call``: on the port (``port``) the public API call, ending when the
answer is on the host or synchronized on the device; on the control
(``control``) the plain reference one precision below.  It counts the
values a request carries, judges kept answers with the plain reference
(``reference.py``), and gives a request's work for the roofline
(``workmodel.py`` and the reference's own encodings).
"""

from __future__ import annotations

import importlib
import random
import re

import numpy as np

from .. import reference as ref
from .. import traffic
from .. import workmodel as wm


def load(op: str) -> type:
    """The class of request kind `op` (``kinds/<op>.py``, its ``KIND``)."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", op):
        raise ValueError(f"not a request kind: {op!r}")
    return importlib.import_module(f"{__name__}.{op}").KIND


def make(mix: dict, seed: int) -> list:
    """The mix's request kinds, each drawing its inputs from the seed."""
    return [load(o["op"])(o, seed, i) for i, o in enumerate(mix["ops"])]


def faults(value_ok: bool, exponent_ok: bool = True) -> list:
    return ([] if value_ok else ["value"]) \
        + ([] if exponent_ok else ["exponent"])


def plant(x: np.ndarray, where, magnitude: float, rng) -> None:
    """Set x[where] to +-magnitude, signs from the seed."""
    x[where] = magnitude * rng.choice([-1.0, 1.0], np.shape(x[where]))


class Kind:
    op = ""
    keep = 0             # answers kept for the judge: 0 keeps all
    fresh = False        # each answer's ciphertexts carry new obfuscators

    def __init__(self, spec: dict, seed: int, index: int):
        self.spec = spec
        self.rng = np.random.default_rng([seed, traffic.STREAM_VALUES, index])
        self.n_variants = 1
        self.pools = []
        self._want = {}

    def setup(self, system) -> None:
        pass

    def release(self) -> None:
        """Drop the input pools kept on the device."""
        self.pools = []

    def warm_variants(self) -> list:
        """The variants whose shapes the warm-up runs: one of each shape."""
        return [0]

    def values(self, v: int) -> int:
        raise NotImplementedError

    def call(self, system, v: int):
        return (self.control if system.control else self.port)(system, v)

    def port(self, system, v: int):
        raise NotImplementedError

    def control(self, system, v: int):
        raise NotImplementedError

    def collect(self, system, answer):
        """The kept answer in host form, for the judge."""
        return system.export(answer)

    def judge(self, key: ref.Key, v: int, got, rng: random.Random) -> list:
        """What is wrong with one answer: [] when it is right, else among
        "value", "exponent"."""
        raise NotImplementedError

    def work(self, w: wm.Widths, v: int) -> tuple:
        raise NotImplementedError

    def expected(self, v: int):
        raise NotImplementedError

    def want(self, v: int):
        if v not in self._want:
            self._want[v] = self.expected(v)
        return self._want[v]
