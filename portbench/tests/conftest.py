"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``chip`` need a CUDA card and skip without one; on a
machine with a card: ``python -m pytest portbench/tests -q -m chip -o
addopts=""`` (one process drives the card).
"""

import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def test_config():
    """A 255-bit test key (the library's fixed 128-bit test primes)."""
    with open(os.path.join(HERE, "data", "paillier_256.json")) as f:
        return json.load(f)
