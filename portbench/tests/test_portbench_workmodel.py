"""The copied work model reproduces chip_smoke.py's counts and bounds at
the shapes of PERF.md's kernel table, and each request's least time is
what the frozen rules give."""

import importlib.util
import os

import pytest

from portbench import workmodel as wm

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (model, k or L, products, batch, squares, bytes, bound ms in PERF.md)
SHAPES = [
    ("rns", 260, 14 + 16 * 5, 4096, 0, 0, 0.211),       # K5, CH=521
    ("rns", 194, 8 + 1920, 10240, 0, 0, 6.04),          # K2, CH=389
    ("rns", 130, 32 + 1195, 4096, 0, 0, 0.692),         # K2, CH=261, w=6
    ("limb", 257, 14 + 5, 4096, 5 * 4, 0, 0.0744),      # K4, L=257
    ("limb", 129, 14 + 5, 4096, 5 * 4, 0, 0.0188),      # K4, L=129
    ("limb", 257, 1, 4096, 0, 3 * 257 * 4096 * 4, 0.00377),   # K3 bytes
]


@pytest.mark.parametrize("model,k,prods,B,sq,nbytes,ms", SHAPES)
def test_counts_equal_chip_smoke(smoke, model, k, prods, B, sq, nbytes, ms):
    if model == "rns":
        ops, theirs = wm.rns_ops(k, prods, B), smoke.rns_ops(k, prods, B)
    else:
        ops = wm.limb_ops(k, prods, B, sq)
        theirs = smoke.limb_ops(k, prods, B, sq)
    assert ops == theirs
    assert wm.bound(nbytes, ops) == smoke.bound(nbytes, ops)
    got = wm.bound(nbytes, ops)[0]
    assert abs(got - ms) / ms < 0.01, (got, ms)
    assert (wm.HBM_BYTES_PER_S, wm.INT8_OPS_PER_S) == (
        smoke.HBM_BYTES_PER_S, smoke.INT8_OPS_PER_S)


def test_request_work():
    w = wm.Widths({"n_bits": 3072, "nsq_channels": 779, "half_channels": 389,
                   "nsq_limbs": 385, "comb_window": 12}, 1536)
    ops, nbytes = wm.decrypt_work(w, 10240)
    # two halves of 14 + 384 * 5 products at k = 194 a column
    assert ops == 2 * wm.rns_ops(194, 1934, 10240)
    assert nbytes == 10240 * (768 + 8)
    ops, nbytes = wm.encrypt_work(w, 1)
    assert ops == wm.rns_ops(389, 128, 1)
    assert nbytes == 8 + 192 + 768 + 128 * 768
    assert wm.power_products(0) == 0 and wm.power_products(53) == 14 + 70
    assert wm.ctpt_ops(w, [53], 0) == wm.rns_ops(389, 84, 1)
    assert wm.ctpt_ops(w, [1, 1], 2) == (wm.rns_ops(389, 38, 1)
                                         + wm.limb_ops(385, 3, 1))
