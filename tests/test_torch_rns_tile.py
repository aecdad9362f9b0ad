"""The tile layout of kernels K1, K2, K5 and K6 (``csrc/rns_tile.cuh``) on
the CPU: the extension matrices W1, W2 and their mma fragment order, and
the plain PyTorch version of the tile product (``rns_kernels.rns_mul_tile``,
its chains ``rns_exp_sched_tile``, ``rns_exp_elem_tile`` and
``rns_exp_shared_tile``), which must equal the port's RNS product and the
JAX package's bit for bit; K5's and K6's tile-by-tile table index; plus
the device-kept digits and schedules (``kernels.digit_tensor``,
``PrivateContext.device_digits``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pailliercryptolib_python_tpu.ops import pallas_rns as jpr
from pailliercryptolib_python_tpu.ops import rns as jr
from pailliercryptolib_python_tpu.utils.fixtures import (P_1024, Q_1024,
                                                         fixed_key_ints)
from pailliercryptolib_python_tpu_torch import kernels
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import rns as tr
from pailliercryptolib_python_tpu_torch.ops import rns_kernels as trk

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
# (mbits, m): the 256-bit key's p^2, a 1024-bit modulus (the size of a
# 512-bit key's n^2) and a 2048-bit one (a 1024-bit key's n^2, and the
# size of the 2048-bit key's p^2, the decrypt chain's base)
CASES = [(256, KD["p"] ** 2), (1024, P_1024), (2048, P_1024 * Q_1024)]
IDS = ["256", "1024", "2048"]
B = 37                      # not a multiple of the tile's 32 columns


def _setup(mbits, m):
    L = (m.bit_length() + 2 + 15) // 16
    jb = jr.RnsBase.for_bits(mbits)
    tb = tr.RnsBase.for_bits(mbits, CPU)
    return (jb, jr.RnsModulus.build(jb, m, L), tb,
            tr.RnsModulus.build(tb, m, L))


def _states(rng, tb, B):
    mods = tb.mods.numpy()
    return (rng.integers(0, 1 << 16, size=(tb.CH, B)) % mods).astype(
        np.int32)


def _same(port, ref):
    p = port.numpy().astype(np.int64) if isinstance(port, torch.Tensor) \
        else np.asarray(port).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


@pytest.mark.parametrize("mbits,m", CASES, ids=IDS)
def test_tile_weights_layout(mbits, m):
    _, _, tb, tk = _setup(mbits, m)
    ops = trk.kernel_operands(tb, tk, CPU)
    k, KP = tb.k, ops["KP"]
    o = k + 1
    E1 = np.asarray(trk.pack(mbits, m)["E1"]).astype(np.int64) + 128
    for W, Wf in ((ops["W1"], ops["W1f"]), (ops["W2"], ops["W2f"])):
        W = W.numpy()
        assert W.dtype == np.uint8
        assert W.shape[0] % trk.MMA_M == 0 and W.shape[1] % trk.MMA_K == 0
        assert W.shape == (-(-2 * o // 16) * 16, 2 * KP)
        # padding: rows past 2o, columns [k, KP) and [KP + k, 2KP)
        assert not W[2 * o:].any()
        assert not W[:, k:KP].any() and not W[:, KP + k:].any()
        # the fragment order is a permutation of W's bytes
        MT, KS = W.shape[0] // 16, W.shape[1] // 32
        back = Wf.numpy().reshape(MT, KS, 8, 4, 2, 2, 4).transpose(
            0, 5, 2, 1, 4, 3, 6).reshape(W.shape)
        assert np.array_equal(back, W)
    # rows interleave S_A (C_lo | D_lo) and S_B (C_hi | D_hi) of one j
    W1 = ops["W1"].numpy().astype(np.int64)
    assert np.array_equal(W1[0:2 * o:2, :k], E1[:o])
    assert np.array_equal(W1[1:2 * o:2, :k], E1[o:2 * o])
    assert np.array_equal(W1[0:2 * o:2, KP:KP + k], E1[2 * o:3 * o])
    assert np.array_equal(W1[1:2 * o:2, KP:KP + k], E1[3 * o:])
    # key-independent: another modulus at the same base gives equal W
    other = tr.RnsModulus.build(tb, m + 2, (m.bit_length() + 17) // 16)
    ops2 = trk.kernel_operands(tb, other, CPU)
    assert torch.equal(ops2["W1f"], ops["W1f"])
    assert torch.equal(ops2["W2f"], ops["W2f"])


@pytest.mark.parametrize("mbits,m", CASES, ids=IDS)
def test_tile_product_equals_both_packages(mbits, m):
    jb, jk, tb, tk = _setup(mbits, m)
    ops = trk.kernel_operands(tb, tk, CPU)
    rng = np.random.default_rng(mbits)
    X, Y = _states(rng, tb, B), _states(rng, tb, B)
    got = trk.rns_mul_tile(torch.from_numpy(X), torch.from_numpy(Y), tb, tk,
                           ops)
    assert got.dtype == torch.int32 and got.shape == (tb.CH, B)
    _same(got, tr.rns_mont_mul(torch.from_numpy(X), torch.from_numpy(Y), tb,
                               tk))
    _same(got, jr.rns_mont_mul(jnp.asarray(X.astype(np.uint32)),
                               jnp.asarray(Y.astype(np.uint32)), jb, jk))
    # the extension sums stay below 2^31 (exact in the mma's int32)
    assert 2 * tb.k * 255 * 255 < (1 << 31)


@pytest.mark.parametrize("window,n_ops", [(4, 24), (5, 40)])
def test_tile_chain_equals_both_packages(window, n_ops):
    mbits, m = CASES[0]
    jb, jk, tb, tk = _setup(mbits, m)
    ops = trk.kernel_operands(tb, tk, CPU)
    rng = np.random.default_rng(window)
    X = _states(rng, tb, B)
    e = KD["p"] - 1
    sched = tr.sliding_schedule(e, window, e.bit_length())[-n_ops:]
    assert sched.max() > 0 and (sched == 0).any()
    got = trk.rns_exp_sched_tile(torch.from_numpy(X), sched, tb, tk, window,
                                 ops)
    _same(got, tr.rns_exp_sched(torch.from_numpy(X), sched, tb, tk, window))
    _same(got, jr.rns_exp_sched(jnp.asarray(X.astype(np.uint32)),
                                jnp.asarray(sched), jb, jk, window))
    # the wrapper's CPU route is the plain twin and agrees
    _same(trk.rns_exp_sched_p(torch.from_numpy(X), sched, tb, tk, window),
          got)


@pytest.mark.parametrize("mbits,m", [CASES[0], CASES[2]],
                         ids=[IDS[0], IDS[2]])
def test_tile_elem_chain_equals_both_packages(mbits, m, monkeypatch):
    monkeypatch.setattr(jpr, "INTERPRET", True)
    jb, jk, tb, tk = _setup(mbits, m)
    ops = trk.kernel_operands(tb, tk, CPU)
    rng = np.random.default_rng(mbits + 5)
    X = _states(rng, tb, B)
    window, n_win = 4, 2
    digits = rng.integers(0, 1 << window, size=(n_win, B)).astype(np.int32)
    digits[0, :16] = np.arange(16)              # every digit, 0 included
    got = trk.rns_exp_elem_tile(torch.from_numpy(X), digits, tb, tk, window,
                                ops)
    assert got.dtype == torch.int32 and got.shape == (tb.CH, B)
    _same(got, tr.rns_exp_elem(torch.from_numpy(X), torch.from_numpy(digits),
                               tb, tk, window))
    jX = jnp.asarray(X.astype(np.uint32))
    _same(got, jr.rns_exp_elem(jX, jnp.asarray(digits), jb, jk, window))
    _same(got, jpr.rns_exp_elem_p(jX, jnp.asarray(digits), jb, jk, window))
    # the wrapper's CPU route is the plain twin and agrees
    _same(trk.rns_exp_elem_p(torch.from_numpy(X), digits, tb, tk, window),
          got)


@pytest.mark.parametrize("window,digits", [(4, [0, 15, 3]), (5, [31, 0, 7])],
                         ids=["w4", "w5"])
def test_tile_shared_chain_equals_both_packages(window, digits,
                                                monkeypatch):
    """K6's chain over the tile product (``rns_exp_shared_tile``: the
    table tile by tile, the shared digit indexing it) equals the port's
    plain twin, the JAX package's jnp chain and its Pallas kernel
    (``_exp_call`` through ``rns_exp_shared_p``, interpret mode)."""
    monkeypatch.setattr(jpr, "INTERPRET", True)
    jb, jk, tb, tk = _setup(*CASES[0])
    ops = trk.kernel_operands(tb, tk, CPU)
    X = _states(np.random.default_rng(window), tb, B)
    dig = np.array(digits, dtype=np.int32)
    got = trk.rns_exp_shared_tile(torch.from_numpy(X), dig, tb, tk, window,
                                  ops)
    assert got.dtype == torch.int32 and got.shape == (tb.CH, B)
    _same(got, tr.rns_exp_shared_plain(torch.from_numpy(X), dig, tb, tk,
                                       window))
    jX = jnp.asarray(X.astype(np.uint32))
    _same(got, jr.rns_exp_shared(jX, jnp.asarray(dig), jb, jk, window))
    _same(got, jpr.rns_exp_shared_p(jX, jnp.asarray(dig), jb, jk, window))
    # the wrapper's CPU route is the plain twin and agrees
    _same(trk.rns_exp_shared_p(torch.from_numpy(X), dig, tb, tk, window),
          got)


def test_shared_chain_reads_its_table_tile_by_tile(monkeypatch):
    """K6's model places and reads every entry through
    ``elem_table_index``, the layout of the kernel's scratch: all 2^w
    entries, each (channel, column) inside its own column's tile."""
    jb, jk, tb, tk = _setup(*CASES[0])
    ops = trk.kernel_operands(tb, tk, CPU)
    X = torch.from_numpy(_states(np.random.default_rng(3), tb, B))
    dig = np.array([2, 3], dtype=np.int32)
    want = trk.rns_exp_shared_tile(X, dig, tb, tk, 2, ops)
    real = trk.elem_table_index
    seen = []

    def record(t, c, col, CH, window):
        idx = real(t, c, col, CH, window)
        seen.append((t, idx // ((1 << window) * CH * trk.TILE_COLS), col))
        return idx

    monkeypatch.setattr(trk, "elem_table_index", record)
    _same(trk.rns_exp_shared_tile(X, dig, tb, tk, 2, ops), want)
    assert sorted({t for t, _, _ in seen}) == [0, 1, 2, 3]
    for _, tile, col in seen:
        assert bool((tile == col // trk.TILE_COLS).all())


def test_elem_table_index_is_tile_by_tile():
    CH, window, Bt = 5, 3, 70                   # three tiles, the last short
    tiles = -(-Bt // trk.TILE_COLS)
    tab = np.arange(tiles * (1 << window) * CH * trk.TILE_COLS).reshape(
        tiles, 1 << window, CH, trk.TILE_COLS)
    for t, c, col in ((0, 0, 0), (7, 4, 69), (3, 2, 31), (5, 1, 32)):
        assert trk.elem_table_index(t, c, col, CH, window) == \
            tab[col // 32, t, c, col % 32]
    # as tensors, one (CH, B) entry at once: every index once per entry
    c = torch.arange(CH)[:, None]
    col = torch.arange(Bt)[None, :]
    idx = torch.stack([trk.elem_table_index(t, c, col, CH, window)
                       for t in range(1 << window)])
    assert idx.unique().numel() == idx.numel() == (1 << window) * CH * Bt
    # one entry of one tile is one contiguous block of CH x 32
    blk = idx[2, :, :32].flatten().sort().values
    assert torch.equal(blk, torch.arange(int(blk[0]), int(blk[0]) + CH * 32))


class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_checked_digits_may_stay_on_the_device():
    d = kernels.digit_tensor(np.array([[0, 15], [3, 7]]), 4, CPU)
    assert d.dtype == torch.int32 and d.checked_below == 16
    fake = d.as_subclass(_OnDevice)
    with pytest.raises(ValueError, match="on the host"):
        kernels.digit_tensor(fake, 4, CPU)            # no bound carried
    fake.checked_below = 16
    assert kernels.digit_tensor(fake, 4, CPU) is fake
    assert kernels.digit_tensor(fake, 5, CPU) is fake   # a wider window
    with pytest.raises(ValueError, match="on the host"):
        kernels.digit_tensor(fake, 3, CPU)             # checked too loosely
    s = trk.schedule_tensor(np.array([0, 8, 1]), 4, CPU)
    assert s.checked_below == 9
    fake = s.as_subclass(_OnDevice)
    fake.checked_below = s.checked_below
    assert trk.schedule_tensor(fake, 4, CPU) is fake
    with pytest.raises(ValueError, match="out of range"):
        trk.schedule_tensor(np.array([0, 9]), 4, CPU)


def test_private_context_keeps_digits_once():
    pub = tsch.PublicContext(KD["n"], KD["bits"], True, KD["hs"],
                             KD["randbits"], device=CPU)
    priv = tsch.PrivateContext(pub, KD["p"], KD["q"])
    for name in ("dig_p", "dig_q", "rdig_p", "rdig_q", "rsched_p",
                 "rsched_q"):
        t = priv.device_digits(name)
        assert priv.device_digits(name) is t
        assert np.array_equal(t.numpy(), np.asarray(getattr(priv, name)))
    cols = priv.device_digits("exp_digits_pq", 8)
    assert cols.shape == (priv.n_win_dec, 16)
    assert np.array_equal(cols.numpy()[:, :8], np.repeat(
        priv.exp_digits_pq[:, :1], 8, axis=1))
    assert priv.device_digits("exp_digits_pq", 8) is cols
    assert priv.device_digits("exp_digits_pq", 4).shape[1] == 8
    # a replaced host array is copied again
    priv.rsched_p = priv.rsched_p.copy()
    t = priv.device_digits("rsched_p")
    assert priv.device_digits("rsched_p") is t
