#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this repository's checkout (run it from
the repository root).  Imports nothing of JAX.  Phases, each raising on
failure (so any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build the six CUDA kernels from ``pailliercryptolib_python_tpu_torch/
   csrc`` (one nvcc per source, in parallel, into the package's
   git-ignored ``build/``);
3. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, exact equality required, with both times and the
   kernel's bound;
4. the first slice at a 2048-bit key (``fixed_key_ints(2048)``): context
   and comb build, encrypt of 4096 floats x and y, ``x + y``,
   ``x.sum()``, decrypt of both checked against numpy, and the 2048-bit
   vector of ``tests/kat_vectors.json`` through the RNS comb and decrypt;
5. (after phase 6) every kernel's launch counter is > 0 over the phase
   whose path runs it;
6. the second slice at the same key, B=4096: ``x * w`` (w uniform in
   [-1, 1], about half negative), ``x.dot(w)``, ``x.mean()``, ``x - y``,
   ``2.5 - x``, ``x / 3``, ``v @ W`` and ``W @ v`` (64 ciphertexts, a
   64x64 matrix), ``apply_obfuscator``, a plain-Paillier key (r^n
   obfuscator), every result decrypted and checked against numpy; then
   the ct*pt engines K4 and K5 on the same exponents (equal ciphertexts)
   and the decrypt engines K7 and K2 on the same ciphertexts (equal
   plaintexts), each timed.

Phases 4 and 6 each set the launch counters to 0 just before and read
them just after.  The second-to-last lines are the kernels' JSON record
and the card line; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
SEED = 20261016

KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "rns_mul": ("pailliercryptolib_python_tpu_torch/csrc/rns.cu",
                "pailliercryptolib_python_tpu/ops/pallas_rns.py:578"),
    "rns_exp_sched": ("pailliercryptolib_python_tpu_torch/csrc/rns.cu",
                      "pailliercryptolib_python_tpu/ops/pallas_rns.py:416"),
    "rns_exp_elem": ("pailliercryptolib_python_tpu_torch/csrc/rns.cu",
                     "pailliercryptolib_python_tpu/ops/pallas_rns.py:501"),
    "mm3_mul": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont3.py:239"),
    "mm3_exp": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont3.py:306"),
    "mm3_exp_shared": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                       "pailliercryptolib_python_tpu/ops/pallas_mont3.py"
                       ":391"),
}
FIRST_SLICE = ("rns_mul", "rns_exp_sched", "mm3_mul", "mm3_exp")

# Bounds (published NVIDIA H100 SXM peaks): bytes over the memory rate,
# int8 operations over the int8 tensor-core rate, the larger of the two.
# Work model: one RNS-Montgomery product of one column is two base
# extensions of 4(k+1)k int8 multiply-adds each; one Montgomery product of
# L 16-bit limbs is 2L^2 limb products of 4 int8 multiply-adds each; a
# multiply-add is 2 operations.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def rns_ops(k: int, products: int, B: int) -> int:
    return products * B * 2 * (2 * 4 * (k + 1) * k)


def limb_ops(L: int, products: int, B: int) -> int:
    return products * B * 2 * (4 * 2 * L * L)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: int) -> tuple:
    """(bound_ms, bound_by) for `n_bytes` moved and `ops` int8 operations."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ms_of(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(result, milliseconds) of one call of fn() on the card (CUDA
    events, no warm-up): for the slow plain twins, whose result is the
    one compared."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def wall(fn):
    """(result, seconds) of fn() ending in a device synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def count_ops(fn) -> int:
    """Number of aten ops dispatched while fn runs (each is one or more
    kernel launches on CUDA tensors; the hand-written kernels are not aten
    ops and are counted by kernels.COUNTS instead)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


def random_limbs(rng, m: int, L: int, B: int, dev):
    """(L, B) limbs of B random values below 2m (Montgomery-range input)."""
    from pailliercryptolib_python_tpu_torch.ops.limb import (ints_to_limbs,
                                                             to_device)
    vals = [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
            for _ in range(B)]
    return to_device(ints_to_limbs(vals, L), dev)


def random_state(rng, base, B: int, dev):
    import torch
    mods = base.mods.cpu().numpy()
    st = (rng.integers(0, 1 << 16, size=(base.CH, B)) % mods).astype(np.int32)
    return torch.from_numpy(st).to(dev)


def check_kernels(dev, kd) -> dict:
    """Phase 3: each kernel against its plain twin, exact, with both times
    and the kernel's bound at the same inputs.  Every kernel is checked
    at the main path's shape (its headline record); K2, K5 and K7 also at
    a short chain."""
    import torch
    from pailliercryptolib_python_tpu_torch.ops import (mont3, rns,
                                                        rns_kernels as rk,
                                                        montgomery as mg)
    rng = np.random.default_rng(SEED)
    res = {k: {"max_abs_err": 0, "checks": []} for k in KERNELS}

    def record(name, got, want, shape, ms, plain_ms, n_bytes, ops,
               headline=False):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        b_ms, b_by = bound(n_bytes, ops)
        check = dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by)
        res[name]["checks"].append(check)
        if headline:
            res[name]["headline"] = check
        print(f"  {name:14s} {shape:34s} kernel {ms:10.3f} ms   plain "
              f"{plain_ms:10.3f} ms   bound {b_ms:.6f} ms ({b_by})   "
              f"max|diff| {err}", flush=True)
        if err:
            raise AssertionError(f"{name} differs from its plain twin "
                                 f"at {shape}")

    n, p = kd["n"], kd["p"]
    # K3 (and the moduli K4 / K7 run at): n^2, p^2, p
    for m in (n * n, p * p, p):
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        L = ctx.num_limbs
        a = random_limbs(rng, m, L, BATCH, dev)
        b = random_limbs(rng, m, L, BATCH, dev)
        got = mont3.mm3_mul(a, b, ctx)
        want = mont3.mm3_mul_plain(a, b, ctx.wmu, ctx.wm, ctx.off1, ctx.off2)
        record("mm3_mul", got, want, f"L={L} B={BATCH}",
               ms_of(lambda: mont3.mm3_mul(a, b, ctx), 5),
               ms_of(lambda: mont3.mm3_mul_plain(a, b, ctx.wmu, ctx.wm,
                                                 ctx.off1, ctx.off2), 1),
               nbytes(a, b, got, ctx.n_limbs), limb_ops(L, 1, BATCH),
               headline=m == n * n)
        if m == n * n:
            # K4: short exponents (the exponent-alignment shape), win_start>0
            exps = [int(e) for e in rng.integers(1, 1 << 20, size=BATCH)]
            digits = torch.from_numpy(mg.exponent_digits(exps, 8, 4).astype(
                np.int32)).to(dev)
            ws = 3
            got = mont3.mm3_exp(a, digits, ctx, ws)
            want = mont3.mm3_exp_plain(a, digits, ctx.wmu, ctx.wm, ctx.off1,
                                       ctx.off2, ctx.one, ws)
            record("mm3_exp", got, want, f"L={L} B={BATCH} win 3..8",
                   ms_of(lambda: mont3.mm3_exp(a, digits, ctx, ws), 2),
                   ms_of(lambda: mont3.mm3_exp_plain(
                       a, digits, ctx.wmu, ctx.wm, ctx.off1, ctx.off2,
                       ctx.one, ws), 1),
                   nbytes(a, digits, got, ctx.one, ctx.n_limbs),
                   limb_ops(L, 14 + (8 - ws) * 5, BATCH), headline=True)
        if m == p * p:
            # K7: the limb decrypt's shared exponent p-1, window 5 at
            # L=129: its first 4 windows, then all of them as the decrypt
            # runs it (host digits, as the decrypt passes them)
            window = mont3.shared_exp_window(L)
            e = p - 1
            nwd = -(-e.bit_length() // window)
            dig_all = mg.exponent_digits([e], nwd, window)[:, 0].astype(
                np.int32)
            tbl = (1 << window) - 2
            for dig in (dig_all[:4], dig_all):
                nw = len(dig)
                dig_dev = torch.from_numpy(dig).to(dev)
                got = mont3.mm3_exp_shared(a, dig, ctx, window)
                want, plain_ms = timed(lambda: mont3.mm3_exp_shared_plain(
                    a, dig_dev, ctx.wmu, ctx.wm, ctx.off1, ctx.off2,
                    ctx.one, window))
                record("mm3_exp_shared", got, want,
                       f"L={L} B={BATCH} w={window} {nw} windows",
                       ms_of(lambda: mont3.mm3_exp_shared(a, dig, ctx,
                                                          window), 1),
                       plain_ms, nbytes(a, dig_dev, got, ctx.one,
                                        ctx.n_limbs),
                       limb_ops(L, tbl + nw * (window + 1), BATCH),
                       headline=nw == nwd)
    # K1 at the encrypt (n^2) and decrypt (p^2) bases
    for m, bits in ((n * n, 2 * 2048 + 2), (p * p, (p * p).bit_length())):
        base = rns.RnsBase.for_bits(-(-bits // 16) * 16, dev)
        L = (m.bit_length() + 2 + 15) // 16
        key = rns.RnsModulus.build(base, m, L)
        ops_t = rk.kernel_operands(base, key, dev)
        const_bytes = nbytes(ops_t["vec"], ops_t["skc"], ops_t["E1"],
                             ops_t["E2"])
        X = random_state(rng, base, BATCH, dev)
        Y = random_state(rng, base, BATCH, dev)
        got = rk.rns_mul(X, Y, base, key)
        want = rns.rns_mont_mul(X, Y, base, key)
        record("rns_mul", got, want, f"CH={base.CH} B={BATCH}",
               ms_of(lambda: rk.rns_mul(X, Y, base, key), 5),
               ms_of(lambda: rns.rns_mont_mul(X, Y, base, key), 2),
               nbytes(X, Y, got) + const_bytes, rns_ops(base.k, 1, BATCH),
               headline=m == n * n)
        if m == n * n:
            # K5 at the ct*pt base: 4 windows at B=256, then the main
            # path's shape, B=4096 and 16 windows (53-bit exponents bucket
            # to 16); host digits, as mul_pt passes them
            w = 4
            for B, nw in ((256, 4), (BATCH, 16)):
                Xe = X if B == BATCH else random_state(rng, base, B, dev)
                dig = rng.integers(0, 1 << w, size=(nw, B)).astype(np.int32)
                dig_dev = torch.from_numpy(dig).to(dev)
                got = rk.rns_exp_elem_p(Xe, dig, base, key, w)
                want, plain_ms = timed(lambda: rns.rns_exp_elem(
                    Xe, dig_dev, base, key, w))
                record("rns_exp_elem", got, want,
                       f"CH={base.CH} B={B} w={w} {nw} windows",
                       ms_of(lambda: rk.rns_exp_elem_p(Xe, dig, base, key,
                                                       w), 2),
                       plain_ms, nbytes(Xe, dig_dev, got) + const_bytes,
                       rns_ops(base.k, 14 + nw * (w + 1), B),
                       headline=B == BATCH)
    # K2 at the decrypt base: a truncated schedule at B=256, then the
    # whole decrypt chain of p-1 at B=4096
    window = rk.plan_sched(base.CH)
    e = p - 1
    sched = rns.sliding_schedule(e, window, e.bit_length())
    X = random_state(rng, base, 256, dev)
    short = sched[-64:]
    tbl = 1 + (1 << (window - 1)) - 1
    got = rk.rns_exp_sched_p(X, short, base, key, window)
    want = rns.rns_exp_sched(X, short, base, key, window)
    record("rns_exp_sched", got, want,
           f"CH={base.CH} B=256 w={window} 64 ops",
           ms_of(lambda: rk.rns_exp_sched_p(X, short, base, key, window), 2),
           ms_of(lambda: rns.rns_exp_sched(X, short, base, key, window), 1),
           nbytes(X, got) + 4 * len(short) + const_bytes,
           rns_ops(base.k, tbl + len(short), 256))
    Xf = random_state(rng, base, BATCH, dev)
    got = rk.rns_exp_sched_p(Xf, sched, base, key, window)
    want, plain_ms = timed(lambda: rns.rns_exp_sched(Xf, sched, base, key,
                                                     window))
    record("rns_exp_sched", got, want,
           f"CH={base.CH} B={BATCH} w={window} {len(sched)} ops",
           ms_of(lambda: rk.rns_exp_sched_p(Xf, sched, base, key, window), 1),
           plain_ms, nbytes(Xf, got) + 4 * len(sched) + const_bytes,
           rns_ops(base.k, tbl + len(sched), BATCH), headline=True)
    return res


def main_path(dev, kd, tag: str) -> dict:
    """Phase 4: the first slice's README flow at 2048 bits, B=4096."""
    import torch
    import pailliercryptolib_python_tpu_torch as pt
    from pailliercryptolib_python_tpu_torch import kernels

    rng = np.random.default_rng(SEED + 1)
    x = rng.uniform(-1000.0, 1000.0, BATCH)
    y = rng.uniform(-1000.0, 1000.0, BATCH)
    times = {}
    kernels.reset_counts()

    def keys():
        ipub = pt.ipclPublicKey(kd["n"], kd["bits"], True, kd["hs"],
                                kd["randbits"], device=dev)
        pk = pt.PaillierPublicKey(ipub)
        return pk, pt.PaillierPrivateKey(pk, kd["p"], kd["q"])

    (pk, sk), times["context_build_s"] = wall(keys)
    _, times["comb_build_s"] = wall(lambda: pk.pubkey.context.comb_rns)
    ct_x, times["encrypt_x_s"] = wall(lambda: pk.encrypt(x))
    ct_y, times["encrypt_y_s"] = wall(lambda: pk.encrypt(y))
    ct_s, times["add_s"] = wall(lambda: ct_x + ct_y)
    ct_t, times["sum_s"] = wall(lambda: ct_x.sum())
    got_s, times["decrypt_add_s"] = wall(lambda: sk.decrypt(ct_s))
    got_t, times["decrypt_sum_s"] = wall(lambda: sk.decrypt(ct_t))
    got_x, times["decrypt_x_s"] = wall(lambda: sk.decrypt(ct_x))
    if not np.allclose(got_x, x):
        raise AssertionError("decrypt(encrypt(x)) != x")
    if not np.allclose(got_s, x + y):
        raise AssertionError("decrypt(x + y) != x + y")
    if not np.allclose(got_t, x.sum()):
        raise AssertionError(f"decrypt(sum x) {got_t} != {x.sum()}")
    counts = dict(kernels.COUNTS)
    for k, v in times.items():
        print(f"  {k:18s} {v:10.4f} s   ({tag})", flush=True)
    print(f"  kernel launches over the main path: {counts}", flush=True)

    # aten op counts per encrypt / decrypt (launch-count baseline)
    small = x[:64]
    ct_small = pk.encrypt(small)
    ops_enc = count_ops(lambda: pk.encrypt(small))
    ops_dec = count_ops(lambda: sk.decrypt(ct_small))
    print(f"  aten ops per encrypt call: {ops_enc}, per decrypt call: "
          f"{ops_dec}", flush=True)
    kat(dev, tag)
    return dict(times=times, counts=counts, ops_encrypt=ops_enc,
                ops_decrypt=ops_dec)


def kat(dev, tag: str) -> None:
    """The 2048-bit known-answer vector through the port's RNS comb."""
    import torch
    from pailliercryptolib_python_tpu_torch.models import paillier as sch
    from pailliercryptolib_python_tpu_torch.ops import rns

    with open(os.path.join(HERE, "tests", "kat_vectors.json")) as f:
        vec = next(v for v in json.load(f)["vectors"] if v["bits"] == 2048)
    p, q = int(vec["p"], 16), int(vec["q"], 16)
    n = p * q
    pub = sch.PublicContext(n, n.bit_length(), True, int(vec["hs"], 16),
                            vec["randbits"], device=dev)
    priv = sch.PrivateContext(pub, p, q)
    msgs = [int(m, 16) for m in vec["messages"]]
    rs = [int(r, 16) for r in vec["obfuscator_r"]]
    w, nw = pub.comb_window, -(-pub.randbits // pub.comb_window)
    m_dev = pub.encodings_to_device(msgs)
    digits = np.zeros((nw, m_dev.shape[1]), dtype=np.int32)
    for b, r in enumerate(rs):
        for j in range(nw):
            digits[j, b] = (r >> (w * j)) & ((1 << w) - 1)
    base, key = pub.rns_plan()
    raw = sch._encrypt_raw_canonical(m_dev, pub.n_limbs, pub.L)
    t0 = time.perf_counter()
    ct = rns.rns_comb_product(raw, pub.comb_rns, torch.from_numpy(digits).to(
        dev), base, key, pub.ctx, pub.L)
    if pub.export_cts(ct, len(msgs)) != [int(c, 16)
                                         for c in vec["djn_ciphertexts"]]:
        raise AssertionError("KAT: DJN ciphertexts differ")
    got = priv.decrypt_to_ints(pub.import_cts(
        [int(c, 16) for c in vec["djn_ciphertexts"]]), len(msgs))
    if got != msgs:
        raise AssertionError("KAT: decrypt differs")
    print(f"  KAT 2048: {len(msgs)} DJN ciphertexts and decrypts exact "
          f"({time.perf_counter() - t0:.3f} s incl. comb build, {tag})",
          flush=True)


def second_slice(dev, kd, tag: str) -> dict:
    """Phase 6: ct*pt, the linear algebra, re-randomization, a plain
    Paillier key and the engine comparisons at 2048 bits, B=4096."""
    import pailliercryptolib_python_tpu_torch as pt
    from pailliercryptolib_python_tpu_torch import kernels
    from pailliercryptolib_python_tpu_torch.fixedpoint import encode_vector
    from pailliercryptolib_python_tpu_torch.models import paillier as sch

    rng = np.random.default_rng(SEED + 2)
    x = rng.uniform(-1000.0, 1000.0, BATCH)
    y = rng.uniform(-1000.0, 1000.0, BATCH)
    w = rng.uniform(-1.0, 1.0, BATCH)
    v = rng.uniform(-1000.0, 1000.0, 64)
    W = rng.uniform(-1.0, 1.0, (64, 64))
    times = {}
    kernels.reset_counts()

    def keys(enable_DJN=True):
        ipub = (pt.ipclPublicKey(kd["n"], kd["bits"], True, kd["hs"],
                                 kd["randbits"], device=dev) if enable_DJN
                else pt.ipclPublicKey(kd["n"], kd["bits"], False,
                                      device=dev))
        pk = pt.PaillierPublicKey(ipub)
        return pk, pt.PaillierPrivateKey(pk, kd["p"], kd["q"])

    def check(label, ct, want):
        got, times[f"decrypt_{label}_s"] = wall(lambda: sk.decrypt(ct))
        if not np.allclose(got, want):
            raise AssertionError(f"decrypt({label}) differs from numpy")

    pk, sk = keys()
    ct_x, times["encrypt_x_s"] = wall(lambda: pk.encrypt(x))
    ct_y, times["encrypt_y_s"] = wall(lambda: pk.encrypt(y))
    ct_v = pk.encrypt(v)
    steps = (("x*w", lambda: ct_x * w, x * w),
             ("x.dot(w)", lambda: ct_x.dot(w), x @ w),
             ("x.mean()", lambda: ct_x.mean(), x.mean()),
             ("x-y", lambda: ct_x - ct_y, x - y),
             ("2.5-x", lambda: 2.5 - ct_x, 2.5 - x),
             ("x/3", lambda: ct_x / 3.0, x / 3.0),
             ("v@W", lambda: ct_v @ W, v @ W),
             ("W@v", lambda: W @ ct_v, W @ v))
    for label, fn, want in steps:
        ct, times[label + "_s"] = wall(fn)
        check(label, ct, want)

    # the ct*pt engines on the same 53-bit exponents: K4 (limb) and K5
    ctx = pk.pubkey.context
    encs, _ = encode_vector(w, ctx.n, pk.max_int)
    exps = [ctx.n - e if e >= ctx.n - pk.max_int else e for e in encs]
    ct_dev = ct_x.ciphertext().device_array()
    out5, times["mul_pt_K5_s"] = wall(lambda: ctx.mul_pt(ct_dev, exps))
    limb_ctx = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                                 kd["randbits"], device=dev)
    pt.set_config(decrypt_engine="limb", encrypt_engine="limb")
    try:
        out4, times["mul_pt_K4_s"] = wall(lambda: limb_ctx.mul_pt(ct_dev,
                                                                  exps))
    finally:
        pt.set_config(decrypt_engine="auto", encrypt_engine="auto")
    if ctx.export_cts(out5, BATCH) != ctx.export_cts(out4, BATCH):
        raise AssertionError("ct*pt: the K4 and K5 routes differ")

    # the decrypt engines on the same ciphertexts: K7 (limb) and K2 (RNS)
    pt.set_config(decrypt_engine="limb")
    try:
        sk_limb = pt.PaillierPrivateKey(pk, kd["p"], kd["q"])
    finally:
        pt.set_config(decrypt_engine="auto")
    ints7, times["decrypt_K7_s"] = wall(lambda: sk_limb.raw_decrypt(ct_x))
    ints2, times["decrypt_K2_s"] = wall(lambda: sk.raw_decrypt(ct_x))
    if ints7 != ints2:
        raise AssertionError("decrypt: the K7 and K2 engines differ")
    if not np.allclose(sk_limb.decrypt(ct_x), x):
        raise AssertionError("limb decrypt differs from numpy")

    # re-randomization: every ciphertext changes, the plaintexts do not
    before = ct_x.ciphertext().host_ints()
    _, times["apply_obfuscator_s"] = wall(ct_x.apply_obfuscator)
    after = ct_x.ciphertext().host_ints()
    if any(a == b for a, b in zip(before, after)):
        raise AssertionError("apply_obfuscator left a ciphertext unchanged")
    if sk.raw_decrypt(ct_x) != ints2:
        raise AssertionError("apply_obfuscator changed a plaintext")

    # plain Paillier (no DJN): the r^n obfuscator on K4, 512 windows
    ppk, psk = keys(enable_DJN=False)
    xs = x[:256]
    cp, times["plain_encrypt_256_s"] = wall(lambda: ppk.encrypt(xs))
    got, times["plain_decrypt_256_s"] = wall(lambda: psk.decrypt(cp))
    if not np.allclose(got, xs):
        raise AssertionError("plain-Paillier round trip differs")

    counts = dict(kernels.COUNTS)
    for k, t in times.items():
        print(f"  {k:24s} {t:10.4f} s   ({tag})", flush=True)
    print(f"  kernel launches over phase 6: {counts}", flush=True)
    return dict(times=times, counts=counts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pailliercryptolib_python_tpu_torch import kernels
    from pailliercryptolib_python_tpu_torch.utils.fixtures import \
        fixed_key_ints

    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)

    t0 = time.perf_counter()
    kernels.lib()
    print(f"[2] kernels {kernels.LIB_PATH}: nvcc {kernels.build_seconds} s, "
          f"ready after {time.perf_counter() - t0:.1f} s", flush=True)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("    " + line.strip())

    kd = fixed_key_ints(2048)
    t_all = time.perf_counter()
    print(f"[3] kernels against their plain twins ({card})", flush=True)
    t0 = time.perf_counter()
    checks = check_kernels(dev, kd)
    print(f"    phase 3: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[4] first slice: 2048-bit key, B={BATCH} ({card})", flush=True)
    t0 = time.perf_counter()
    mp = main_path(dev, kd, card)
    print(f"    phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[6] second slice: 2048-bit key, B={BATCH} ({card})", flush=True)
    t0 = time.perf_counter()
    s2 = second_slice(dev, kd, card)
    print(f"    phase 6: {time.perf_counter() - t0:.1f} s", flush=True)

    missing = ([k for k in FIRST_SLICE if mp["counts"][k] <= 0]
               + [k for k in KERNELS if s2["counts"][k] <= 0])
    if missing:
        raise AssertionError(f"a phase never launched {missing}")
    launches = {k: mp["counts"][k] + s2["counts"][k] for k in KERNELS}
    print(f"[5] every kernel launched: phase 4 {mp['counts']}, phase 6 "
          f"{s2['counts']}", flush=True)
    print(f"    phases 3-6: {time.perf_counter() - t_all:.1f} s; library "
          f"call: none (no single PyTorch call computes an RNS product or "
          f"a modular exponentiation)", flush=True)

    rec = []
    for k, (src, repl) in KERNELS.items():
        c = checks[k]
        head = c["headline"]        # the check at the main path's shape
        rec.append(dict(name=k, route="cuda", source=src, replaces=repl,
                        launches=launches[k],
                        max_abs_err=c["max_abs_err"], ms=head["ms"],
                        plain_ms=head["plain_ms"],
                        bound_ms=head["bound_ms"],
                        bound_by=head["bound_by"], library_ms=None,
                        shape=head["shape"], checks=c["checks"]))
    print(json.dumps({"kernels": rec}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
