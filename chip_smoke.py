#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this repository's checkout (run it from
the repository root).  Imports nothing of JAX.  Phases, each raising on
failure (so any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build the four CUDA kernels from ``pailliercryptolib_python_tpu_torch/
   csrc`` (nvcc, into the package's git-ignored ``build/``);
3. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, exact equality required, with both times;
4. the main path at a 2048-bit key (``fixed_key_ints(2048)``): context and
   comb build, encrypt of 4096 floats x and y, ``x + y``, ``x.sum()``,
   decrypt of both checked against numpy, and the 2048-bit vector of
   ``tests/kat_vectors.json`` through the RNS comb and decrypt;
5. every kernel's launch counter over phase 4 is > 0.

The second-to-last lines are the kernels' JSON record and the card line;
the last line is ``{"ok": true, "device": {...}}``.
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
    "mm3_mul": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont3.py:239"),
    "mm3_exp": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont3.py:306"),
}


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
    """Phase 3: each kernel against its plain twin, exact."""
    import torch
    from pailliercryptolib_python_tpu_torch.ops import (mont3, rns,
                                                        rns_kernels as rk,
                                                        montgomery as mg)
    rng = np.random.default_rng(SEED)
    res = {k: {"max_abs_err": 0, "checks": []} for k in KERNELS}

    def record(name, got, want, shape, ms, plain_ms):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        res[name]["checks"].append(dict(shape=shape, ms=ms,
                                        plain_ms=plain_ms))
        print(f"  {name:14s} {shape:34s} kernel {ms:10.3f} ms   plain "
              f"{plain_ms:10.3f} ms   max|diff| {err}", flush=True)
        if err:
            raise AssertionError(f"{name} differs from its plain twin "
                                 f"at {shape}")

    n, p = kd["n"], kd["p"]
    # K3 (and the moduli K4 runs at): n^2, p^2, p
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
                                                 ctx.off1, ctx.off2), 1))
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
                       ctx.one, ws), 1))
    # K1 at the encrypt (n^2) and decrypt (p^2) bases
    for m, bits in ((n * n, 2 * 2048 + 2), (p * p, (p * p).bit_length())):
        base = rns.RnsBase.for_bits(-(-bits // 16) * 16, dev)
        L = (m.bit_length() + 2 + 15) // 16
        key = rns.RnsModulus.build(base, m, L)
        X = random_state(rng, base, BATCH, dev)
        Y = random_state(rng, base, BATCH, dev)
        got = rk.rns_mul(X, Y, base, key)
        want = rns.rns_mont_mul(X, Y, base, key)
        record("rns_mul", got, want, f"CH={base.CH} B={BATCH}",
               ms_of(lambda: rk.rns_mul(X, Y, base, key), 5),
               ms_of(lambda: rns.rns_mont_mul(X, Y, base, key), 2))
    # K2 at the decrypt base: truncated schedule, B=256 (the plain chain
    # is slow eagerly); then the kernel alone at the full decrypt shape
    window = rk.plan_sched(base.CH)
    e = p - 1
    sched = rns.sliding_schedule(e, window, e.bit_length())
    X = random_state(rng, base, 256, dev)
    short = sched[-64:]
    got = rk.rns_exp_sched_p(X, short, base, key, window)
    want = rns.rns_exp_sched(X, short, base, key, window)
    record("rns_exp_sched", got, want,
           f"CH={base.CH} B=256 w={window} 64 ops",
           ms_of(lambda: rk.rns_exp_sched_p(X, short, base, key, window), 2),
           ms_of(lambda: rns.rns_exp_sched(X, short, base, key, window), 1))
    Xf = random_state(rng, base, BATCH, dev)
    full_ms = ms_of(lambda: rk.rns_exp_sched_p(Xf, sched, base, key,
                                               window), 1)
    print(f"  rns_exp_sched  CH={base.CH} B={BATCH} w={window} "
          f"{len(sched)} ops: kernel {full_ms:.3f} ms", flush=True)
    return res


def main_path(dev, kd, tag: str) -> dict:
    """Phase 4: the README flow at 2048 bits, B=4096, through the port."""
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
    print(f"[3] kernels against their plain twins ({card})", flush=True)
    checks = check_kernels(dev, kd)

    print(f"[4] main path: 2048-bit key, B={BATCH} ({card})", flush=True)
    mp = main_path(dev, kd, card)

    missing = [k for k in KERNELS if mp["counts"][k] <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    print(f"[5] every kernel launched on the main path: {mp['counts']}")

    rec = []
    for k, (src, repl) in KERNELS.items():
        c = checks[k]
        first = c["checks"][0]
        rec.append(dict(name=k, route="cuda", source=src, replaces=repl,
                        launches=mp["counts"][k],
                        max_abs_err=c["max_abs_err"], ms=first["ms"],
                        plain_ms=first["plain_ms"], shape=first["shape"]))
    print(json.dumps({"kernels": rec}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
