#!/usr/bin/env python3
"""Per-kernel microbench of the PyTorch/CUDA port: the counterpart of
``tools/kbench.py``.

Usage:
    python tools/torch_kbench.py mul       [--L 257] [--B 1024] [--chain 16]
    python tools/torch_kbench.py sqr       [--L 130] [--B 1024] [--chain 16]
    python tools/torch_kbench.py exp       [--L 257] [--B 2048] [--nwin 256]
    python tools/torch_kbench.py expshared [--L 130] [--B 16384]
                                           [--ebits 1024] [--window 5]
    python tools/torch_kbench.py crt       [--bits 2048] [--B 16384]
    common: [--variants v1,v2,v3,rns,rnssched] [--iters N] [--device cpu]

Variants, on one random modulus m < 2^(16L - 3) per run:
  v1        ``mont.mont_mul_p`` / ``mont_exp_p`` (kernels K9 / K10, CIOS)
  v2        ``mont2`` (K12 mul, K13 sqr, K14 exp, K15 expshared: the
            matmul-Montgomery functions, the modulus given only as the
            nibble weights; all four on the word routine, K14 on K10's
            chain)
  v3        ``mont3`` (K3 mul, K8 sqr, K4 exp, K7 expshared)
  rns       ``rns.rns_exp_shared`` (K6), entered outside the timer, exit
            and ``to_mont`` inside
  rnssched  ``rns_kernels.rns_exp_sched_p`` (K2) on
            ``rns_kernels.plan_sched``'s window
``crt`` times ``PrivateContext.decrypt_to_ints`` at the fixed key of
``--bits`` and each stage of ``profile_stages``.

Each variant prints ``name: ok=<bool>  X ms (Y us/tile-modmul)``, a tile
being 128 columns as in the reference.  ``ok`` holds every column
(``mul``, ``sqr``) or a seeded sample of 64 columns across the batch, the
first and the last included (``exp``, ``expshared``: Python's ``pow``
takes 20-70 ms a column there), against Python's ``pow``, computed once
for all variants; the variants of one function must also agree limb for
limb (every Montgomery result is the unique (T + q*m)/R < 2m;
for ``expshared`` v2 and v3 only, the RNS ones leave through a different
route).  ``main`` returns 1 when a variant is not ok or the variants
disagree; an exception propagates.  Times: CUDA events around ``--iters``
calls after one checked call, or around the checked call with
``--iters 0`` (on ``--device cpu`` the host clock).
Runs on ``cuda`` unless ``--device cpu`` is given; imports nothing of
JAX.  The reference's ``--tb`` (the TPU tile width of v3) has no
counterpart: each CUDA kernel picks its own tiling.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pailliercryptolib_python_tpu_torch.ops import (  # noqa: E402
    matmul_mont as mm, mont, mont2, mont3, montgomery as mg)
from pailliercryptolib_python_tpu_torch.ops.limb import (  # noqa: E402
    ints_to_limbs, limbs_to_ints, to_device)


def timeit(fn, iters: int, dev: torch.device) -> tuple:
    """(last output, seconds per call) of `iters` calls of fn: CUDA events
    around them on a card, the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        return out, (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end) / 1e3 / iters


def rand_modulus(rng, L: int) -> int:
    """Odd modulus with 4m < 2^(16L) (Walter slack)."""
    bits = 16 * L - 3
    m = int.from_bytes(rng.bytes(bits // 8 + 1), "little")
    return (m | (1 << (bits - 1)) | 1) & ((1 << bits) - 1)


def sample_cols(B: int, k: int = 64) -> list:
    """Every column when B <= k, else k seeded columns across the batch,
    the first and the last included."""
    if B <= k:
        return list(range(B))
    pick = np.random.default_rng(B).choice(np.arange(1, B - 1), k - 2,
                                           replace=False)
    return [0, *sorted(int(j) for j in pick), B - 1]


def rand_elems(rng, m: int, B: int) -> list:
    nb = (m.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nb), "little") % m for _ in range(B)]


def report(name, ok, dt, tiles, nmod) -> None:
    per = dt / max(1, nmod) / max(1, tiles) * 1e6
    print(f"{name}: ok={ok}  {dt * 1e3:.2f} ms "
          f"({per:.2f} us/tile-modmul)", flush=True)


def run_variants(variants: dict, oracle_fn, tiles: int, nmod: int,
                 iters: int, dev: torch.device) -> dict:
    """{name: {"ok", "ms", "out"}}: each variant once, timed and checked
    by the oracle, then, unless iters is 0, timed over `iters` calls."""
    res = {}
    for name, fn in variants.items():
        out, dt = timeit(fn, 1, dev)
        ok = bool(oracle_fn(limbs_to_ints(out)))
        if iters:
            dt = timeit(fn, iters, dev)[1]
        report(name, ok, dt, tiles, nmod)
        res[name] = dict(ok=ok, ms=dt * 1e3, out=out)
    return res


def agree(res: dict, names) -> bool:
    """The named variants' outputs are equal limb for limb; printed."""
    outs = [(n, res[n]["out"]) for n in names if n in res]
    ok = all(torch.equal(outs[0][1], o) for _, o in outs[1:])
    if len(outs) > 1:
        print(f"agree {[n for n, _ in outs]}: {ok}", flush=True)
    return ok


def n_iters(args, default: int) -> int:
    return default if args.iters is None else args.iters


def chain(a, K: int, step):
    """A thunk running acc = step(acc) K times from a."""
    def run():
        acc = a
        for _ in range(K):
            acc = step(acc)
        return acc
    return run


def _setup(args, rng, dev):
    """(m, L, R, weightless context, mm3 context) for one random modulus."""
    L = args.L
    m = rand_modulus(rng, L)
    ctx = mg.MontCtx.for_modulus(m, min_bits=16 * L - 2, mxu=False,
                                 device=dev)
    ctx3 = mg.MontCtx.for_modulus(m, min_bits=16 * L - 2, mxu=True,
                                  device=dev)
    return m, L, 1 << (16 * L), ctx, ctx3


def cmd_mul(args, rng, dev) -> dict:
    m, L, R, ctx, ctx3 = _setup(args, rng, dev)
    B, K = args.B, args.chain
    Rinv = pow(R, -1, m)
    xs, ys = rand_elems(rng, m, B), rand_elems(rng, m, B)
    a = to_device(ints_to_limbs(xs, L), dev)
    b = to_device(ints_to_limbs(ys, L), dev)

    def ref(x, y):
        acc = x
        for _ in range(K):
            acc = acc * y * Rinv % m
        return acc
    want = [ref(x, y) for x, y in zip(xs, ys)]

    def oracle(got):
        return all(g % m == w for g, w in zip(got, want))

    variants = {}
    if "v1" in args.variants:
        variants["mul_v1_cios"] = chain(a, K, lambda acc: mont.mont_mul_p(
            acc, b, ctx.n_limbs, ctx.n0inv))
    if "v2" in args.variants:
        mctx = mm.MatmulMontCtx(m, L, device=dev)
        variants["mul_v2_mm"] = chain(a, K, lambda acc: mont2.mm2_mul(
            acc, b, mctx.W_mu, mctx.W_m))
    if "v3" in args.variants:
        variants["mul_v3_byte"] = chain(a, K, lambda acc: mont3.mm3_mul(
            acc, b, ctx3))
    res = run_variants(variants, oracle, B // 128, K, n_iters(args, 5), dev)
    return dict(variants=res, agree=agree(res, list(res)))


def cmd_sqr(args, rng, dev) -> dict:
    m, L, R, _, ctx3 = _setup(args, rng, dev)
    B, K = args.B, args.chain
    Rinv = pow(R, -1, m)
    xs = rand_elems(rng, m, B)
    a = to_device(ints_to_limbs(xs, L), dev)

    def ref(x):
        acc = x
        for _ in range(K):
            acc = acc * acc * Rinv % m
        return acc
    want = [ref(x) for x in xs]

    def oracle(got):
        return all(g % m == w for g, w in zip(got, want))

    variants = {}
    if "v2" in args.variants:
        mctx = mm.MatmulMontCtx(m, L, device=dev)
        variants["sqr_v2_as_mul"] = chain(a, K, lambda acc: mont2.mm2_mul(
            acc, acc, mctx.W_mu, mctx.W_m))
        variants["sqr_v2_sqr"] = chain(a, K, lambda acc: mont2.mm2_sqr(
            acc, mctx.W_mu, mctx.W_m))
    if "v3" in args.variants:
        variants["sqr_v3_byte"] = chain(a, K, lambda acc: mont3.mm3_sqr(
            acc, ctx3))
    res = run_variants(variants, oracle, B // 128, K, n_iters(args, 5), dev)
    return dict(variants=res, agree=agree(res, list(res)))


def cmd_exp(args, rng, dev) -> dict:
    m, L, R, ctx, ctx3 = _setup(args, rng, dev)
    B, n_win = args.B, args.nwin
    baseints = rand_elems(rng, m, B)
    base = to_device(ints_to_limbs([x * R % m for x in baseints], L), dev)
    digs = rng.integers(0, 16, size=(n_win, B)).astype(np.uint32)

    def ref(j):
        e = 0
        for w in range(n_win):
            e = (e << 4) | int(digs[w, j])
        return pow(baseints[j], e, m) * (R % m) % m
    want = {j: ref(j) for j in sample_cols(B)}

    def oracle(got):
        return all(got[j] % m == w for j, w in want.items())

    variants = {}
    if "v1" in args.variants:
        variants["exp_v1_cios"] = lambda: mont.mont_exp_p(
            base, digs, ctx.n_limbs, ctx.n0inv, ctx.one)
    if "v2" in args.variants:
        mctx = mm.MatmulMontCtx(m, L, device=dev)
        variants["exp_v2_mm"] = lambda: mont2.mm2_exp(
            base, digs, mctx.W_mu, mctx.W_m, ctx.one)
    if "v3" in args.variants:
        variants["exp_v3_byte"] = lambda: mont3.mm3_exp(base, digs, ctx3)
    res = run_variants(variants, oracle, B // 128, n_win * 5,
                       n_iters(args, 3), dev)
    return dict(variants=res, agree=agree(res, list(res)))


def cmd_expshared(args, rng, dev) -> dict:
    from pailliercryptolib_python_tpu_torch.ops import rns
    from pailliercryptolib_python_tpu_torch.ops import rns_kernels as rk
    m, L, R, ctx, ctx3 = _setup(args, rng, dev)
    B, ebits, w = args.B, args.ebits, args.window
    baseints = rand_elems(rng, m, B)
    base = to_device(ints_to_limbs([x * R % m for x in baseints], L), dev)
    e = int.from_bytes(rng.bytes(ebits // 8), "little") | (1 << (ebits - 1))
    nw = -(-ebits // w)
    dig = mg.exponent_digits([e], nw, w)[:, 0]

    want = {j: pow(baseints[j], e, m) * (R % m) % m for j in sample_cols(B)}

    def oracle(got):
        return all(got[j] % m == w for j, w in want.items())

    variants = {}
    if "v2" in args.variants:
        mctx = mm.MatmulMontCtx(m, L, device=dev)
        variants[f"expshared_v2_w{w}"] = lambda: mont2.mm2_exp_shared(
            base, dig, mctx.W_mu, mctx.W_m, ctx.one, window=w)
    if "v3" in args.variants:
        variants[f"expshared_v3_w{w}"] = lambda: mont3.mm3_exp_shared(
            base, dig, ctx3, w)
    if {"rns", "rnssched"} & set(args.variants):
        # the RNS-Montgomery engine: enter once outside the timer; chain,
        # exit and to_mont inside, so the oracle sees Montgomery form
        mb = -(-m.bit_length() // 64) * 64
        rbase = rns.RnsBase.for_bits(mb, dev)
        rkey = rns.RnsModulus.build(rbase, m, L)
        X = rns.rns_enter(base, rbase, rkey)

        def leave(Z):
            return mg.to_mont(rns.rns_exit(Z, rbase, rkey, ctx, L), ctx)
    if "rns" in args.variants:
        variants[f"expshared_rns_w{w}_k{rbase.k}"] = lambda: leave(
            rns.rns_exp_shared(X, dig, rbase, rkey, w))
    if "rnssched" in args.variants:
        ws = rk.plan_sched(rbase.CH) or w
        sched = rns.sliding_schedule(e, ws, ebits)
        variants[f"expsched_rns_w{ws}_k{rbase.k}"] = lambda: leave(
            rk.rns_exp_sched_p(X, sched, rbase, rkey, ws))
    res = run_variants(variants, oracle, B // 128, nw * (w + 1),
                       n_iters(args, 3), dev)
    return dict(variants=res, agree=agree(
        res, [f"expshared_v2_w{w}", f"expshared_v3_w{w}"]))


def cmd_crt(args, rng, dev) -> dict:
    """Stage-by-stage decrypt profile at a fixed key."""
    from pailliercryptolib_python_tpu_torch.models import paillier as sch
    from pailliercryptolib_python_tpu_torch.utils.fixtures import \
        fixed_key_ints

    kd = fixed_key_ints(args.bits)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"], device=dev)
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    B = args.B
    vals = [int(v) for v in rng.integers(0, 2**60, size=B)]
    ct = pub.encrypt(vals, apply_obfuscator=False)
    print(f"key {kd['bits']}b  L(n^2)={pub.L}  Lh={priv.Lh}  Lq={priv.Lq}  "
          f"B={B}", flush=True)
    t0 = time.perf_counter()
    out = priv.decrypt_to_ints(ct, B)
    print(f"decrypt_to_ints cold: {time.perf_counter() - t0:.2f} s",
          flush=True)
    ok = out == [v % kd["n"] for v in vals]
    total = timeit(lambda: priv.decrypt_to_ints(ct, B), 1, dev)[1]
    print(f"crt_decrypt_to_ints: ok={ok}  warm {total * 1e3:.0f} ms "
          f"({B / total:.0f} dec/s)", flush=True)
    stages = {}
    for name, fn in priv.profile_stages(ct, B).items():
        t0 = time.perf_counter()
        fn()                        # each thunk synchronizes on CUDA
        stages[name] = time.perf_counter() - t0
        print(f"  {name}: {stages[name] * 1e3:.0f} ms", flush=True)
    return dict(variants={"crt_decrypt_to_ints": dict(
        ok=ok, ms=total * 1e3, out=None)}, agree=True, stages=stages)


COMMANDS = {"mul": cmd_mul, "sqr": cmd_sqr, "exp": cmd_exp,
            "expshared": cmd_expshared, "crt": cmd_crt}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=list(COMMANDS))
    ap.add_argument("--L", type=int, default=257)
    ap.add_argument("--B", type=int, default=1024)
    ap.add_argument("--chain", type=int, default=16)
    ap.add_argument("--nwin", type=int, default=256)
    ap.add_argument("--ebits", type=int, default=1024)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--variants", type=lambda s: s.split(","),
                    default=["v1", "v2", "v3"])
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls per variant after the checked one "
                         "(default: 5 for mul and sqr, 3 for exp and "
                         "expshared; 0 reports the checked call's time)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Parse argv, run the subcommand, return its results: "variants"
    {name: {"ok", "ms", "out"}} and "agree"."""
    args = parse(argv)
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"device: {name}", file=sys.stderr, flush=True)
    return COMMANDS[args.cmd](args, np.random.default_rng(1), dev)


def main(argv=None) -> int:
    res = run(argv)
    ok = res["agree"] and all(v["ok"] for v in res["variants"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
