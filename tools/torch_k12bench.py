#!/usr/bin/env python3
"""Time kernels K1 (``rns_mul``), K2 (``rns_exp_sched``), K5
(``rns_exp_elem``), K6 (``rns_exp_shared``), K3 (``mm3_mul``), K4
(``mm3_exp``), K7 (``mm3_exp_shared``), K8 (``mm3_sqr``), K9
(``mont_mul``), K10 (``mont_exp``), K11 (``mont_chain``), K12
(``mm2_mul``), K13 (``mm2_sqr``), K14 (``mm2_exp``) and K15
(``mm2_exp_shared``) of the port in one checkout, at their main-path
shapes (K12-K14: the microbench's), on one GPU.

    python3 tools/torch_k12bench.py [TREE]

TREE (default: this repository) is the root of a checkout whose
``pailliercryptolib_python_tpu_torch`` is imported; its kernels build
into that checkout's ``build/``.  To compare two commits on one card,
unpack the other one into a git-ignored directory (``git archive``) and
run the script on both trees in turns (old, new, new, old) on one
card; a variant of a kernel goes in a copy of the package with the
variant's lines changed, run as one more tree.  Shapes: K1 one RNS product at the 2048-bit key's n^2
base (CH=521), B=4096; K2 the decrypt chain of p-1 at the p^2 base
(CH=261, window 6, 1195 schedule entries), B=4096; K5 the ct*pt chain
at the n^2 base, window 4, 16 windows, B=4096, 4095 and 1; K3 one
Montgomery product at n^2 (L=257) and p^2 (L=129), B=4096, 4095, 64
and 1, and B=4096 with b an (L, 1) broadcast; K4 the exponent
alignment's chain (20-bit exponents, windows 3..8) at n^2 (L=257) and
p^2 (L=129), B=4096; K7 the limb decrypt's chain of p-1 at p^2 (L=129,
window 5, 205 windows), B=4096; K6 the fixed-window decrypt chain of p-1
at the p^2 base (CH=261, window 5, 205 windows), B=4096; K10 the fused
decrypt's chain over [p^2]*4096 ++ [q^2]*4096 (L=129, B=8192, the 256
windows of p-1 | q-1) and the keygen window's (256 random 1024-bit odd
moduli, L=65, 256 windows); K9 one product at the fused decrypt's
exit ([p^2]*4096 ++ [q^2]*4096, L=129, B=8192) and on a shared n^2
(L=257, B=4096); K11 the limb encrypt chain (86 factors, L=257, B=4096,
shared n^2), beside one pass of ``torch.sum`` over its 362 MB of
factors (the memory side of its time); K8 one square at n^2 (L=257) and
p^2 (L=129), B=4096; K15 K7's chain (p^2, L=129, window 5, 205 windows)
and 41 windows at a random 4096-bit odd modulus (L=257), B=4096; K12
and K13 one product / square at n^2 (L=257) and p^2 (L=129), B=4096,
with K9 on the same modulus (its limbs given, where K12 recovers them
from the weights) and inputs beside; K14 (K10's chain, its modulus read
from the weights) on the exponent alignment's chain (20-bit exponents,
windows 3..8) at n^2 and p^2, B=4096.  The inputs come from
a fixed seed, so every tree gets the same ones, and the line printed
carries sums of the outputs for a cross-check.  CUDA events, one warm-up
call.  Prints one line ``K12BENCH {json}`` with the card's name and
power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np


def main(argv) -> int:
    import torch
    tree = os.path.abspath(argv[0] if argv else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, tree)
    from pailliercryptolib_python_tpu_torch import kernels
    from pailliercryptolib_python_tpu_torch.ops import (mont, mont2, mont3,
                                                        rns)
    from pailliercryptolib_python_tpu_torch.ops import matmul_mont as mm
    from pailliercryptolib_python_tpu_torch.ops import montgomery as mg
    from pailliercryptolib_python_tpu_torch.ops.limb import (ints_to_limbs,
                                                             to_device)
    from pailliercryptolib_python_tpu_torch.ops import rns_kernels as rk
    from pailliercryptolib_python_tpu_torch.utils.fixtures import \
        fixed_key_ints

    dev = torch.device("cuda", 0)
    kernels.lib()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()

    def ms_of(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def setup(m, bits):
        base = rns.RnsBase.for_bits(-(-bits // 16) * 16, dev)
        key = rns.RnsModulus.build(base, m, (m.bit_length() + 2 + 15) // 16)
        return base, key

    def state(rng, base, B):
        mods = base.mods.cpu().numpy()
        st = (rng.integers(0, 1 << 16, size=(base.CH, B)) % mods).astype(
            np.int32)
        return torch.from_numpy(st).to(dev)

    kd = fixed_key_ints(2048)
    n, p = kd["n"], kd["p"]
    rng = np.random.default_rng(42)
    base, key = setup(n * n, 2 * 2048 + 2)
    X, Y = state(rng, base, 4096), state(rng, base, 4096)
    k1 = ms_of(lambda: rk.rns_mul(X, Y, base, key), 50)
    out1 = rk.rns_mul(X, Y, base, key)
    base, key = setup(p * p, (p * p).bit_length())
    window = rk.plan_sched(base.CH)
    e = p - 1
    sched = rns.sliding_schedule(e, window, e.bit_length())
    Xs = state(rng, base, 4096)
    first = ms_of(lambda: rk.rns_exp_sched_p(Xs, sched, base, key, window),
                  1)
    reps = max(1, min(10, int(2000 // max(first, 1e-3))))
    k2 = ms_of(lambda: rk.rns_exp_sched_p(Xs, sched, base, key, window),
               reps)
    out2 = rk.rns_exp_sched_p(Xs, sched, base, key, window)
    reps_of = lambda first, most: max(1, min(most, int(2000 // max(first,
                                                                   1e-3))))
    k5, sums = {}, {}
    base, key = setup(n * n, 2 * 2048 + 2)
    for B in (4096, 4095, 1):
        X5 = state(rng, base, B)
        dig = rng.integers(0, 16, size=(16, B)).astype(np.int32)
        run = lambda: rk.rns_exp_elem_p(X5, dig, base, key, 4)
        k5[f"CH=521 B={B} 16 windows"] = ms_of(run, reps_of(ms_of(run, 1),
                                                             20))
        sums[f"K5 B={B}"] = int(run().long().sum())
    k3 = {}
    for m in (n * n, p * p):
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        L = ctx.num_limbs
        for B, bc in ((4096, False), (4096, True), (4095, False),
                      (64, False), (1, False)):
            a, b = (to_device(ints_to_limbs(
                [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
                 for _ in range(B)], L), dev) for _ in range(2))
            b = b[:, :1].contiguous() if bc else b
            run = lambda: mont3.mm3_mul(a, b, ctx)
            tag = f"L={L} B={B}" + (" b (L, 1)" if bc else "")
            k3[tag] = ms_of(run, 50)
            sums["K3 " + tag] = int(run().long().sum())
    k4, k7 = {}, {}
    for m in (n * n, p * p):
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        L = ctx.num_limbs
        a = to_device(ints_to_limbs(
            [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
             for _ in range(4096)], L), dev)
        exps = [int(e) for e in rng.integers(1, 1 << 20, size=4096)]
        digits = mg.exponent_digits(exps, 8, 4).astype(np.int32)
        run = lambda: mont3.mm3_exp(a, digits, ctx, 3)
        tag = f"L={L} B=4096 win 3..8"
        k4[tag] = ms_of(run, reps_of(ms_of(run, 1), 20))
        sums["K4 " + tag] = int(run().long().sum())
        if m == p * p:
            window = mont3.shared_exp_window(L)
            e = p - 1
            nwd = -(-e.bit_length() // window)
            dig = mg.exponent_digits([e], nwd, window)[:, 0].astype(
                np.int32)
            run = lambda: mont3.mm3_exp_shared(a, dig, ctx, window)
            tag = f"L={L} B=4096 w={window} {nwd} windows"
            k7[tag] = ms_of(run, reps_of(ms_of(run, 1), 10))
            sums["K7 " + tag] = int(run().long().sum())
    # K6: the fixed-window decrypt chain of p-1 at the p^2 base
    base, key = setup(p * p, (p * p).bit_length())
    e = p - 1
    dig6 = mg.exponent_digits([e], -(-e.bit_length() // 5), 5)[:, 0].astype(
        np.int32)
    X6 = state(rng, base, 4096)
    run = lambda: rk.rns_exp_shared_p(X6, dig6, base, key, 5)
    tag = f"CH={base.CH} B=4096 w=5 {len(dig6)} windows"
    k6 = {tag: ms_of(run, reps_of(ms_of(run, 1), 10))}
    sums["K6 " + tag] = int(run().long().sum())
    # K10: the fused decrypt's per-element chain and the keygen window's
    k10 = {}
    q = kd["q"]
    ms10 = [p * p] * 4096 + [q * q] * 4096
    e10 = mg.exponent_digits([p - 1, q - 1], 256, 4).astype(np.int32)
    dig10 = np.ascontiguousarray(np.concatenate(
        [np.broadcast_to(e10[:, :1], (256, 4096)),
         np.broadcast_to(e10[:, 1:], (256, 4096))], axis=1))
    r = np.random.default_rng(7)
    cands = [int.from_bytes(r.bytes(128), "little") | (1 << 1023) | 1
             for _ in range(256)]
    for mods, L, dig in ((ms10, 129, dig10),
                         (cands, 65, rng.integers(0, 16, size=(256, 256))
                          .astype(np.int32))):
        ctx = mg.MontCtx.for_moduli(mods, L, dev)
        a = to_device(ints_to_limbs(
            [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
             for m in mods], L), dev)
        run = lambda: mont.mont_exp_p(a, dig, ctx.n_limbs, ctx.n0inv,
                                      ctx.one)
        tag = f"L={L} B={len(mods)} 256 windows"
        k10[tag] = ms_of(run, reps_of(ms_of(run, 1), 10))
        sums["K10 " + tag] = int(run().long().sum())
    # K9: the fused decrypt's exit product and a shared n^2 product
    k9 = {}
    c9 = mg.MontCtx.for_moduli(ms10, 129, dev)
    cn = mg.MontCtx.for_modulus(n * n, mxu=False, device=dev)
    for ctx, mods, L, tag in ((c9, ms10, 129, "L=129 B=8192 per-element"),
                              (cn, [n * n] * 4096, 257,
                               "L=257 B=4096 shared")):
        a, b = (to_device(ints_to_limbs(
            [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
             for m in mods], L), dev) for _ in range(2))
        run = lambda: mont.mont_mul_p(a, b, ctx.n_limbs, ctx.n0inv)
        k9[tag] = ms_of(run, 50)
        sums["K9 " + tag] = int(run().long().sum())
    # K11: the limb encrypt chain, 86 pre-gathered factors at n^2
    fac = torch.stack([to_device(ints_to_limbs(
        [int.from_bytes(rng.bytes(2 * 257), "little") % (2 * n * n)
         for _ in range(4096)], 257), dev) for _ in range(86)])
    acc0 = fac[0].clone()
    run = lambda: mont.mont_chain_p(fac, acc0, cn.n_limbs, cn.n0inv)
    tag = "n_win=86 L=257 B=4096 shared"
    k11 = {tag: ms_of(run, reps_of(ms_of(run, 1), 10))}
    sums["K11 " + tag] = int(run().long().sum())
    # the memory side of K11's time: one pass over the same factor bytes
    k11["factor bytes read once (torch sum)"] = ms_of(
        lambda: fac.sum(dtype=torch.int64), 10)
    del fac
    # K8: one square at n^2 (L=257) and p^2 (L=129)
    k8 = {}
    for m in (n * n, p * p):
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        L = ctx.num_limbs
        a = to_device(ints_to_limbs(
            [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
             for _ in range(4096)], L), dev)
        run = lambda: mont3.mm3_sqr(a, ctx)
        tag = f"L={L} B=4096"
        k8[tag] = ms_of(run, 50)
        sums["K8 " + tag] = int(run().long().sum())
    # K15: the limb decrypt's chain of p-1 at p^2 (L=129, window 5, 205
    # windows), and 41 windows of a random exponent at a random 4096-bit
    # odd modulus (L=257)
    k15 = {}
    r15 = np.random.default_rng(15)
    m257 = int.from_bytes(r15.bytes(512), "little") | (1 << 4095) | 1
    for m, L, dig in ((p * p, 129, mg.exponent_digits(
            [p - 1], -(-(p - 1).bit_length() // 5), 5)[:, 0]),
                      (m257, 257, r15.integers(0, 32, size=41))):
        dig = np.ascontiguousarray(dig, dtype=np.int32)
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        mc = mm.MatmulMontCtx(m, L, device=dev)
        a = to_device(ints_to_limbs(
            [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
             for _ in range(4096)], L), dev)
        run = lambda: mont2.mm2_exp_shared(a, dig, mc.W_mu, mc.W_m, ctx.one,
                                           5)
        tag = f"L={L} B=4096 w=5 {len(dig)} windows"
        k15[tag] = ms_of(run, reps_of(ms_of(run, 1), 10))
        sums["K15 " + tag] = int(run().long().sum())
    # K12 and K13 at n^2 (L=257) and p^2 (L=129), K9 on the same shared
    # modulus and inputs beside; K14 the alignment's chain, windows 3..8
    k12, k13, k14 = {}, {}, {}
    for m in (n * n, p * p):
        c9 = mg.MontCtx.for_modulus(m, mxu=False, device=dev)
        L = c9.num_limbs
        mc = mm.MatmulMontCtx(m, L, device=dev)
        w = (mc.W_mu, mc.W_m)
        a, b = (to_device(ints_to_limbs(
            [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
             for _ in range(4096)], L), dev) for _ in range(2))
        tag = f"L={L} B=4096"
        run = lambda: mont2.mm2_mul(a, b, *w)
        k12[tag] = ms_of(run, 50)
        sums["K12 " + tag] = int(run().long().sum())
        run = lambda: mont.mont_mul_p(a, b, c9.n_limbs, c9.n0inv)
        k12[tag + " K9 on the same modulus"] = ms_of(run, 50)
        sums["K9 " + tag + " (K12's inputs)"] = int(run().long().sum())
        run = lambda: mont2.mm2_sqr(a, *w)
        k13[tag] = ms_of(run, 50)
        sums["K13 " + tag] = int(run().long().sum())
        exps = [int(e) for e in rng.integers(1, 1 << 20, size=4096)]
        digits = mg.exponent_digits(exps, 8, 4).astype(np.int32)
        run = lambda: mont2.mm2_exp(a, digits, *w, c9.one, 3)
        tag = f"L={L} B=4096 win 3..8"
        k14[tag] = ms_of(run, reps_of(ms_of(run, 1), 20))
        sums["K14 " + tag] = int(run().long().sum())
    print("K12BENCH " + json.dumps({
        "tree": tree, "card": card, "K1_ms": k1, "K1_shape": "CH=521 B=4096",
        "K2_ms": k2, "K2_shape": f"CH=261 B=4096 w={window} "
                                 f"{len(sched)} ops",
        "K2_reps": reps, "K5_ms": k5, "K3_ms": k3, "K4_ms": k4, "K7_ms": k7,
        "K6_ms": k6, "K10_ms": k10, "K9_ms": k9, "K11_ms": k11,
        "K8_ms": k8, "K15_ms": k15, "K12_ms": k12, "K13_ms": k13,
        "K14_ms": k14,
        "K1_out_sum": int(out1.long().sum()),
        "K2_out_sum": int(out2.long().sum()), "out_sums": sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
