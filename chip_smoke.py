#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and this repository's checkout (run it from
the repository root).  Imports nothing of JAX.  Phases, each raising on
failure (so any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build the fifteen CUDA kernels from ``pailliercryptolib_python_tpu_torch/
   csrc`` (one nvcc per source, in parallel, into the package's
   git-ignored ``build/``), with the ``-Xptxas -v`` report of the tile
   kernels K1, K2, K5, K6 (``csrc/rns_tile.cuh``) and K3, K4, K7
   (``csrc/mm3_tile.cuh``), the shared memory their launches ask for,
   and their tensor-core (IMMA) instructions in the SASS where the
   toolkit has ``cuobjdump`` (none is a failure), and the registers,
   stack and local memory of the instantiations of K8-K15 (the
   cooperative routine of ``csrc/coop.cuh``) at the main path's shapes
   (K12-K14: the microbench's; a spill in one of them is a failure);
3. each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, exact equality required, with both times and the
   kernel's bound (K1, K2 and K5 also at a ragged batch and at one
   column, K2 also where W1, W2 do not fit shared memory; K3 at L=257
   and 129 also at B=4095, 64, 1 and with b an (L, 1) broadcast, and at
   L=520, its largest, B=64; K9 and
   K10 at the fused CRT decrypt's shape, K10's eager twin alone ~32 s,
   K9 and K10 also at the keygen shape (K10 both window ranges), K10 at
   B=1 and a ragged B, with a shared (L, 1) modulus, and at L=520 and
   1040 (its largest); K9 on a weightless n^2 also against K3; every K9,
   K10 and K11 row with its integer-pipe floor and (g, K) beside; K4 at
   n^2 (windows 3..8 at B=4096; all 16 windows, every digit 0..15, at
   B=4095 and 1) and at
   p^2, there also against K10, and at L=520, B=64; K7 at p^2 (4 windows
   and the whole chain at B=4096, 4 windows at B=1), at a 4096-bit key's
   p^2 (L=257) and at L=520, where its table entry is read from global
   memory instead of staged; K6 at the
   decrypt chain's shape, a short chain at B=256, 4095 and 1, and where
   W1, W2 are read from global memory (CH=521); K8 at L=257/129/65 also
   against K3(a, a),
   K11 at the limb encrypt chain's shape also against the streamed K3
   chain (both timed), at B=4095 and 1 (8 factors), and per-element
   against a K9 loop; the v2 kernels K12 at L=257/129 also against K3
   and against K9 on the same shared modulus (K9 timed beside), K13 at
   L=257/129/65 also against K8 and K12(a, a), both at L=520, B=64 and
   over L = 2 to 520 (every fifth L, and 519, 520) at B=33 against K9
   and their twins, K14 at L=257 and 129 (windows 3..8), at B=4095 and
   1 (16 windows), with win_start = n_win and at L=520, B=64 also
   against K4 and K10 on the same modulus, K15 at K7's decrypt shape,
   at L=257 and at L=520, B=64 also against K7; every K8 and K12-K15 row
   with its integer-pipe floor and (g, K) beside); then the ladder's
   shapes (``check_ladder_kernels``: 1024-, 3072- and 4096-bit moduli
   at their rung's batch, B=256, 10240, 256): K1 at CH=263, 779, 1039,
   K3 at L=65, 129, 193, 385, 257, 513, K4 at L=385 and 513, K5 at
   CH=779 and 1039 (16 windows, and 1,024 at 4096 bits), K2 over the
   whole schedule of p-1 at CH=133 (W1, W2 in shared memory) and
   CH=389 (B=10240) and 519 (reading them from global memory), K7 at
   L=193, K9 and K10 at keygen's L=97 and 129;
4. the first slice at a 2048-bit key (``fixed_key_ints(2048)``): context
   and comb build, encrypt of 4096 floats x and y, ``x + y``,
   ``x.sum()``, decrypt of both checked against numpy, and the 2048-bit
   vector of ``tests/kat_vectors.json`` through the RNS comb and decrypt;
5. (after phase 11) every kernel's launch counter is > 0 over the phase
   whose path runs it;
6. the second slice at the same key, B=4096: ``x * w`` (w uniform in
   [-1, 1], about half negative), ``x.dot(w)``, ``x.mean()``, ``x - y``,
   ``2.5 - x``, ``x / 3``, ``v @ W`` and ``W @ v`` (64 ciphertexts, a
   64x64 matrix), ``apply_obfuscator``, a plain-Paillier key (r^n
   obfuscator), every result decrypted and checked against numpy;
   decrypt, ``+``, ``x * w``, ``dot`` and ``@`` once more under
   ``torch.cuda.set_sync_debug_mode`` (no host synchronization, but for
   the inversion tree's root read back where a weight is negative); then
   the ct*pt engines K4 and K5 on the same exponents (equal ciphertexts)
   and the decrypt engines K7 and K2 on the same ciphertexts (equal
   plaintexts), each timed;
7. the third slice at 2048 bits: keygen with the device-batched base-2
   Miller-Rabin (``keygen_device="1"``: K10, K9) whose key round-trips
   4096 floats, and a host keygen; ``device_mr_base2`` against the host
   oracle on one sieve window's survivors; the limb encrypt engine (its
   comb build, ciphertexts equal to the RNS engine's under the same
   digits, ``apply_obfuscator``, decrypt); the fused per-element CRT
   decrypt stage (K10) against K7's two halves and K2; a weightless n^2
   context (K9 against K3, K10 against K4 on phase 6's exponents);
8. the fourth slice at 2048 bits, B=4096: the hybrid modes (pipelined
   encrypt in 1, 2, 4 and 8 chunks), the host/device split after
   ``context.initializeContext`` (a tenth of the batch, and then 64
   values, go through Python's ``pow`` on the host thread), the K6
   decrypt halves against K2's, the limb decrypt (K7) against the fused
   K10 stage and K2, the fused
   encrypt chain (K11)
   against the streamed one, ``profile_stages`` under
   ``profiling.timed`` and one ``profiling.trace``, and the comb LRU
   registry under a budget for two of three keys;
9. the fifth slice: ``tools/torch_kbench.py``'s subcommands in-process
   at full width (``mul`` L=257, ``sqr`` L=129, ``exp`` L=257 with 256
   windows, ``expshared`` L=129 with a 1024-bit exponent, all B=4096;
   ``crt`` at the 2048-bit key), every variant ok against Python's
   ``pow`` and the variants of one function equal limb for limb;
10. the sixth slice, the sharded layer (``parallel/``) in a world-size-1
   NCCL group at 2048 bits, B=4096: ``sharded_decrypt``,
   ``sharded_mul_pt``, ``sharded_he_sum`` and ``federated_aggregate`` of
   3 parties against the unsharded ops limb for limb, each timed beside
   it, no collective inside the decrypt and ct*pt chains and one
   all-gather in the sum (``count_collectives``), ``entry()``'s encrypt
   step and ``dryrun_multichip(1)``; the group is destroyed at the end;
11. the key ladder of the reference's own configurations (``LADDER``),
   end to end through the public API on the default engines: at 1024
   bits, B=256, ``examples/torch_paillier_example.py`` and
   ``examples/torch_federated_example.py`` (its own world-size-1 NCCL
   group) in this process; at 3072 bits, B=10240, and 4096 bits, B=256,
   keygen (3072: the prime pool; 4096: the device Miller-Rabin, K10 and
   K9), the comb build, encrypt, decrypt, ``x + y``, ``x.sum()``,
   ``x * w`` (about half the weights negative) and ``x.dot(w)``, each
   against numpy and printed with its wall and device kernel time, one
   ciphertext under injected digits against Python's ``pow``, and the
   4096-bit key's comb window (11) and registered bytes.

Phases 4, 6, 7, 8, 9 and 10, and each rung of phase 11, set the launch
counters to 0 just before and read them just after; phase 5 checks
them all.  The second-to-last lines are the kernels'
JSON record and the card line; the last line is ``{"ok": true,
"device": {...}}``.
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
# Batch of the all-host hybrid mode: Python's pow takes ~70 ms a
# ciphertext at 2048 bits.
HOST_BATCH = 64
SEED = 20261016
# The key ladder of the reference's own configurations (bench.py:577-590,
# :649-670): key bits and the batch each rung runs at (phases 3 and 11)
LADDER = ((1024, 256), (3072, 10240), (4096, 256))

KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "rns_mul": ("pailliercryptolib_python_tpu_torch/csrc/rns.cu",
                "pailliercryptolib_python_tpu/ops/pallas_rns.py:578"),
    "rns_exp_sched": ("pailliercryptolib_python_tpu_torch/csrc/rns.cu",
                      "pailliercryptolib_python_tpu/ops/pallas_rns.py:416"),
    "rns_exp_elem": ("pailliercryptolib_python_tpu_torch/csrc/rns.cu",
                     "pailliercryptolib_python_tpu/ops/pallas_rns.py:501"),
    "rns_exp_shared": ("pailliercryptolib_python_tpu_torch/csrc/rns.cu",
                       "pailliercryptolib_python_tpu/ops/pallas_rns.py:349"),
    "mm3_mul": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont3.py:239"),
    "mm3_exp": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont3.py:306"),
    "mm3_exp_shared": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                       "pailliercryptolib_python_tpu/ops/pallas_mont3.py"
                       ":391"),
    "mm3_sqr": ("pailliercryptolib_python_tpu_torch/csrc/mont3.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont3.py:273"),
    "mont_mul": ("pailliercryptolib_python_tpu_torch/csrc/mont.cu",
                 "pailliercryptolib_python_tpu/ops/pallas_mont.py:111"),
    "mont_exp": ("pailliercryptolib_python_tpu_torch/csrc/mont.cu",
                 "pailliercryptolib_python_tpu/ops/pallas_mont.py:155"),
    "mont_chain": ("pailliercryptolib_python_tpu_torch/csrc/mont.cu",
                   "pailliercryptolib_python_tpu/ops/pallas_mont.py:233"),
    "mm2_mul": ("pailliercryptolib_python_tpu_torch/csrc/mont2.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont2.py:364"),
    "mm2_sqr": ("pailliercryptolib_python_tpu_torch/csrc/mont2.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont2.py:403"),
    "mm2_exp": ("pailliercryptolib_python_tpu_torch/csrc/mont2.cu",
                "pailliercryptolib_python_tpu/ops/pallas_mont2.py:435"),
    "mm2_exp_shared": ("pailliercryptolib_python_tpu_torch/csrc/mont2.cu",
                       "pailliercryptolib_python_tpu/ops/pallas_mont2.py"
                       ":521"),
}
FIRST_SLICE = ("rns_mul", "rns_exp_sched", "mm3_mul", "mm3_exp")
SECOND_SLICE = FIRST_SLICE + ("rns_exp_elem", "mm3_exp_shared")
THIRD_SLICE = ("mont_mul", "mont_exp")
FOURTH_SLICE = ("rns_exp_shared", "mm3_sqr", "mont_chain", "rns_mul",
                "rns_exp_sched", "mm3_mul", "mm3_exp_shared", "mont_mul",
                "mont_exp")
# Phase 9 (the microbench): the v2 kernels and every variant beside
FIFTH_SLICE = ("mm2_mul", "mm2_sqr", "mm2_exp", "mm2_exp_shared", "mont_mul",
               "mont_exp", "mm3_mul", "mm3_sqr", "mm3_exp", "mm3_exp_shared",
               "rns_exp_shared", "rns_exp_sched", "rns_mul")
# Phase 10 (the sharded layer): encrypt (K1), the default decrypt (K2),
# ct*pt (K5), the folds and products (K3)
SIXTH_SLICE = ("rns_mul", "rns_exp_sched", "rns_exp_elem", "mm3_mul")
# Phase 11 (the ladder), every rung: encrypt (K1), the default decrypt
# (K2), ct*pt (K5), the products and the exponent alignment (K3, K4);
# the 4096-bit keygen's device Miller-Rabin adds K10 and K9
LADDER_SLICE = ("rns_mul", "rns_exp_sched", "rns_exp_elem", "mm3_mul",
                "mm3_exp")
LADDER_KEYGEN = ("mont_exp", "mont_mul")

# Bounds (published NVIDIA H100 SXM peaks): bytes over the memory rate,
# int8 operations over the int8 tensor-core rate, the larger of the two.
# Work model: one RNS-Montgomery product of one column is two base
# extensions of 4(k+1)k int8 multiply-adds each; one Montgomery product of
# L 16-bit limbs is 2L^2 limb products of 4 int8 multiply-adds each, a
# square L(L+1)/2 + L^2 (the chains' squarings too, as the function's
# work, whatever the kernel runs); a multiply-add is 2 operations.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def rns_ops(k: int, products: int, B: int) -> int:
    return products * B * 2 * (2 * 4 * (k + 1) * k)


def limb_ops(L: int, products: int, B: int, squares: int = 0) -> int:
    return B * 2 * 4 * (products * 2 * L * L
                        + squares * (L * (L + 1) // 2 + L * L))


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


def random_cols(rng, ms: list, L: int, dev):
    """(L, B) limbs of one random value below 2m per modulus m of ms
    (Montgomery-range input)."""
    from pailliercryptolib_python_tpu_torch.ops.limb import (ints_to_limbs,
                                                             to_device)
    vals = [int.from_bytes(rng.bytes(2 * L), "little") % (2 * m)
            for m in ms]
    return to_device(ints_to_limbs(vals, L), dev)


def random_state(rng, base, B: int, dev):
    import torch
    mods = base.mods.cpu().numpy()
    st = (rng.integers(0, 1 << 16, size=(base.CH, B)) % mods).astype(np.int32)
    return torch.from_numpy(st).to(dev)


TILE_KERNELS = ("rns_mul_kernel", "rns_exp_sched_kernel", "rns_exp_elem_kernel",
                "rns_exp_shared_kernel", "mm3_mul_kernel", "mm3_exp_kernel",
                "mm3_exp_shared_kernel")
# The cooperative kernels' instantiations (csrc/coop.cuh, <K> from
# coop_shape) at the main path's shapes: K10 at the fused CRT decrypt and
# the keygen window, K9 at the fused decrypt's exit and the keygen's
# Miller-Rabin ladder, K11 at the limb encrypt chain, K8 at n^2 and p^2,
# K15 at the limb decrypt's p^2 and a 4096-bit key's, K12, K13 and K14 at
# the microbench's n^2 and p^2
COOP_SHAPES = (("K10", "mont_exp_kernel", 129, 8192),
               ("K10", "mont_exp_kernel", 65, 256),
               ("K9", "mont_mul_kernel", 129, 8192),
               ("K9", "mont_mul_kernel", 65, 256),
               ("K11", "mont_chain_kernel", 257, 4096),
               ("K8", "mm3_sqr_kernel", 257, 4096),
               ("K8", "mm3_sqr_kernel", 129, 4096),
               ("K15", "mm2_exp_shared_kernel", 129, 4096),
               ("K15", "mm2_exp_shared_kernel", 257, 4096),
               ("K12", "mm2_mul_kernel", 257, 4096),
               ("K12", "mm2_mul_kernel", 129, 4096),
               ("K13", "mm2_sqr_kernel", 257, 4096),
               ("K13", "mm2_sqr_kernel", 129, 4096),
               ("K14", "mm2_exp_kernel", 257, 4096),
               ("K14", "mm2_exp_kernel", 129, 4096))


def tile_kernel_report() -> None:
    """Phase 2, the tensor-core tile kernels (K1, K2, K5, K6 on
    ``csrc/rns_tile.cuh``, K3, K4, K7 on ``csrc/mm3_tile.cuh``) and the
    cooperative kernels of K10 and K14: nvcc's -Xptxas -v lines
    (registers, spills; their shared memory is dynamic, so the bytes each
    launch asks for at the
    main path's shape are printed beside), and, where the toolkit has
    cuobjdump, the tensor-core instructions (IMMA for mma.sync) in each
    tile kernel's SASS; fails when one of them has none, or when an
    instantiation of K8-K15 at a shape of
    ``COOP_SHAPES`` uses stack or local memory (``cuobjdump -res-usage``:
    a spill)."""
    import re
    from pailliercryptolib_python_tpu_torch import kernels
    lines, cur = {}, None
    for line in kernels.build_log.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in TILE_KERNELS + ("mont_exp_kernel",
                                                    "mm2_exp_kernel")
                        if k in line), None)
            if cur:
                cur = line.split("'")[1]
                lines[cur] = []
        elif cur and "ptxas info" in line and "Function properties" not in \
                line or cur and "spill" in line:
            lines[cur].append(line.strip())
    for fn, ls in lines.items():
        print(f"    {fn}:")
        for line in ls:
            print("      " + line)
    # dynamic shared memory of a launch (rns.cu: states as uint16, the
    # digit tile of 32 rows of 2KP + 16 bytes, delta; K2 also W1 + W2
    # where they fit, K5 its 16 windows' digits; mm3_tile.cuh:
    # two rows a column of 4L + 512 and 8L + 8 bytes, each 16 mod 32; K4
    # adds a window's digits, K7 its staged table entry where it fits: the
    # library's own count, mont3.cu mm3_smem)
    # the 2048-bit key's n^2 and p^2 bases, then the ladder's (1024-,
    # 3072- and 4096-bit keys' n^2 and p^2)
    for CH, k in ((521, 260), (261, 130), (263, 131), (133, 66),
                  (779, 389), (389, 194), (1039, 519), (519, 259)):
        m = rns_smem(k, CH)
        over = ("" if m["w_shared"] else f" (over the 232448 B limit: W "
                f"from global memory, {m['k2']} B)")
        print(f"    CH={CH}: K1 asks {m['k1']} B of shared memory, K2 and K6 "
              f"{m['with_w']} B with W1 + W2 resident{over}, K5 (16 "
              f"windows) {m['k5']} B (W1 + W2 from global memory)")
    for L in (257, 129, 520, 65, 193, 385, 513):
        k3, k4, k7 = (kernels.mm3_smem_bytes(k, L) for k in (
            "mm3_mul", "mm3_exp", "mm3_exp_shared"))
        print(f"    L={L}: K3 asks {k3} B of shared memory, K4 {k4} B, K7 "
              f"{k7} B" + (" (its entry staged)" if k7 > k3 else ""))
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    # K8-K15: registers, stack and local memory of the
    # instantiations at COOP_SHAPES, read from the built library whichever
    # process built it
    usage = subprocess.run([cuobjdump, "-res-usage", kernels.LIB_PATH],
                           capture_output=True, text=True,
                           timeout=300).stdout
    res, fn = {}, None
    for line in usage.splitlines():
        m = re.search(r"Function \S*\d(mont_(?:mul|exp|chain)_kernel|"
                      r"mm3_sqr_kernel|mm2_exp_shared_kernel|mm2_mul_kernel|"
                      r"mm2_sqr_kernel|mm2_exp_kernel)ILi(\d+)E", line)
        if m:
            fn = (m.group(1), int(m.group(2)))
        elif fn is not None and "REG:" in line:
            res[fn] = dict(re.findall(r"(\w+):(\d+)", line))
            fn = None
    for tag, kern, L, B in COOP_SHAPES:
        g, K = kernels.mont_exp_shape(L, B)
        r = res.get((kern, K), {})
        print(f"    {tag} at L={L}, B={B}: {g} lanes a column, {K} words a "
              f"lane, {kern}<{K}>: registers {r.get('REG')}, "
              f"stack {r.get('STACK')} B, local {r.get('LOCAL')} B")
        if not r or r.get("STACK") != "0" or r.get("LOCAL") != "0":
            raise AssertionError(f"{tag}'s instantiation for L={L}, B={B} "
                                 f"spills or is missing: {r}")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", kernels.LIB_PATH],
                              capture_output=True, text=True,
                              timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn and ("IMMA" in line or "IGMMA" in line):
                counts[fn] = counts.get(fn, 0) + 1
        tile = {f: c for f, c in counts.items()
                if any(k in f for k in TILE_KERNELS)}
        print(f"    tensor-core instructions (IMMA/IGMMA) in SASS: {tile}")
        missing = [k for k in TILE_KERNELS if not any(k in f for f in tile)]
        if missing or len(tile) < 9:    # K2, K6 in two instantiations
            raise AssertionError(f"tile kernels lack their IMMA instructions: "
                                 f"{missing or tile}")


def check_kernels(dev, kd) -> dict:
    """Phase 3: each kernel against its plain twin, exact, with both times
    and the kernel's bound at the same inputs.  Every kernel is checked
    at the main path's shape (its headline record); K2, K5, K6 and K7
    also at a short chain."""
    import torch
    from pailliercryptolib_python_tpu_torch.ops import (mont, mont3, rns,
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
        a = random_cols(rng, [m] * BATCH, L, dev)
        b = random_cols(rng, [m] * BATCH, L, dev)
        got = mont3.mm3_mul(a, b, ctx)
        want = mont3.mm3_mul_plain(a, b, ctx.wmu, ctx.wm, ctx.off1, ctx.off2)
        record("mm3_mul", got, want, f"L={L} B={BATCH}",
               ms_of(lambda: mont3.mm3_mul(a, b, ctx), 5),
               ms_of(lambda: mont3.mm3_mul_plain(a, b, ctx.wmu, ctx.wm,
                                                 ctx.off1, ctx.off2), 1),
               nbytes(a, b, got, ctx.n_limbs), limb_ops(L, 1, BATCH),
               headline=m == n * n)
        if m != p:
            # K3's tile masks a ragged last tile; the narrow batches of the
            # inversion tree's upper levels; b as an (L, 1) broadcast
            for Bn, bc in ((BATCH, True), (BATCH - 1, False), (64, False),
                           (1, False)):
                an = a[:, :Bn].contiguous()
                bn = b[:, :1].contiguous() if bc else b[:, :Bn].contiguous()
                got = mont3.mm3_mul(an, bn, ctx)
                want = mont3.mm3_mul_plain(an, bn, ctx.wmu, ctx.wm, ctx.off1,
                                           ctx.off2)
                record("mm3_mul", got, want,
                       f"L={L} B={Bn}" + (", b (L, 1)" if bc else ""),
                       ms_of(lambda: mont3.mm3_mul(an, bn, ctx), 5),
                       ms_of(lambda: mont3.mm3_mul_plain(
                           an, bn, ctx.wmu, ctx.wm, ctx.off1, ctx.off2), 1),
                       nbytes(an, bn, got, ctx.n_limbs), limb_ops(L, 1, Bn))
            # K4: short exponents (the exponent-alignment shape), win_start>0
            # (host digits, as mul_pt passes them); at p^2 (L=129) also
            # against K10 on the weightless context.
            exps = [int(e) for e in rng.integers(1, 1 << 20, size=BATCH)]
            digits = mg.exponent_digits(exps, 8, 4).astype(np.int32)
            dig_dev = torch.from_numpy(digits).to(dev)
            ws = 3
            got = mont3.mm3_exp(a, digits, ctx, ws)
            want = mont3.mm3_exp_plain(a, dig_dev, ctx.wmu, ctx.wm, ctx.off1,
                                       ctx.off2, ctx.one, ws)
            record("mm3_exp", got, want, f"L={L} B={BATCH} win 3..8",
                   ms_of(lambda: mont3.mm3_exp(a, digits, ctx, ws), 2),
                   ms_of(lambda: mont3.mm3_exp_plain(
                       a, dig_dev, ctx.wmu, ctx.wm, ctx.off1, ctx.off2,
                       ctx.one, ws), 1),
                   nbytes(a, dig_dev, got, ctx.one, ctx.n_limbs),
                   limb_ops(L, 14 + 8 - ws, BATCH, (8 - ws) * 4),
                   headline=m == n * n)
        if m == n * n:
            # K4 on a ragged last tile and on one column, over all 16
            # windows from win_start 0, the digits using every value 0..15
            for Bn in (BATCH - 1, 1):
                an = a[:, :Bn].contiguous()
                d16 = rng.integers(0, 16, size=(16, Bn)).astype(np.int32)
                d16.reshape(-1)[:16] = np.arange(16)
                d16_dev = torch.from_numpy(d16).to(dev)
                got = mont3.mm3_exp(an, d16, ctx, 0)
                want, plain_ms = timed(lambda: mont3.mm3_exp_plain(
                    an, d16_dev, ctx.wmu, ctx.wm, ctx.off1, ctx.off2,
                    ctx.one, 0))
                record("mm3_exp", got, want, f"L={L} B={Bn} win 0..16",
                       ms_of(lambda: mont3.mm3_exp(an, d16, ctx, 0), 2),
                       plain_ms, nbytes(an, d16_dev, got, ctx.one,
                                        ctx.n_limbs),
                       limb_ops(L, 14 + 16, Bn, 16 * 4))
        if m == p * p:
            c0 = mg.MontCtx.for_modulus(m, mxu=False, device=dev)
            if not torch.equal(got, mont.mont_exp_p(
                    a, digits, c0.n_limbs, c0.n0inv, c0.one, ws)):
                raise AssertionError(f"K4 differs from K10 at L={L}")
            print(f"  mm3_exp        equals mont_exp at L={L}", flush=True)
        if m == n * n:
            # K9 on the weightless n^2 context: its twin, and K3's output
            c0 = mg.MontCtx.for_modulus(m, mxu=False, device=dev)
            got = mont.mont_mul_p(a, b, c0.n_limbs, c0.n0inv)
            want = mg.cios_mul(a, b, c0.n_limbs, c0.n0inv)
            record("mont_mul", got, want, f"L={L} B={BATCH} shared n^2",
                   ms_of(lambda: mont.mont_mul_p(a, b, c0.n_limbs,
                                                 c0.n0inv), 5),
                   ms_of(lambda: mg.cios_mul(a, b, c0.n_limbs, c0.n0inv), 1),
                   nbytes(a, b, got, c0.n_limbs) + 4,
                   limb_ops(L, 1, BATCH))
            coop_note(L, BATCH, 1)
            k3 = mont3.mm3_mul(a, b, ctx)
            if not torch.equal(got, k3):
                raise AssertionError("K9 differs from K3 on a shared n^2")
            print("  mont_mul       equals mm3_mul on the weightless n^2 "
                  "context", flush=True)
        if m == p * p:
            # K7: the limb decrypt's shared exponent p-1, window 5 at
            # L=129: its first 4 windows, then all of them as the decrypt
            # runs it (host digits, as the decrypt passes them), then the
            # first 4 on one column
            window = mont3.shared_exp_window(L)
            e = p - 1
            nwd = -(-e.bit_length() // window)
            dig_all = mg.exponent_digits([e], nwd, window)[:, 0].astype(
                np.int32)
            for Bn, dig in ((BATCH, dig_all[:4]), (BATCH, dig_all),
                            (1, dig_all[:4])):
                an = a[:, :Bn].contiguous()
                check_k7(record, an, dig, ctx, window,
                         headline=len(dig) == nwd and Bn == BATCH)
    # K3 at its largest L (kMaxLimbs, 217,088 B of shared memory): a
    # random odd modulus the size of a 4096-bit key's n^2 context
    import random
    bits = 16 * 520 - 2
    m = random.Random(SEED).getrandbits(bits) | (1 << (bits - 1)) | 1
    ctx = mg.MontCtx.for_modulus(m, device=dev)
    L = ctx.num_limbs
    a = random_cols(rng, [m] * 64, L, dev)
    b = random_cols(rng, [m] * 64, L, dev)
    got = mont3.mm3_mul(a, b, ctx)
    want = mont3.mm3_mul_plain(a, b, ctx.wmu, ctx.wm, ctx.off1, ctx.off2)
    record("mm3_mul", got, want, f"L={L} B=64",
           ms_of(lambda: mont3.mm3_mul(a, b, ctx), 5),
           ms_of(lambda: mont3.mm3_mul_plain(a, b, ctx.wmu, ctx.wm,
                                             ctx.off1, ctx.off2), 1),
           nbytes(a, b, got, ctx.n_limbs), limb_ops(L, 1, 64))
    # K4 and K7 there too: K4's largest shared memory, and K7's table
    # entry too large to stage beside the tile (read from global memory)
    exps = [int(e) for e in rng.integers(1, 1 << 20, size=64)]
    digits = mg.exponent_digits(exps, 8, 4).astype(np.int32)
    dig_dev = torch.from_numpy(digits).to(dev)
    got = mont3.mm3_exp(a, digits, ctx, 3)
    want, plain_ms = timed(lambda: mont3.mm3_exp_plain(
        a, dig_dev, ctx.wmu, ctx.wm, ctx.off1, ctx.off2, ctx.one, 3))
    record("mm3_exp", got, want, f"L={L} B=64 win 3..8",
           ms_of(lambda: mont3.mm3_exp(a, digits, ctx, 3), 2), plain_ms,
           nbytes(a, dig_dev, got, ctx.one, ctx.n_limbs),
           limb_ops(L, 14 + 5, 64, 5 * 4))
    window = mont3.shared_exp_window(L)
    dig = np.array([0, (1 << window) - 1, 1, 2], dtype=np.int32)
    check_k7(record, a, dig, ctx, window)
    # K7 at a 4096-bit key's p^2 (L=257, its entry staged), 4 windows
    bits = 4096
    m = random.Random(SEED + 1).getrandbits(bits) | (1 << (bits - 1)) | 1
    ctx = mg.MontCtx.for_modulus(m, device=dev)
    L = ctx.num_limbs
    window = mont3.shared_exp_window(L)
    dig = np.array([(1 << window) - 1, 0, 3, 1], dtype=np.int32)
    check_k7(record, random_cols(rng, [m] * BATCH, L, dev), dig, ctx,
             window)
    # K1 at the encrypt (n^2) and decrypt (p^2) bases: the main path's
    # width, a ragged batch and one column (the tile kernel masks the
    # last tile's columns)
    for m, bits in ((n * n, 2 * 2048 + 2), (p * p, (p * p).bit_length())):
        base = rns.RnsBase.for_bits(-(-bits // 16) * 16, dev)
        L = (m.bit_length() + 2 + 15) // 16
        key = rns.RnsModulus.build(base, m, L)
        ops_t = rk.kernel_operands(base, key, dev)
        tile_bytes = nbytes(ops_t["vec"], ops_t["skc"], ops_t["W1f"],
                            ops_t["W2f"])
        X = random_state(rng, base, BATCH, dev)
        Y = random_state(rng, base, BATCH, dev)
        for B in (BATCH, BATCH - 1, 1):
            Xr = X if B == BATCH else random_state(rng, base, B, dev)
            Yr = Y if B == BATCH else random_state(rng, base, B, dev)
            got = rk.rns_mul(Xr, Yr, base, key)
            want = rns.rns_mont_mul(Xr, Yr, base, key)
            record("rns_mul", got, want, f"CH={base.CH} B={B}",
                   ms_of(lambda: rk.rns_mul(Xr, Yr, base, key), 20),
                   ms_of(lambda: rns.rns_mont_mul(Xr, Yr, base, key), 2),
                   nbytes(Xr, Yr, got) + tile_bytes,
                   rns_ops(base.k, 1, B),
                   headline=m == n * n and B == BATCH)
        if m == n * n:
            # K5 at the ct*pt base: 4 windows at B=256, then the main
            # path's shape, B=4096 and 16 windows (53-bit exponents bucket
            # to 16), a ragged batch and one column; the digits cover
            # 0..15; host digits, as mul_pt passes them
            w = 4
            for B, nw in ((256, 4), (BATCH, 16), (BATCH - 1, 16), (1, 16)):
                Xe = X if B == BATCH else random_state(rng, base, B, dev)
                dig = rng.integers(0, 1 << w, size=(nw, B)).astype(np.int32)
                dig.reshape(-1)[:1 << w] = np.arange(1 << w)
                dig_dev = torch.from_numpy(dig).to(dev)
                got = rk.rns_exp_elem_p(Xe, dig, base, key, w)
                want, plain_ms = timed(lambda: rns.rns_exp_elem(
                    Xe, dig_dev, base, key, w))
                record("rns_exp_elem", got, want,
                       f"CH={base.CH} B={B} w={w} {nw} windows",
                       ms_of(lambda: rk.rns_exp_elem_p(Xe, dig, base, key,
                                                       w), 2),
                       plain_ms, nbytes(Xe, dig_dev, got) + tile_bytes,
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
           nbytes(X, got) + 4 * len(short) + tile_bytes,
           rns_ops(base.k, tbl + len(short), 256))
    # the whole chain at the main path's width, a ragged batch and one
    # column
    for B in (BATCH, 100, 1):
        Xf = random_state(rng, base, B, dev)
        got = rk.rns_exp_sched_p(Xf, sched, base, key, window)
        want, plain_ms = timed(lambda: rns.rns_exp_sched(Xf, sched, base,
                                                         key, window))
        record("rns_exp_sched", got, want,
               f"CH={base.CH} B={B} w={window} {len(sched)} ops",
               ms_of(lambda: rk.rns_exp_sched_p(Xf, sched, base, key,
                                                window), 3),
               plain_ms, nbytes(Xf, got) + 4 * len(sched) + tile_bytes,
               rns_ops(base.k, tbl + len(sched), B), headline=B == BATCH)
    # W1, W2 of the n^2 base (CH=521) do not fit beside the states in
    # shared memory: the instantiation that reads them from global memory
    b2 = rns.RnsBase.for_bits(-(-(2 * 2048 + 2) // 16) * 16, dev)
    k2 = rns.RnsModulus.build(b2, n * n, (2 * 2048 + 2 + 15) // 16)
    o2 = rk.kernel_operands(b2, k2, dev)
    X2 = random_state(rng, b2, 100, dev)
    w2 = 4
    s2 = rns.sliding_schedule(e, w2, e.bit_length())[-64:]
    got = rk.rns_exp_sched_p(X2, s2, b2, k2, w2)
    want = rns.rns_exp_sched(X2, s2, b2, k2, w2)
    record("rns_exp_sched", got, want,
           f"CH={b2.CH} B=100 w={w2} 64 ops, W global",
           ms_of(lambda: rk.rns_exp_sched_p(X2, s2, b2, k2, w2), 2),
           ms_of(lambda: rns.rns_exp_sched(X2, s2, b2, k2, w2), 1),
           nbytes(X2, got, o2["vec"], o2["skc"], o2["W1f"], o2["W2f"])
           + 4 * len(s2), rns_ops(b2.k, (1 << (w2 - 1)) + len(s2), 100))
    check_per_element(dev, kd, rng, record)
    check_fourth_slice(dev, kd, rng, record)
    check_fifth_slice(dev, kd, rng, record)
    check_ladder_kernels(dev, rng, record)
    return res


def check_fourth_slice(dev, kd, rng, record) -> None:
    """Phase 3, K6, K8 and K11.  K6: the decrypt half's chain (CH=261,
    B=4096, window 5, the 205 windows of p-1) and a short one whose first
    digit is 0 and last 2^w - 1 at B=256, 4095 and 1, and at the n^2 base
    (CH=521), where W1, W2 do not fit beside the states and are read from
    global memory.  K8: L=257, 129, 65 at B=4096, also against K3(a, a),
    with its integer-pipe floor.  K11: the limb encrypt chain (86
    factors, L=257, B=4096, shared n^2) against the streamed K3 chain
    (both timed), 8
    factors at B=4095 and B=1 (padding columns), and a per-element shape
    against a K9 loop; each K11 row with its integer-pipe floor."""
    import torch
    from pailliercryptolib_python_tpu_torch.ops import (mont, mont3, rns,
                                                        rns_kernels as rk,
                                                        montgomery as mg)
    n, p, q = kd["n"], kd["p"], kd["q"]
    # K6
    m = p * p
    base = rns.RnsBase.for_bits(-(-m.bit_length() // 16) * 16, dev)
    key = rns.RnsModulus.build(base, m, (m.bit_length() + 2 + 15) // 16)
    w = 5
    e = p - 1
    dig_all = mg.exponent_digits([e], -(-e.bit_length() // w), w)[:, 0].astype(
        np.int32)
    short = np.array([0, 7, 0, (1 << w) - 1], dtype=np.int32)
    b2 = rns.RnsBase.for_bits(-(-(2 * 2048 + 2) // 16) * 16, dev)
    k2 = rns.RnsModulus.build(b2, n * n, (2 * 2048 + 2 + 15) // 16)
    for bs, ky, dig, B, wg in ((base, key, short, 256, w),
                               (base, key, short, BATCH - 1, w),
                               (base, key, short, 1, w),
                               (b2, k2, short[:3] & 15, 100, 4),
                               (base, key, dig_all, BATCH, w)):
        ops_t = rk.kernel_operands(bs, ky, dev)
        X = random_state(rng, bs, B, dev)
        nw = len(dig)
        got = rk.rns_exp_shared_p(X, dig, bs, ky, wg)
        want, plain_ms = timed(lambda: rns.rns_exp_shared_plain(
            X, dig, bs, ky, wg))
        record("rns_exp_shared", got, want,
               f"CH={bs.CH} B={B} w={wg} {nw} windows"
               + (", W global" if bs is b2 else ""),
               ms_of(lambda: rk.rns_exp_shared_p(X, dig, bs, ky, wg), 1),
               plain_ms, nbytes(X, got, ops_t["vec"], ops_t["skc"],
                                ops_t["W1f"], ops_t["W2f"]) + 4 * nw,
               rns_ops(bs.k, (1 << wg) - 2 + nw * (wg + 1), B),
               headline=B == BATCH)
    # K8
    for m in (n * n, p * p, p):
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        L = ctx.num_limbs
        a = random_cols(rng, [m] * BATCH, L, dev)
        got = mont3.mm3_sqr(a, ctx)
        want = mont3.mm3_sqr_plain(a, ctx.wmu, ctx.wm, ctx.off1, ctx.off2)
        record("mm3_sqr", got, want, f"L={L} B={BATCH}",
               ms_of(lambda: mont3.mm3_sqr(a, ctx), 5),
               ms_of(lambda: mont3.mm3_sqr_plain(a, ctx.wmu, ctx.wm,
                                                 ctx.off1, ctx.off2), 1),
               nbytes(a, got, ctx.n_limbs), limb_ops(L, 0, BATCH, 1),
               headline=m == n * n)
        coop_note(L, BATCH, 0, 1)
        k3_ms = ms_of(lambda: mont3.mm3_mul(a, a, ctx), 5)
        if not torch.equal(got, mont3.mm3_mul(a, a, ctx)):
            raise AssertionError(f"K8 differs from K3(a, a) at L={L}")
        print(f"  mm3_sqr        equals mm3_mul(a, a) at L={L} (K3 on the "
              f"same input {k3_ms:.3f} ms)", flush=True)
    # K11, shared n^2: 86 factors as the limb comb gathers them
    ctx = mg.MontCtx.for_modulus(n * n, device=dev)
    L, n_win = ctx.num_limbs, 86
    fac = torch.stack([random_cols(rng, [n * n] * BATCH, L, dev)
                       for _ in range(n_win)], dim=0)
    acc0 = random_cols(rng, [n * n] * BATCH, L, dev)
    got = mont.mont_chain_p(fac, acc0, ctx.n_limbs, ctx.n0inv)
    want, plain_ms = timed(lambda: mont.mont_chain_plain(
        fac, acc0, ctx.n_limbs, ctx.n0inv))
    record("mont_chain", got, want, f"n_win={n_win} L={L} B={BATCH} shared",
           ms_of(lambda: mont.mont_chain_p(fac, acc0, ctx.n_limbs,
                                           ctx.n0inv), 2),
           plain_ms, nbytes(fac, acc0, got, ctx.n_limbs) + 4,
           limb_ops(L, n_win, BATCH), headline=True)
    coop_note(L, BATCH, n_win)

    def streamed():
        acc = acc0
        for j in range(n_win):
            acc = mont3.mm3_mul(acc, fac[j], ctx)
        return acc
    k3_ms = ms_of(streamed, 2)
    if not torch.equal(got, streamed()):
        raise AssertionError("K11 differs from the streamed K3 chain")
    print(f"  mont_chain     equals the streamed K3 chain ({n_win} K3 "
          f"launches, {k3_ms:.3f} ms)", flush=True)
    # padding columns: a ragged last group of columns, and one column
    for Bn in (BATCH - 1, 1):
        fb = fac[:8, :, :Bn].contiguous()
        ab = acc0[:, :Bn].contiguous()
        got = mont.mont_chain_p(fb, ab, ctx.n_limbs, ctx.n0inv)
        want, plain_ms = timed(lambda: mont.mont_chain_plain(
            fb, ab, ctx.n_limbs, ctx.n0inv))
        record("mont_chain", got, want, f"n_win=8 L={L} B={Bn} shared",
               ms_of(lambda: mont.mont_chain_p(fb, ab, ctx.n_limbs,
                                               ctx.n0inv), 5),
               plain_ms, nbytes(fb, ab, got, ctx.n_limbs) + 4,
               limb_ops(L, 8, Bn))
        coop_note(L, Bn, 8)
    del fac, fb
    # K11, a modulus per column, against a K9 loop
    ms = [p * p] * 128 + [q * q] * 128
    Lh = (max(v.bit_length() for v in ms) + 2 + 15) // 16
    pc = mg.MontCtx.for_moduli(ms, Lh, dev)
    fac = torch.stack([random_cols(rng, ms, Lh, dev) for _ in range(8)],
                      dim=0)
    acc0 = random_cols(rng, ms, Lh, dev)
    got = mont.mont_chain_p(fac, acc0, pc.n_limbs, pc.n0inv)
    want, plain_ms = timed(lambda: mont.mont_chain_plain(
        fac, acc0, pc.n_limbs, pc.n0inv))
    record("mont_chain", got, want, f"n_win=8 L={Lh} B=256 per-element",
           ms_of(lambda: mont.mont_chain_p(fac, acc0, pc.n_limbs,
                                           pc.n0inv), 2),
           plain_ms, nbytes(fac, acc0, got, pc.n_limbs, pc.n0inv),
           limb_ops(Lh, 8, 256))
    coop_note(Lh, 256, 8)
    acc = acc0
    for j in range(8):
        acc = mont.mont_mul_p(acc, fac[j], pc.n_limbs, pc.n0inv)
    if not torch.equal(got, acc):
        raise AssertionError("K11 differs from a K9 loop, per-element")
    print("  mont_chain     equals a K9 loop (per-element)", flush=True)


def check_k7(record, a, dig, ctx, window: int, headline=False) -> None:
    """K7 on (L, B) values `a` with the shared digits `dig` against its
    twin (one timed call of each: the whole chain's twin takes ~13 s)."""
    import torch
    from pailliercryptolib_python_tpu_torch.ops import mont3
    L, B = a.shape
    dig_dev = torch.from_numpy(dig).to(a.device)
    got = mont3.mm3_exp_shared(a, dig, ctx, window)
    want, plain_ms = timed(lambda: mont3.mm3_exp_shared_plain(
        a, dig_dev, ctx.wmu, ctx.wm, ctx.off1, ctx.off2, ctx.one, window))
    nw = len(dig)
    record("mm3_exp_shared", got, want,
           f"L={L} B={B} w={window} {nw} windows",
           ms_of(lambda: mont3.mm3_exp_shared(a, dig, ctx, window), 1),
           plain_ms, nbytes(a, dig_dev, got, ctx.one, ctx.n_limbs),
           limb_ops(L, (1 << window) - 2 + nw, B, nw * window),
           headline=headline)


def check_fifth_slice(dev, kd, rng, record) -> None:
    """Phase 3, the v2 kernels, exact against their twins and against
    the kernels of the same function on the same inputs: K12 at L=257
    (n^2) and 129 (p^2) against K3 and against K9 on the same shared
    modulus, its limbs given where K12 recovers them from the weights
    (K9's time beside: what the recovery costs); K13 at L=257, 129, 65
    against K8 and K12(a, a); both at L=520, B=64, and at B=33 over L = 2
    to 520 (every fifth L, and 519, 520: each (g, K), odd and even L)
    against K9 and their twins; K14 at L=257 and 129, windows 3..8, at
    L=257 over all 16 windows at B=4095 and 1 and with win_start = n_win,
    and at L=520, B=64, against K4 and K10 on the same modulus (both
    timed beside), at the main rows and B=1 also against
    ``mm2_exp_words``; K15 at the limb decrypt's shape (p^2, L=129,
    window 5, the 205 windows of p-1), at a 4096-bit key's p^2 (L=257, 4
    windows) and at L=520, B=64 (w=3, 4 windows) against K7.  K12-K15
    rows carry their integer-pipe floor and (g, K).  The bound is the
    function's (K3's work model over the inputs, the modulus and the
    output), as the CIOS kernels' rows count it."""
    import random
    import torch
    from pailliercryptolib_python_tpu_torch.ops import matmul_mont as mm
    from pailliercryptolib_python_tpu_torch.ops import mont, mont2, mont3
    from pailliercryptolib_python_tpu_torch.ops.limb import (ints_to_limbs,
                                                             to_device)
    from pailliercryptolib_python_tpu_torch.ops import montgomery as mg
    n, p = kd["n"], kd["p"]

    def same(got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(what)

    def equals(name, other, got, fn, L, note=""):
        """got equals kernel `other` on the same input; its time beside."""
        same(got, fn(), f"{name} differs from {other} at L={L}")
        print(f"  {name:14s} equals {other}{note} at L={L} ({other} on the "
              f"same input {ms_of(fn, 20):.4f} ms)", flush=True)

    def k12_k13(a, b, m, L, Bn, ctx, head=False):
        """K12 (where b is given) and K13 against their twins, with the
        floor and (g, K); K12 against K3 and against K9 on the same
        modulus, K13 against K8 and K12(a, a)."""
        mc = mm.MatmulMontCtx(m, L, device=dev)
        w = (mc.W_mu, mc.W_m)
        c9 = mg.MontCtx.for_modulus(m, min_bits=16 * L, mxu=False,
                                    device=dev)
        if b is not None:
            got = mont2.mm2_mul(a, b, *w)
            record("mm2_mul", got, mont2.mm2_mul_plain(a, b, *w),
                   f"L={L} B={Bn}", ms_of(lambda: mont2.mm2_mul(a, b, *w), 20),
                   ms_of(lambda: mont2.mm2_mul_plain(a, b, *w), 1),
                   nbytes(a, b, got, mc.m_limbs), limb_ops(L, 1, Bn),
                   headline=head)
            coop_note(L, Bn, 1)
            equals("mm2_mul", "mm3_mul", got,
                   lambda: mont3.mm3_mul(a, b, ctx), L)
            equals("mm2_mul", "mont_mul", got,
                   lambda: mont.mont_mul_p(a, b, c9.n_limbs, c9.n0inv), L,
                   " (its modulus's limbs given)")
        got = mont2.mm2_sqr(a, *w)
        record("mm2_sqr", got, mont2.mm2_sqr_plain(a, *w), f"L={L} B={Bn}",
               ms_of(lambda: mont2.mm2_sqr(a, *w), 20),
               ms_of(lambda: mont2.mm2_sqr_plain(a, *w), 1),
               nbytes(a, got, mc.m_limbs), limb_ops(L, 0, Bn, 1),
               headline=head)
        coop_note(L, Bn, 0, 1)
        equals("mm2_sqr", "mm3_sqr", got, lambda: mont3.mm3_sqr(a, ctx), L)
        same(got, mont2.mm2_mul(a, a, *w), f"K13 differs from K12(a, a) at "
             f"L={L}")

    def k15(a, dig, m, ctx, window, headline=False):
        """K15 against its twin (one timed call: the twin takes seconds)
        and K7 on the same inputs, with its integer-pipe floor."""
        L, Bn = a.shape
        mc = mm.MatmulMontCtx(m, L, device=dev)
        w = (mc.W_mu, mc.W_m)
        nwd = len(dig)
        dig_dev = torch.from_numpy(dig).to(dev)
        got = mont2.mm2_exp_shared(a, dig, *w, ctx.one, window)
        want, plain_ms = timed(lambda: mont2.mm2_exp_shared_plain(
            a, dig_dev, *w, ctx.one, window))
        nmul, nsq = (1 << window) - 2 + nwd, nwd * window
        record("mm2_exp_shared", got, want,
               f"L={L} B={Bn} w={window} {nwd} windows",
               ms_of(lambda: mont2.mm2_exp_shared(a, dig, *w, ctx.one,
                                                  window), 2), plain_ms,
               nbytes(a, dig_dev, got, ctx.one, mc.m_limbs),
               limb_ops(L, nmul, Bn, nsq), headline=headline)
        coop_note(L, Bn, nmul, nsq)
        k7, k7_ms = timed(lambda: mont3.mm3_exp_shared(a, dig, ctx, window))
        same(got, k7, f"K15 differs from K7 at L={L}")
        print(f"  mm2_exp_shared equals mm3_exp_shared at L={L} (K7 on the "
              f"same input {k7_ms:.3f} ms)", flush=True)

    def k14(a, digits, ws, m, ctx, headline=False, words=False):
        """K14 against its twin (one timed call), with its integer-pipe
        floor and (g, K); against K4 and K10 on the same modulus and
        inputs (their times beside), and, where `words`, against
        ``mm2_exp_words``' arithmetic (eager, ~2,500 aten ops a product
        at L=257)."""
        L, Bn = a.shape
        mc = mm.MatmulMontCtx(m, L, device=dev)
        w = (mc.W_mu, mc.W_m)
        dig_dev = torch.from_numpy(digits).to(dev)
        nw = digits.shape[0] - ws
        got = mont2.mm2_exp(a, digits, *w, ctx.one, ws)
        want, plain_ms = timed(lambda: mont2.mm2_exp_plain(
            a, dig_dev, *w, ctx.one, ws))
        nmul, nsq = 14 + nw, 4 * nw
        record("mm2_exp", got, want,
               f"L={L} B={Bn} win {ws}..{digits.shape[0]}",
               ms_of(lambda: mont2.mm2_exp(a, digits, *w, ctx.one, ws), 20),
               plain_ms, nbytes(a, dig_dev, got, ctx.one, mc.m_limbs),
               limb_ops(L, nmul, Bn, nsq), headline=headline)
        coop_note(L, Bn, nmul, nsq)
        if words:
            same(got, mont2.mm2_exp_words(a, dig_dev, mc.W_m, ctx.one, ws),
                 f"K14 differs from mm2_exp_words at L={L}, B={Bn}")
            print(f"  {'mm2_exp':14s} equals mm2_exp_words at L={L}, "
                  f"B={Bn}", flush=True)
        equals("mm2_exp", "mm3_exp", got,
               lambda: mont3.mm3_exp(a, digits, ctx, ws), L)
        c10 = mg.MontCtx.for_modulus(m, mxu=False, device=dev)
        equals("mm2_exp", "mont_exp", got,
               lambda: mont.mont_exp_p(a, digits, c10.n_limbs, c10.n0inv,
                                       c10.one, ws), L,
               " (its modulus's limbs given)")

    for m in (n * n, p * p, p):
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        L = ctx.num_limbs
        mc = mm.MatmulMontCtx(m, L, device=dev)
        w = (mc.W_mu, mc.W_m)
        a = random_cols(rng, [m] * BATCH, L, dev)
        b = random_cols(rng, [m] * BATCH, L, dev)
        head = m == n * n
        # K12 (not at p, L=65) and K13
        k12_k13(a, None if m == p else b, m, L, BATCH, ctx, head)
        if m == p:
            continue
        # K14: K4's headline shape, 20-bit exponents, windows 3..8
        exps = [int(e) for e in rng.integers(1, 1 << 20, size=BATCH)]
        digits = mg.exponent_digits(exps, 8, 4).astype(np.int32)
        k14(a, digits, 3, m, ctx, head, words=True)
        if head:
            # all 16 windows from 0, the digits covering 0..15, on a
            # ragged batch and one column; win_start = n_win (the output
            # is the Montgomery one)
            for Bn in (BATCH - 1, 1):
                d16 = rng.integers(0, 16, size=(16, Bn)).astype(np.int32)
                d16.reshape(-1)[:16] = np.arange(16)
                k14(a[:, :Bn].contiguous(), d16, 0, m, ctx, words=Bn == 1)
            k14(a, digits, 8, m, ctx)
        if m != p * p:
            continue
        # K15: the limb decrypt's chain of p-1 at window 5
        window = mont3.shared_exp_window(L)
        e = p - 1
        nwd = -(-e.bit_length() // window)
        dig = mg.exponent_digits([e], nwd, window)[:, 0].astype(np.int32)
        k15(a, dig, m, ctx, window, headline=True)
    # K15 at a 4096-bit key's p^2 (L=257, K=17) and at L=520, B=64 (its
    # largest), 4 windows each, the digits covering 0 and 2^w - 1
    for bits, Bn, window, seed in ((4096, BATCH, 5, 2), (16 * 520 - 2, 64,
                                                           3, 3)):
        m = random.Random(SEED + seed).getrandbits(bits)
        m |= (1 << (bits - 1)) | 1
        ctx = mg.MontCtx.for_modulus(m, device=dev)
        dig = np.array([(1 << window) - 1, 0, 1, 2], dtype=np.int32)
        a = random_cols(rng, [m] * Bn, ctx.num_limbs, dev)
        k15(a, dig, m, ctx, window)
        if Bn == 64:
            # K12, K13 and K14 at their largest L
            k12_k13(a, random_cols(rng, [m] * Bn, ctx.num_limbs, dev), m,
                    ctx.num_limbs, Bn, ctx)
            exps = [int(e) for e in rng.integers(1, 1 << 20, size=Bn)]
            k14(a, mg.exponent_digits(exps, 8, 4).astype(np.int32), 3, m,
                ctx)
    # K12 and K13 over L = 2 to 520 at B=33, 2m - 1, 0 and 1 among the
    # operands: the modulus and n' recovered from the weights at every
    # (g, K), odd and even L, against K9 given the limbs and the twins
    r = random.Random(SEED + 12)
    Ls = list(range(2, 521, 5)) + [519, 520]
    t0 = time.perf_counter()
    for L in Ls:
        bits = 16 * L - 2
        m = r.getrandbits(bits) | (1 << (bits - 1)) | 1
        mc = mm.MatmulMontCtx(m, L, device=dev)
        w = (mc.W_mu, mc.W_m)
        c9 = mg.MontCtx.for_modulus(m, min_bits=16 * L, mxu=False,
                                    device=dev)
        a, b = (to_device(ints_to_limbs(
            [2 * m - 1, 0, 1] + [r.randrange(2 * m) for _ in range(30)], L),
            dev) for _ in range(2))
        got, sq = mont2.mm2_mul(a, b, *w), mont2.mm2_sqr(a, *w)
        same(got, mont.mont_mul_p(a, b, c9.n_limbs, c9.n0inv),
             f"K12 differs from K9 at L={L}, B=33")
        same(got, mont2.mm2_mul_plain(a, b, *w),
             f"K12 differs from its twin at L={L}, B=33")
        same(sq, mont.mont_mul_p(a, a, c9.n_limbs, c9.n0inv),
             f"K13 differs from K9(a, a) at L={L}, B=33")
        same(sq, mont2.mm2_sqr_plain(a, *w),
             f"K13 differs from its twin at L={L}, B=33")
    print(f"  mm2_mul, mm2_sqr equal K9 and their twins at B=33 over "
          f"{len(Ls)} L from 2 to 520 ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def ladder_halves(bits: int) -> tuple:
    """Two odd bits/2-bit numbers from a seeded generator whose product
    has exactly `bits` bits: the shapes of a `bits`-bit key's p, q and
    moduli (a kernel check needs no primes)."""
    import random
    r = random.Random(SEED + bits)
    h = bits // 2
    return tuple(r.getrandbits(h) | (3 << (h - 2)) | 1 for _ in range(2))


def rns_smem(k: int, CH: int, n_win: int = 16) -> dict:
    """Dynamic shared memory of the RNS tile kernels' launches at k, CH
    (csrc/rns.cu): K1 one uint16 state and the work area (the digit
    tile, delta); K2 and K6 two states and the work area, and W1 + W2
    where all of it fits the 232,448 B limit (else W is read from global
    memory); K5 two states, the work area and n_win windows' digits."""
    KP = -(-k // 16) * 16
    work = 32 * (2 * KP + 16) + 128
    w = 2 * (-(-2 * (k + 1) // 16)) * (2 * KP // 32) * 512
    two = 2 * CH * 64 + work
    fits = two + w <= 232448
    return dict(k1=CH * 64 + work, with_w=two + w, w_shared=fits,
                k2=two + w if fits else two, k5=two + 32 * n_win)


def check_ladder_kernels(dev, rng, record) -> None:
    """Phase 3 at the ladder's shapes (``LADDER``: 1024-, 3072- and
    4096-bit keys, each at its rung's batch; the moduli from
    ``ladder_halves``): K1 at each n^2 base (CH=263, 779, 1039); K3 at
    each p^2 and n^2 (L=65, 129, 193, 385, 257, 513); K4 (windows 3..8)
    at L=385 and 513; K5 at CH=779 and 1039 over 16 windows, and at 4096
    bits over the 1,024 windows of an exponent below n that
    ``fixed_shape_ops`` asks for; K2 at each p^2 base (CH=133 with W1, W2
    in shared memory, CH=389 and 519 reading them from global memory):
    the whole sliding-window schedule of p-1 at 1024 and 4096 bits, 64
    ops at B=256 and the whole schedule at 3072 bits; K7 at L=193 (4
    windows); K9 and K10 at keygen's per-element shapes, 1536- and
    2048-bit odd candidates (L=97, 129, B=256; K10 over 8 windows)."""
    import random
    import torch
    from pailliercryptolib_python_tpu_torch.ops import (mont, mont3, rns,
                                                        rns_kernels as rk,
                                                        montgomery as mg)
    for bits, B in LADDER:
        p, q = ladder_halves(bits)
        n = p * q
        nsq, psq = n * n, p * p
        ctx = mg.MontCtx.for_modulus(nsq, device=dev)
        base = rns.RnsBase.for_bits(-(-(2 * bits + 2) // 16) * 16, dev)
        key = rns.RnsModulus.build(base, nsq, ctx.num_limbs)
        o = rk.kernel_operands(base, key, dev)
        tile_bytes = nbytes(o["vec"], o["skc"], o["W1f"], o["W2f"])
        X = random_state(rng, base, B, dev)
        Y = random_state(rng, base, B, dev)
        got = rk.rns_mul(X, Y, base, key)
        record("rns_mul", got, rns.rns_mont_mul(X, Y, base, key),
               f"CH={base.CH} B={B} ({bits}-bit n^2)",
               ms_of(lambda: rk.rns_mul(X, Y, base, key), 20),
               ms_of(lambda: rns.rns_mont_mul(X, Y, base, key), 2),
               nbytes(X, Y, got) + tile_bytes, rns_ops(base.k, 1, B))
        if bits > 2048:
            w = 4
            for nw in (16, 1024) if bits == 4096 else (16,):
                dig = rng.integers(0, 1 << w, size=(nw, B)).astype(np.int32)
                dig.reshape(-1)[:1 << w] = np.arange(1 << w)
                dig_dev = torch.from_numpy(dig).to(dev)
                got = rk.rns_exp_elem_p(X, dig, base, key, w)
                want, plain_ms = timed(lambda: rns.rns_exp_elem(
                    X, dig_dev, base, key, w))
                record("rns_exp_elem", got, want,
                       f"CH={base.CH} B={B} w={w} {nw} windows "
                       f"({rns_smem(base.k, base.CH, nw)['k5']} B)",
                       ms_of(lambda: rk.rns_exp_elem_p(X, dig, base, key,
                                                       w), 1),
                       plain_ms, nbytes(X, dig_dev, got) + tile_bytes,
                       rns_ops(base.k, 14 + nw * (w + 1), B))
        # K3 at p^2 and n^2; K4 (the alignment's windows 3..8) at n^2
        for m in (psq, nsq):
            c = ctx if m == nsq else mg.MontCtx.for_modulus(m, device=dev)
            L = c.num_limbs
            a = random_cols(rng, [m] * B, L, dev)
            b = random_cols(rng, [m] * B, L, dev)
            got = mont3.mm3_mul(a, b, c)
            want = mont3.mm3_mul_plain(a, b, c.wmu, c.wm, c.off1, c.off2)
            record("mm3_mul", got, want, f"L={L} B={B} ({bits}-bit key)",
                   ms_of(lambda: mont3.mm3_mul(a, b, c), 5),
                   ms_of(lambda: mont3.mm3_mul_plain(a, b, c.wmu, c.wm,
                                                     c.off1, c.off2), 1),
                   nbytes(a, b, got, c.n_limbs), limb_ops(L, 1, B))
            if m == nsq and bits > 2048:
                exps = [int(e) for e in rng.integers(1, 1 << 20, size=B)]
                digits = mg.exponent_digits(exps, 8, 4).astype(np.int32)
                dig_dev = torch.from_numpy(digits).to(dev)
                got = mont3.mm3_exp(a, digits, c, 3)
                want, plain_ms = timed(lambda: mont3.mm3_exp_plain(
                    a, dig_dev, c.wmu, c.wm, c.off1, c.off2, c.one, 3))
                record("mm3_exp", got, want, f"L={L} B={B} win 3..8",
                       ms_of(lambda: mont3.mm3_exp(a, digits, c, 3), 2),
                       plain_ms, nbytes(a, dig_dev, got, c.one, c.n_limbs),
                       limb_ops(L, 14 + 5, B, 5 * 4))
            if m == psq and bits == 3072:
                window = mont3.shared_exp_window(L)
                check_k7(record, a, np.array([(1 << window) - 1, 0, 3, 1],
                                             dtype=np.int32), c, window)
        # K2 at the p^2 base, the decrypt's schedule of p-1
        pb = rns.RnsBase.for_bits(-(-psq.bit_length() // 16) * 16, dev)
        pkey = rns.RnsModulus.build(pb, psq,
                                    (psq.bit_length() + 2 + 15) // 16)
        po = rk.kernel_operands(pb, pkey, dev)
        window = rk.plan_sched(pb.CH)
        e = p - 1
        sched = rns.sliding_schedule(e, window, e.bit_length())
        sm = rns_smem(pb.k, pb.CH)
        where = f"W {'shared' if sm['w_shared'] else 'global'}, {sm['k2']} B"
        for Bc, s in (((256, sched[-64:]), (B, sched)) if bits == 3072
                      else ((B, sched),)):
            Xs = random_state(rng, pb, Bc, dev)
            got = rk.rns_exp_sched_p(Xs, s, pb, pkey, window)
            want, plain_ms = timed(lambda: rns.rns_exp_sched(
                Xs, s, pb, pkey, window))
            record("rns_exp_sched", got, want,
                   f"CH={pb.CH} B={Bc} w={window} {len(s)} ops, {where}",
                   ms_of(lambda: rk.rns_exp_sched_p(Xs, s, pb, pkey,
                                                    window), 1),
                   plain_ms, nbytes(Xs, got, po["vec"], po["skc"], po["W1f"],
                                    po["W2f"]) + 4 * len(s),
                   rns_ops(pb.k, (1 << (window - 1)) + len(s), Bc))
    # K9 and K10 at keygen's device Miller-Rabin shapes: odd 1536- and
    # 2048-bit candidates (3072- and 4096-bit keys), digits of
    # (c-1) >> tz, the chain's first 8 windows
    r = random.Random(SEED + 11)
    for cbits in (1536, 2048):
        cands = [r.getrandbits(cbits) | (1 << (cbits - 1)) | 1
                 for _ in range(256)]
        Lk = (cbits + 2 + 15) // 16
        ck = mg.MontCtx.for_moduli(cands, Lk, dev)
        ak = random_cols(rng, cands, Lk, dev)
        bk = random_cols(rng, cands, Lk, dev)
        got = mont.mont_mul_p(ak, bk, ck.n_limbs, ck.n0inv)
        record("mont_mul", got, mg.cios_mul(ak, bk, ck.n_limbs, ck.n0inv),
               f"L={Lk} B=256 per-element (keygen)",
               ms_of(lambda: mont.mont_mul_p(ak, bk, ck.n_limbs, ck.n0inv),
                     20),
               ms_of(lambda: mg.cios_mul(ak, bk, ck.n_limbs, ck.n0inv), 1),
               nbytes(ak, bk, got, ck.n_limbs, ck.n0inv), limb_ops(Lk, 1, 256))
        coop_note(Lk, 256, 1)
        ds = [(c - 1) >> (((c - 1) & -(c - 1)).bit_length() - 1)
              for c in cands]
        dk = np.ascontiguousarray(mg.exponent_digits(
            ds, -(-cbits // 4), 4)[:8].astype(np.int32))
        dk_dev = torch.from_numpy(dk).to(dev)
        got = mont.mont_exp_p(ak, dk, ck.n_limbs, ck.n0inv, ck.one, 0)
        want, plain_ms = timed(lambda: mont.mont_exp_plain(
            ak, dk_dev, ck.n_limbs, ck.n0inv, ck.one, 0))
        record("mont_exp", got, want,
               f"L={Lk} B=256 per-element 8 windows (keygen)",
               ms_of(lambda: mont.mont_exp_p(ak, dk, ck.n_limbs, ck.n0inv,
                                             ck.one, 0), 2),
               plain_ms, nbytes(ak, dk_dev, got, ck.one, ck.n_limbs,
                                ck.n0inv), limb_ops(Lk, 14 + 8, 256, 8 * 4))
        coop_note(Lk, 256, 14 + 8, 8 * 4)


def coop_floor_ms(L: int, products: int, B: int, squares: int = 0) -> float:
    """The integer-pipe floor of K8-K15 (the cooperative
    routine of csrc/coop.cuh): a product of W = ceil(L/2) 32-bit words
    is W^2 word products for a*b and W^2 for q*n, a square W(W+1)/2 + W^2,
    each two IMAD (low and high word), over 132 SMs x 64 IMAD a clock at
    the card's largest SM clock (nvidia-smi clocks.max.sm)."""
    W = (L + 1) // 2
    imad = 2 * B * (products * 2 * W * W + squares * (W * (W + 1) // 2
                                                      + W * W))
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    return 1e3 * imad / (132 * 64 * mhz * 1e6)


def coop_note(L: int, B: int, products: int, squares: int = 0) -> None:
    """Print a cooperative kernel's integer-pipe floor (with squarings,
    also the floor of running them as products) and its (g, K)."""
    from pailliercryptolib_python_tpu_torch import kernels
    g, K = kernels.mont_exp_shape(L, B)
    as_products = (f" ({coop_floor_ms(L, products + squares, B):.6f} ms "
                   f"with the squarings as products)" if squares else "")
    print(f"  {'':14s} integer-pipe floor "
          f"{coop_floor_ms(L, products, B, squares):.6f} ms{as_products}; "
          f"{g} lanes a column, {K} words a lane", flush=True)


def check_per_element(dev, kd, rng, record) -> None:
    """Phase 3, K9 and K10 with a modulus per column: the fused CRT
    decrypt's shape ([p^2]*4096 ++ [q^2]*4096, L=129, B=8192; K10 over
    all 256 windows of p-1 | q-1, the headline), and the keygen shape
    (1024-bit odd moduli, L=65, B=256: all 256 windows, the chain
    device_mr_base2 launches, then win_start=3 on the top 8); K10 also at
    B=1 and B=4095 (8 windows), with a shared (L, 1) modulus, and at
    L=520, B=64 and L=1040, B=2 (4 windows), each printed with its
    integer-pipe floor (``coop_floor_ms``); K9 at both shapes too."""
    import torch
    from pailliercryptolib_python_tpu_torch.ops import mont
    from pailliercryptolib_python_tpu_torch.ops import montgomery as mg

    def k10(a, dig, n, n0, one, ws, shape, headline=False):
        """K10 against its twin, with the floor and the (g, K) printed."""
        L, B = a.shape
        dig_dev = torch.from_numpy(dig).to(dev)
        nw = dig.shape[0] - ws
        got = mont.mont_exp_p(a, dig, n, n0, one, ws)
        want, plain_ms = timed(lambda: mont.mont_exp_plain(
            a, dig_dev, n, n0, one, ws))
        record("mont_exp", got, want, shape,
               ms_of(lambda: mont.mont_exp_p(a, dig, n, n0, one, ws), 1),
               plain_ms, nbytes(a, dig_dev, got, one, n)
               + (4 * B if isinstance(n0, torch.Tensor) else 4),
               limb_ops(L, 14 + nw, B, nw * 4), headline=headline)
        coop_note(L, B, 14 + nw, nw * 4)
    p, q = kd["p"], kd["q"]
    B2 = 2 * BATCH
    ms = [p * p] * BATCH + [q * q] * BATCH
    L = (max(m.bit_length() for m in ms) + 2 + 15) // 16
    ctx = mg.MontCtx.for_moduli(ms, L, dev)
    ctx_bytes = nbytes(ctx.n_limbs, ctx.n0inv)
    a = random_cols(rng, ms, L, dev)
    b = random_cols(rng, ms, L, dev)
    got = mont.mont_mul_p(a, b, ctx.n_limbs, ctx.n0inv)
    want = mg.cios_mul(a, b, ctx.n_limbs, ctx.n0inv)
    record("mont_mul", got, want, f"L={L} B={B2} per-element",
           ms_of(lambda: mont.mont_mul_p(a, b, ctx.n_limbs, ctx.n0inv), 5),
           ms_of(lambda: mg.cios_mul(a, b, ctx.n_limbs, ctx.n0inv), 1),
           nbytes(a, b, got) + ctx_bytes, limb_ops(L, 1, B2),
           headline=True)
    coop_note(L, B2, 1)
    # the headline: the eager twin runs ~1,294 products of L CIOS steps
    # (~32 s on an H100)
    nw = 256
    e = mg.exponent_digits([p - 1, q - 1], nw, 4).astype(np.int32)
    dig = np.ascontiguousarray(np.concatenate(
        [np.broadcast_to(e[:, :1], (nw, BATCH)),
         np.broadcast_to(e[:, 1:], (nw, BATCH))], axis=1))
    k10(a, dig, ctx.n_limbs, ctx.n0inv, ctx.one, 0,
        f"L={L} B={B2} per-element {nw} windows", headline=True)
    # one column, a ragged batch (8 windows), and a shared (L, 1) p^2
    for Bn in (1, BATCH - 1):
        c1 = mg.MontCtx.for_moduli(ms[-Bn:], L, dev)
        k10(a[:, -Bn:].contiguous(), np.ascontiguousarray(dig[:8, -Bn:]),
            c1.n_limbs, c1.n0inv, c1.one, 0,
            f"L={L} B={Bn} per-element 8 windows")
    sh = mg.MontCtx.for_modulus(p * p, mxu=False, device=dev)
    k10(a[:, :BATCH].contiguous(), np.ascontiguousarray(dig[:8, :BATCH]),
        sh.n_limbs, sh.n0inv, sh.one, 0, f"L={L} B={BATCH} shared (L, 1) "
        f"8 windows")
    # the keygen shape: 1024-bit odd moduli, digits of (c-1) >> tz
    import random
    r = random.Random(SEED)
    cands = [r.getrandbits(1024) | (1 << 1023) | 1 for _ in range(256)]
    Lk = (1024 + 2 + 15) // 16
    ck = mg.MontCtx.for_moduli(cands, Lk, dev)
    ak = random_cols(rng, cands, Lk, dev)
    # K9 at the keygen ladder's shape (device_mr_base2's squarings)
    bk = random_cols(rng, cands, Lk, dev)
    got = mont.mont_mul_p(ak, bk, ck.n_limbs, ck.n0inv)
    record("mont_mul", got, mg.cios_mul(ak, bk, ck.n_limbs, ck.n0inv),
           f"L={Lk} B=256 per-element",
           ms_of(lambda: mont.mont_mul_p(ak, bk, ck.n_limbs, ck.n0inv), 20),
           ms_of(lambda: mg.cios_mul(ak, bk, ck.n_limbs, ck.n0inv), 1),
           nbytes(ak, bk, got, ck.n_limbs, ck.n0inv), limb_ops(Lk, 1, 256))
    coop_note(Lk, 256, 1)
    ds = [(c - 1) >> (((c - 1) & -(c - 1)).bit_length() - 1) for c in cands]
    for nwk, ws in ((256, 0), (8, 3)):
        dk = mg.exponent_digits([d >> (4 * (256 - nwk)) for d in ds], nwk,
                                4).astype(np.int32)
        k10(ak, dk, ck.n_limbs, ck.n0inv, ck.one, ws,
            f"L={Lk} B=256 per-element windows {ws}..{nwk}")
    # large L: random odd moduli of 520 and 1040 limbs (R > 4n), 4 windows
    for Lb, Bb in ((520, 64), (mont.MAX_LIMBS, 2)):
        bits = 16 * Lb - 2
        mb = [r.getrandbits(bits) | (1 << (bits - 1)) | 1 for _ in range(Bb)]
        cb = mg.MontCtx.for_moduli(mb, Lb, dev)
        db = rng.integers(0, 16, size=(4, Bb)).astype(np.int32)
        k10(random_cols(rng, mb, Lb, dev), db, cb.n_limbs, cb.n0inv, cb.one,
            0, f"L={Lb} B={Bb} per-element 4 windows")


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
                ops_decrypt=ops_dec, pk=pk, sk=sk, x=x, ct_x=ct_x)


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
    sync_audit(sk, ct_x, ct_y, ct_v, w, W, x, v)

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
    return dict(times=times, counts=counts, exps=exps)


def sync_audit(sk, ct_x, ct_y, ct_v, w, W, x, v) -> None:
    """Phase 6: no host synchronization inside decrypt, ``+``, ``x * w``,
    ``dot`` and ``@`` at B=4096 (every upload is pinned and asynchronous,
    every per-key digit tensor already on the card), each run once more
    under ``torch.cuda.set_sync_debug_mode("error")``.  The decrypt runs to
    its plaintext limbs on the card (``decrypt_device``; the copy of the
    plaintexts to the host is the result itself).  A negative weight
    inverts its column through the product tree, whose root is inverted
    on the host by design (``mont_inv_tree_hostroot``, as in the
    reference): so x * w, dot and @ run under "error" with the weights'
    magnitudes, and with the mixed-sign weights under "warn", where every
    synchronization must come from that root's read-back."""
    import traceback
    import warnings
    import torch
    priv = sk.prikey.context
    ct_dev = ct_x.ciphertext().device_array()
    wa, Wa = np.abs(w), np.abs(W)
    runs = (("decrypt", lambda: priv.decrypt_device(ct_dev), None),
            ("x+y", lambda: ct_x + ct_y, None),
            ("x*|w|", lambda: ct_x * wa, x * wa),
            ("x.dot(|w|)", lambda: ct_x.dot(wa), x @ wa),
            ("v@|W|", lambda: ct_v @ Wa, v @ Wa))
    for label, fn, want in runs:
        fn()                              # warm: per-key tensors, caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if want is not None and not np.allclose(sk.decrypt(out), want):
            raise AssertionError(f"{label} under the sync check differs")
    print("  no host synchronization (set_sync_debug_mode 'error') in "
          f"{', '.join(r[0] for r in runs)} at B={BATCH}", flush=True)
    for label, fn in (("x*w", lambda: ct_x * w), ("x.dot(w)",
                                                   lambda: ct_x.dot(w)),
                      ("v@W", lambda: ct_v @ W)):
        stacks = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = lambda *a, **k: stacks.append(
                (str(a[0]), "".join(traceback.format_stack())))
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [st for msg, st in stacks
                 if msg.startswith("called a synchronizing")]
        other = [st for st in syncs if "mont_inv_tree_hostroot" not in st]
        print(f"  {label}: {len(syncs)} synchronization(s), each the "
              f"inversion tree's root read back to the host", flush=True)
        if other:
            raise AssertionError(f"{label} synchronizes outside the host "
                                 f"root: {other[0][-1500:]}")


def third_slice(dev, kd, tag: str, exps: list) -> dict:
    """Phase 7: device-MR keygen, the limb encrypt engine, the fused
    per-element CRT decrypt and a weightless n^2 context at the fixture
    key's size (2048 bits), B=4096.  `exps` are phase 6's 53-bit ct*pt
    exponents."""
    import random
    import torch
    import pailliercryptolib_python_tpu_torch as pt
    from pailliercryptolib_python_tpu_torch import kernels, native
    from pailliercryptolib_python_tpu_torch.fixedpoint import encode_vector
    from pailliercryptolib_python_tpu_torch.models import paillier as sch
    from pailliercryptolib_python_tpu_torch.ops import montgomery as mg
    from pailliercryptolib_python_tpu_torch.ops import rns
    from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints

    rng = np.random.default_rng(SEED + 3)
    x = rng.uniform(-1000.0, 1000.0, BATCH)
    bits = 2 * kd["p"].bit_length()         # keygen's size: 2048
    times = {}
    kernels.reset_counts()

    # keygen: the base-2 round device-batched (K10, K9), then host only
    pt.set_config(keygen_device="1")
    try:
        (pk, sk), times["keygen_device_s"] = wall(
            lambda: pt.PaillierKeypair.generate_keypair(bits, True,
                                                        device=dev))
    finally:
        pt.set_config(keygen_device="0")
    kp, kq = sk.prikey.context.p, sk.prikey.context.q
    if not (sch.is_probable_prime(kp) and sch.is_probable_prime(kq)
            and kp * kq == pk.n and pk.n.bit_length() == bits):
        raise AssertionError("device-MR keygen: p, q or n is wrong")
    got, times["keygen_key_roundtrip_s"] = wall(
        lambda: sk.decrypt(pk.encrypt(x)))
    if not np.allclose(got, x):
        raise AssertionError("device-MR key: decrypt(encrypt(x)) != x")
    _, times["keygen_host_s"] = wall(
        lambda: pt.PaillierKeypair.generate_keypair(bits, True, device=dev))

    # device_mr_base2 against the host oracle: one sieve window's
    # survivors at bits/2 (1024), and the fixture's primes
    r = random.Random(SEED)
    half = bits // 2
    base = r.getrandbits(half) | (1 << (half - 1)) | 1
    mask = native.sieve_window(base, 2048, sch._SMALL_PRIMES)
    cands = [base + 2 * j for j in range(len(mask))
             if mask[j] and (base + 2 * j).bit_length() == half]
    cands += [kd["p"], kd["q"]]
    ok, times["device_mr_window_s"] = wall(
        lambda: sch.device_mr_base2(cands, dev))

    def oracle(c):
        d, t = c - 1, 0
        while d % 2 == 0:
            d, t = d // 2, t + 1
        return sch._mr_round(c, d, t, 2)
    want = [oracle(c) for c in cands]
    if list(ok) != want:
        raise AssertionError("device_mr_base2 differs from the host oracle")
    print(f"  device_mr_base2: {len(cands)} candidates, {sum(want)} pass "
          f"base 2, equal to the host oracle", flush=True)

    # the limb encrypt engine against the RNS engine, same digits
    ctx_args = (kd["n"], kd["bits"], True, kd["hs"], kd["randbits"])
    msgs, _ = encode_vector(x, kd["n"], kd["n"] // 3 - 1)
    pt.set_config(encrypt_engine="limb")
    try:
        limb = sch.PublicContext(*ctx_args, device=dev)
        _, times["limb_comb_build_s"] = wall(lambda: limb.comb_table)
        digs = limb.sample_obfuscator_digits(BATCH)
        limb.sample_obfuscator_digits = lambda b: digs
        ct_l, times["limb_encrypt_s"] = wall(lambda: limb.encrypt(msgs))
    finally:
        pt.set_config(encrypt_engine="auto")
    rctx = sch.PublicContext(*ctx_args, device=dev)
    if rctx.comb_window != limb.comb_window:
        raise AssertionError("limb and RNS engines chose other windows")
    _, times["rns_comb_build_s"] = wall(lambda: rctx.comb_rns)
    rctx.sample_obfuscator_digits = lambda b: digs
    ct_r, times["rns_encrypt_s"] = wall(lambda: rctx.encrypt(msgs))
    if limb.export_cts(ct_l, BATCH) != rctx.export_cts(ct_r, BATCH):
        raise AssertionError("the limb and RNS encrypt engines differ")
    del limb.sample_obfuscator_digits          # fresh digits from here
    pt.set_config(encrypt_engine="limb")
    try:
        lpk = pt.PaillierPublicKey(pt.ipclPublicKey(None, _context=limb))
        lsk = pt.PaillierPrivateKey(lpk, kd["p"], kd["q"])
        ct_x, times["limb_encrypt_api_s"] = wall(lambda: lpk.encrypt(x))
        before = ct_x.ciphertext().host_ints()
        plain = lsk.raw_decrypt(ct_x)
        _, times["limb_apply_obfuscator_s"] = wall(ct_x.apply_obfuscator)
    finally:
        pt.set_config(encrypt_engine="auto")
    after = ct_x.ciphertext().host_ints()
    if any(a == b for a, b in zip(before, after)):
        raise AssertionError("limb apply_obfuscator left a ciphertext")
    if lsk.raw_decrypt(ct_x) != plain:
        raise AssertionError("limb apply_obfuscator changed a plaintext")
    if not np.allclose(lsk.decrypt(ct_x), x):
        raise AssertionError("limb engine: decrypt(encrypt(x)) != x")

    # stage 2 of the CRT decrypt on the same stage-1 output: the fused
    # per-element chain (K10), K7's two halves, K2's two halves
    priv = lsk.prikey.context
    ct_dev = ct_x.ciphertext().device_array()
    B = ct_dev.shape[1]
    base_m = sch._crt_stage_reduce(ct_dev, priv)
    sq = priv._sq_ctx(B)
    u10, times["stage2_K10_s"] = wall(lambda: sch._crt_stage_exp(
        base_m, sq, priv.exp_digits_pq, priv.n_win_dec))
    u7, times["stage2_K7_s"] = wall(lambda: torch.cat([
        sch._crt_stage_exp_half(base_m[:, :B], priv._sq_p, priv.dig_p,
                                priv.dec_window),
        sch._crt_stage_exp_half(base_m[:, B:], priv._sq_q, priv.dig_q,
                                priv.dec_window)], dim=1))
    u2, times["stage2_K2_s"] = wall(lambda: torch.cat([
        rns.rns_crt_exp_sched(base_m[:, :B], priv.rsched_p, priv.rns_base,
                              priv.rns_p, priv._sq_p, priv.rns_sched_window,
                              priv.Lh),
        rns.rns_crt_exp_sched(base_m[:, B:], priv.rsched_q, priv.rns_base,
                              priv.rns_q, priv._sq_q, priv.rns_sched_window,
                              priv.Lh)], dim=1))
    if not torch.equal(u10, u7):
        raise AssertionError("fused stage 2 (K10) differs from K7's halves")
    ints10 = limbs_to_ints(sch._crt_stage_recombine(u10, priv))
    if ints10 != limbs_to_ints(sch._crt_stage_recombine(u2, priv)):
        raise AssertionError("fused stage 2 (K10) differs from K2's")
    print("  stage 2: K10 equals K7's halves limb for limb; plaintexts "
          "equal K2's", flush=True)

    # a weightless n^2 context: K9 against K3, K10 against K4
    wctx = limb.ctx
    c0 = mg.MontCtx.for_modulus(kd["n"] ** 2, mxu=False, device=dev)
    ct_y = ct_r
    m9, times["weightless_K9_mul_s"] = wall(lambda: mg.mont_mul(ct_dev, ct_y,
                                                                c0))
    m3, times["weightless_K3_mul_s"] = wall(lambda: mg.mont_mul(ct_dev, ct_y,
                                                                wctx))
    if not torch.equal(m9, m3):
        raise AssertionError("weightless n^2: K9 differs from K3")
    need = max(1, -(-max(int(e).bit_length() for e in exps) // 4))
    total = max(limb.n_win_ct, need)
    digits = mg.exponent_digits(exps, total, 4)
    e10, times["weightless_K10_ctpt_s"] = wall(
        lambda: mg.mont_exp(ct_dev, digits, c0, 4, total - need))
    e4, times["weightless_K4_ctpt_s"] = wall(
        lambda: mg.mont_exp(ct_dev, digits, wctx, 4, total - need))
    if not torch.equal(e10, e4):
        raise AssertionError("weightless n^2: K10 differs from K4")
    print(f"  weightless n^2: K9 equals K3, K10 equals K4 ({need} windows)",
          flush=True)

    counts = dict(kernels.COUNTS)
    for k, t in times.items():
        print(f"  {k:24s} {t:10.4f} s   ({tag})", flush=True)
    print(f"  kernel launches over phase 7: {counts}", flush=True)
    return dict(times=times, counts=counts, limb=limb)


def fourth_slice(dev, kd, tag: str, mp: dict, limb) -> dict:
    """Phase 8: the runtime controls, K6 on the decrypt halves, K7 in the
    limb decrypt, K8 against K3, K11 on the encrypt chain, the profiling
    hooks and the comb LRU registry, at 2048 bits, B=4096.  `mp` is phase
    4's result (its keys and ciphertexts) and `limb` phase 7's limb
    encrypt context."""
    import tempfile
    import warnings
    import torch
    import pailliercryptolib_python_tpu_torch as pt
    from pailliercryptolib_python_tpu_torch import kernels
    from pailliercryptolib_python_tpu_torch.fixedpoint import encode_vector
    from pailliercryptolib_python_tpu_torch.models import paillier as sch
    from pailliercryptolib_python_tpu_torch.ops import mont3, rns
    from pailliercryptolib_python_tpu_torch.ops import montgomery as mg
    from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints
    from pailliercryptolib_python_tpu_torch.utils import config as cfgmod
    from pailliercryptolib_python_tpu_torch.utils import profiling
    from pailliercryptolib_python_tpu_torch.utils.context import (
        context, hybridControl, hybridMode)

    times = {}
    kernels.reset_counts()
    pk, sk, x, ct_x = mp["pk"], mp["sk"], mp["x"], mp["ct_x"]
    pctx = pk.pubkey.context
    priv = sk.prikey.context
    cfg = pt.get_config()
    saved = (cfg.encrypt_pipeline_chunks, cfg.encrypt_host_ratio,
             cfg.comb_hbm_budget_bytes)

    def restore():
        hybridControl.setHybridMode(hybridMode.UNDEFINED)
        context.terminateContext()
        pt.set_config(encrypt_pipeline_chunks=saved[0],
                      encrypt_host_ratio=saved[1],
                      comb_hbm_budget_bytes=saved[2])

    # 1. runtime controls, no context initialized: a mode sets the chunk
    # count and the host share; a host share > 0 turns chunking off (the
    # split stays off too until initializeContext), so HALF and IPP run
    # one unchunked path here and chunks 2 and 8 are set directly
    pk.encrypt(x)                                     # warm the comb
    want_ints = sk.raw_decrypt(ct_x)
    try:
        for mode, want_chunks in ((hybridMode.QAT, 1), (hybridMode.OPTIMAL, 4),
                                  (hybridMode.HALF, 2), (hybridMode.IPP, 8)):
            hybridControl.setHybridMode(mode)
            if (cfg.encrypt_pipeline_chunks != want_chunks
                    or hybridControl.getHybridMode() != mode):
                raise AssertionError(f"{mode.name}: chunks "
                                     f"{cfg.encrypt_pipeline_chunks}")
            ct, times[f"encrypt_{mode.name}_s"] = wall(lambda: pk.encrypt(x))
            if len(ct) != BATCH or not np.allclose(sk.decrypt(ct), x):
                raise AssertionError(f"{mode.name}: encrypt/decrypt differs")
            lo = BATCH // 4 - 24                  # across the first boundary
            if mode == hybridMode.OPTIMAL and not np.allclose(
                    sk.decrypt(ct[lo:lo + 50]), x[lo:lo + 50]):
                raise AssertionError("a slice across a chunk boundary "
                                     "decrypts wrong")
        for chunks in (2, 8):
            pt.set_config(encrypt_pipeline_chunks=chunks,
                          encrypt_host_ratio=0.0)
            ct, times[f"encrypt_{chunks}_chunks_s"] = wall(
                lambda: pk.encrypt(x))
            if not np.allclose(sk.decrypt(ct), x):
                raise AssertionError(f"{chunks} chunks: decrypt differs")
        # host synchronizations inside one device encrypt call
        pt.set_config(encrypt_pipeline_chunks=1)
        encs, _ = encode_vector(x, pctx.n, pk.max_int)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pctx.encrypt(encs)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message).lower()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pctx.encrypt(encs)
        times["encrypt_enqueued_after_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        times["encrypt_finished_after_s"] = time.perf_counter() - t0
        print(f"  host synchronizations inside PublicContext.encrypt: "
              f"{len(syncs)}; the call returns after "
              f"{times['encrypt_enqueued_after_s']:.4f} s, the device is "
              f"done after {times['encrypt_finished_after_s']:.4f} s",
              flush=True)
        if syncs:
            raise AssertionError(f"encrypt synchronizes: {syncs[:3]}")

        # 2. the hybrid split, context initialized
        calls = []
        orig = sch.PublicContext.host_encrypt

        def spy(self, encodings, apply_obfuscator=True):
            calls.append(len(encodings))
            return orig(self, encodings, apply_obfuscator)

        sch.PublicContext.host_encrypt = spy
        try:
            context.initializeContext("QAT")
            if not context.isQATRunning():
                raise AssertionError("isQATRunning() false on the card")
            hybridControl.setHybridMode(hybridMode.PREF_QAT90)
            ct, times[f"encrypt_split_QAT90_{BATCH}_s"] = wall(
                lambda: pk.encrypt(x))
            hybridControl.setHybridMode(hybridMode.IPP)
            cti, times[f"encrypt_IPP_{HOST_BATCH}_s"] = wall(
                lambda: pk.encrypt(x[:HOST_BATCH]))
        finally:
            sch.PublicContext.host_encrypt = orig
        if calls != [int(BATCH * 0.1), HOST_BATCH]:
            raise AssertionError(f"host_encrypt calls {calls}")
        if (sk.raw_decrypt(ct) != want_ints
                or sk.raw_decrypt(cti) != want_ints[:HOST_BATCH]):
            raise AssertionError("split encrypt: plaintexts differ")
        # the split's first ciphertexts and IPP's both came off the host
        # thread, of the same values under fresh randomness
        a, b = (c.ciphertext().host_ints() for c in (ct[:HOST_BATCH], cti))
        if any(u == v for u, v in zip(a, b)):
            raise AssertionError("two encryptions of one value are equal")
        print(f"  hybrid split: host_encrypt sizes {calls}, plaintexts exact",
              flush=True)
    finally:
        restore()

    # 4. K6 on the decrypt path: both halves through the fixed-window
    # chain (K6) and the sliding-window chain (K2) from one stage 1
    ct_dev = ct_x.ciphertext().device_array()
    B = ct_dev.shape[1]
    base_m = sch._crt_stage_reduce(ct_dev, priv)
    u6, times["stage2_K6_s"] = wall(lambda: torch.cat([
        rns.rns_crt_exp_half(base_m[:, :B], priv.rdig_p, priv.rns_base,
                             priv.rns_p, priv._sq_p, priv.rns_window, priv.Lh),
        rns.rns_crt_exp_half(base_m[:, B:], priv.rdig_q, priv.rns_base,
                             priv.rns_q, priv._sq_q, priv.rns_window,
                             priv.Lh)], dim=1))
    u2, times["stage2_K2_s"] = wall(lambda: torch.cat(
        priv._rns_exp_halves(base_m), dim=1))
    if not torch.equal(u6, u2):
        raise AssertionError("stage 2: K6's halves differ from K2's")
    ints6 = limbs_to_ints(sch._crt_stage_recombine(u6, priv))[:BATCH]
    if ints6 != want_ints:
        raise AssertionError("K6 decrypt: plaintexts differ")
    print(f"  stage 2: K6 (window {priv.rns_window}, {len(priv.rdig_p)} "
          f"windows) equals K2 limb for limb; plaintexts equal", flush=True)

    # 5. The limb decrypt's stage 2 (K7, the tile chain) against the
    # fused per-element stage (K10) and K2; K8 against K3's product
    pt.set_config(decrypt_engine="limb")
    try:
        lpriv = sch.PrivateContext(pctx, kd["p"], kd["q"])
    finally:
        pt.set_config(decrypt_engine="auto")
    u7, times["stage2_K7_s"] = wall(lambda: torch.cat(
        lpriv._limb_exp_halves(base_m), dim=1))
    u10, times["stage2_K10_s"] = wall(lambda: sch._crt_stage_exp(
        base_m, lpriv._sq_ctx(B), lpriv.exp_digits_pq, lpriv.n_win_dec))
    if not (torch.equal(u7, u10) and torch.equal(u7, u2)):
        raise AssertionError("limb stage 2: K7 differs from K10 or K2")
    a = base_m[:, :B]
    if not torch.equal(mont3.mm3_sqr(a, lpriv._sq_p),
                       mg.mont_mul(a, a, lpriv._sq_p)):
        raise AssertionError("mm3_sqr differs from the product")
    print("  limb stage 2: K7 equals K10 and K2 limb for limb; K8 equals "
          "the product", flush=True)

    # 6. K11 on the encrypt chain: gather + one fused chain against the
    # streamed chain, the same digits
    comb = limb.comb_table
    encs, _ = encode_vector(x, limb.n, limb.n // 3 - 1)
    digs = limb.sample_obfuscator_digits(BATCH)
    ct0 = limb.encrypt_raw(limb.encodings_to_device(encs))
    c_s, times["encrypt_chain_streamed_s"] = wall(
        lambda: mg.mont_exp_fixed_base(comb, digs, limb.ctx, acc0=ct0))
    c_f, times["encrypt_chain_K11_s"] = wall(
        lambda: mg.mont_exp_fixed_base_chain(comb, digs, limb.ctx, ct0))
    if not torch.equal(c_s, c_f):
        raise AssertionError("K11's chain differs from the streamed chain")
    if limb.export_cts(c_f, BATCH) != limb.export_cts(c_s, BATCH):
        raise AssertionError("K11: exported ciphertexts differ")
    if priv.decrypt_to_ints(c_f, BATCH) != list(encs):
        raise AssertionError("K11: ciphertexts decrypt wrong")
    fbytes = comb.shape[0] * comb.shape[1] * BATCH * 4
    print(f"  encrypt chain: K11 equals the streamed chain limb for limb; "
          f"factor array {fbytes} bytes", flush=True)

    # 7. profile_stages under profiling.timed, one profiling.trace
    sink = []
    stages = priv.profile_stages(ct_dev, BATCH)
    for name, thunk in stages.items():
        with profiling.timed(name, sink):
            out = thunk()
    if sorted(stages) != ["stage1_reduce", "stage2_rns_p_half",
                          "stage2_rns_q_half", "stage3_recombine",
                          "stage4_d2h", "stage5_to_ints"]:
        raise AssertionError(f"profile_stages: {sorted(stages)}")
    if stages["stage5_to_ints"]() != ints6:
        raise AssertionError("profile_stages: plaintexts differ")
    for name, dt in sink:
        times[name + "_s"] = dt
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            with profiling.annotate("encrypt"):
                pk.encrypt(x[:256])
        files = os.listdir(tmp)
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in files)
    if not files or size == 0:
        raise AssertionError("profiling.trace wrote no trace")
    print(f"  profiling.trace wrote {files} ({size} bytes)", flush=True)

    # 3. the comb registry: a budget for two RNS combs, three keys
    reg = cfgmod.comb_registry
    for owner, _ in list(reg._entries.values()):
        owner.free()
    del comb, limb, c_s, c_f, ct0
    comb_bytes = pctx.comb_rns.numel() * 4    # 86 x 521 x 4096 x 4 at 2048
    try:
        pt.set_config(comb_hbm_budget_bytes=int(2.5 * comb_bytes))
        keys = [(pk, sk)] + [pt.PaillierKeypair.generate_keypair(
            2 * kd["p"].bit_length(), True, device=dev) for _ in range(2)]
        ctxs = [k[0].pubkey.context for k in keys]
        mem = []
        for kpk, _ in keys:
            kpk.encrypt(x[:256])
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
        print(f"  comb registry: budget {cfg.comb_hbm_budget_bytes}, one RNS "
              f"comb {comb_bytes}, registered {reg.total_bytes}; "
              f"memory_allocated after key 1, 2, 3: {mem}", flush=True)
        if not (ctxs[0]._comb_rns is None and ctxs[1]._comb_rns is not None
                and ctxs[2]._comb_rns is not None and len(reg) == 2
                and reg.total_bytes <= cfg.comb_hbm_budget_bytes
                and mem[2] - mem[1] < comb_bytes // 2
                and mem[1] - mem[0] > comb_bytes // 2):
            raise AssertionError("comb registry: key 1 was not evicted")
        ctxs[1].comb_rns                          # touch key 2
        ct1 = keys[0][0].encrypt(x[:256])         # rebuilds key 1
        if not (ctxs[2]._comb_rns is None and ctxs[1]._comb_rns is not None
                and ctxs[0]._comb_rns is not None and len(reg) == 2):
            raise AssertionError("comb registry: touch did not keep key 2")
        if not np.allclose(keys[0][1].decrypt(ct1), x[:256]):
            raise AssertionError("comb registry: key 1 after its rebuild")
        for c in ctxs[1:]:
            c.free()
    finally:
        restore()

    counts = dict(kernels.COUNTS)
    for k, t in times.items():
        print(f"  {k:26s} {t:10.4f} s   ({tag})", flush=True)
    print(f"  kernel launches over phase 8: {counts}", flush=True)
    return dict(times=times, counts=counts)


def fifth_slice(dev, tag: str) -> dict:
    """Phase 9: ``tools/torch_kbench.py``'s subcommands in-process on the
    card at full width.  Every variant must be ok against Python's
    ``pow`` and the variants of one function equal limb for limb.  The
    chains (exp, expshared) are timed on their checked call alone
    (``--iters 0``): K14's 256 windows are 1,294 products."""
    from pailliercryptolib_python_tpu_torch import kernels

    kb = load_script("tools/torch_kbench.py")
    runs = (["mul", "--L", "257", "--B", str(BATCH), "--chain", "16"],
            ["sqr", "--L", "129", "--B", str(BATCH)],
            ["exp", "--L", "257", "--B", str(BATCH), "--nwin", "256",
             "--iters", "0"],
            ["expshared", "--L", "129", "--B", str(BATCH), "--ebits", "1024",
             "--window", "5", "--variants", "v2,v3,rns,rnssched",
             "--iters", "0"],
            ["crt", "--bits", "2048", "--B", str(BATCH)])
    times = {}
    kernels.reset_counts()
    for argv in runs:
        res, times[argv[0] + "_s"] = wall(lambda: kb.run(argv))
        bad = [n for n, v in res["variants"].items() if not v["ok"]]
        if bad or not res["agree"]:
            raise AssertionError(f"torch_kbench {' '.join(argv)}: not ok "
                                 f"{bad}, variants agree {res['agree']}")
    counts = dict(kernels.COUNTS)
    for k, t in times.items():
        print(f"  {k:26s} {t:10.4f} s   ({tag})", flush=True)
    print(f"  kernel launches over phase 9: {counts}", flush=True)
    return dict(times=times, counts=counts)


def sixth_slice(dev, kd, tag: str) -> dict:
    """Phase 10: the sharded layer (``parallel/``) in a world-size-1 NCCL
    group (file init in a temporary directory, destroyed at the end of
    the phase) at the 2048-bit key, B=4096 integer values (exponent 0, so
    the API's ``x.sum()`` and ``x + y + z`` are the plain fold and
    products): ``sharded_decrypt`` against ``decrypt_device``,
    ``sharded_mul_pt`` against ``mul_pt`` under ``fixed_shape_ops`` (the
    full window count), ``sharded_he_sum`` against ``x.sum()``'s
    ciphertext and ``federated_aggregate`` of 3 parties against ``x + y
    + z``'s, all limb for limb and each timed beside the unsharded op
    (CUDA events, 3 calls); ``count_collectives`` finds no collective in
    the decrypt, the ct*pt and the aggregate and one all-gather in the
    sum; then ``entry()``'s 2048-bit encrypt step (decrypted against its
    messages) and ``dryrun_multichip(1)``."""
    import tempfile
    import torch
    import torch.distributed as dist
    import pailliercryptolib_python_tpu_torch as pt
    from pailliercryptolib_python_tpu_torch import kernels
    from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints
    from pailliercryptolib_python_tpu_torch.parallel import collective as coll
    from pailliercryptolib_python_tpu_torch.parallel import distributed as pd
    from pailliercryptolib_python_tpu_torch.parallel import entry as pentry
    from pailliercryptolib_python_tpu_torch.parallel import mesh as pmesh
    from pailliercryptolib_python_tpu_torch.parallel import sharded_ops as so

    rng = np.random.default_rng(SEED + 10)
    x, y, z = (rng.integers(0, 10**6, size=BATCH) for _ in range(3))
    w = [int(v) for v in rng.integers(1, 1 << 53, size=BATCH)]
    times = {}
    kernels.reset_counts()
    tmp = tempfile.TemporaryDirectory()
    assert pd.initialize(init_method=f"file://{tmp.name}/store",
                         num_processes=1, process_id=0, device=dev)
    try:
        if dist.get_backend() != pd.backend_for(dev):
            raise AssertionError(f"group backend {dist.get_backend()}")
        mesh = pmesh.make_mesh(device_type=dev.type)
        ipub = pt.ipclPublicKey(kd["n"], kd["bits"], True, kd["hs"],
                                kd["randbits"], device=dev)
        pk = pt.PaillierPublicKey(ipub)
        sk = pt.PaillierPrivateKey(pk, kd["p"], kd["q"])
        pub, priv = pk.pubkey.context, sk.prikey.context
        cx, cy, cz = (pk.encrypt(v) for v in (x, y, z))
        dx, dy, dz = (c.ciphertext().device_array() for c in (cx, cy, cz))
        shard = pmesh.shard_batch(dx, mesh)

        def pair(name, sharded, plain, calls_allowed):
            """Run both, compare limb for limb, count the sharded call's
            collectives, time both."""
            with coll.count_collectives() as calls:
                got = sharded()
            want = plain()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from the unsharded op")
            if dict(calls) != calls_allowed:
                raise AssertionError(f"{name} ran collectives {dict(calls)}, "
                                     f"expected {calls_allowed}")
            times[name + "_ms"] = ms_of(sharded, 3)
            times[name + "_unsharded_ms"] = ms_of(plain, 3)
            seen = dict(calls) or "no collectives"
            print(f"  {name:22s} equals the unsharded op; {seen}; "
                  f"{times[name + '_ms']:.3f} ms against "
                  f"{times[name + '_unsharded_ms']:.3f} ms unsharded ({tag})",
                  flush=True)
            return got

        plain = pair("sharded_decrypt",
                     lambda: so.sharded_decrypt(priv, shard, mesh),
                     lambda: priv.decrypt_device(dx), {})
        if limbs_to_ints(plain)[:BATCH] != [int(v) for v in x]:
            raise AssertionError("sharded_decrypt != x")
        prev = pt.get_config().fixed_shape_ops
        pt.set_config(fixed_shape_ops=True)
        try:
            scaled = pair("sharded_mul_pt",
                          lambda: so.sharded_mul_pt(pub, shard, w, mesh),
                          lambda: pub.mul_pt(dx, w), {})
        finally:
            pt.set_config(fixed_shape_ops=prev)
        n = kd["n"]
        if priv.decrypt_to_ints(scaled, BATCH) != [
                int(a) * b % n for a, b in zip(x, w)]:
            raise AssertionError("sharded_mul_pt decrypts wrong")
        total = pair("sharded_he_sum",
                     lambda: coll.sharded_he_sum(shard, pub.ctx, mesh),
                     lambda: cx.sum().ciphertext().device_array()[:, :1],
                     {"all_gather": 1})
        if priv.decrypt_to_ints(total, 1)[0] != int(x.sum()):
            raise AssertionError("sharded_he_sum decrypts wrong")
        pair("federated_aggregate",
             lambda: coll.federated_aggregate(
                 [pmesh.shard_batch(d, mesh) for d in (dx, dy, dz)],
                 pub.ctx, mesh),
             lambda: (cx + cy + cz).ciphertext().device_array(), {})
        fn, args = pentry.entry(device=dev)
        ct, times["entry_step_s"] = wall(lambda: fn(*args))
        msgs = [int(v) for v in np.random.default_rng(0).integers(
            0, 2**60, size=ct.shape[1])]
        if priv.decrypt_to_ints(ct, len(msgs)) != msgs:
            raise AssertionError("entry()'s encrypt step decrypts wrong")
        res, times["dryrun_multichip_1_s"] = wall(
            lambda: pentry.dryrun_multichip(1, device=dev))
        print(f"  entry() step on {ct.shape[1]} columns "
              f"{times['entry_step_s']:.4f} s; dryrun_multichip(1) {res} "
              f"{times['dryrun_multichip_1_s']:.4f} s ({tag})", flush=True)
    finally:
        pd.shutdown()
        tmp.cleanup()
    if dist.is_initialized():
        raise AssertionError("the process group outlived phase 10")
    counts = dict(kernels.COUNTS)
    print(f"  kernel launches over phase 10: {counts}", flush=True)
    return dict(times=times, counts=counts)


def load_script(rel: str):
    """A script of this repository (tools/, examples/) as a module."""
    import importlib.util
    name = os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(rel: str, argv: list, done: str):
    """Run an example's ``main(argv)`` in this process, print its output
    indented and fail unless it printed `done`; returns (result, s)."""
    import contextlib
    import io
    buf = io.StringIO()
    mod = load_script(rel)
    with contextlib.redirect_stdout(buf):
        res, secs = wall(lambda: mod.main(argv))
    for line in buf.getvalue().splitlines():
        print("    " + line, flush=True)
    if done not in buf.getvalue():
        raise AssertionError(f"{rel} {' '.join(argv)} did not print {done!r}")
    return res, secs


def ladder_rung(dev, bits: int, B: int, tag: str) -> dict:
    """Phase 11 at one rung of 3072 or 4096 bits, batch B, through the
    public API on the default engines: keygen (3072: the prime pool;
    4096: the device-batched base-2 Miller-Rabin, K10 and K9, in this
    process), the comb build, encrypt of B floats x and y (K1), decrypt
    (K2), ``x + y``, ``x.sum()``, ``x * w`` with about half the weights
    negative (K5 and the inversion tree), ``x.dot(w)``, each result
    against numpy; one ciphertext column under injected obfuscator
    digits against Python's ``pow``; at 4096 bits the comb window (11)
    and its bytes.  Each step prints its wall time and device span (CUDA
    events) and the device kernel time of a profiled second run (keygen
    and the comb build: their one run, profiled, without a span)."""
    import torch
    import pailliercryptolib_python_tpu_torch as pt
    from pailliercryptolib_python_tpu_torch import kernels
    from pailliercryptolib_python_tpu_torch.fixedpoint import encode_vector
    from pailliercryptolib_python_tpu_torch.utils.config import comb_registry

    device_kernels = load_script("tools/torch_profile.py").device_kernels
    rng = np.random.default_rng(SEED + bits)
    x = rng.uniform(-1000.0, 1000.0, B)
    y = rng.uniform(-1000.0, 1000.0, B)
    w = rng.uniform(-1.0, 1.0, B)
    steps = {}

    def step(name, fn, once=False):
        """Wall time (host clock) and device span (CUDA events) of
        fn(), and the device kernel time of a profiled second run (of
        the same run when `once`: keygen is random, the comb cached);
        the launch counters keep the first run only.  The profiler has
        missed hand-written launches that the counters saw (K4's, in
        some runs): such a shortfall is printed beside the sum."""
        box = {}
        c0 = dict(kernels.COUNTS)
        if once:
            t0 = time.perf_counter()
            dk = device_kernels(lambda: box.setdefault("out", fn()))
            secs, span = time.perf_counter() - t0, None
            c1 = dict(kernels.COUNTS)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, span = timed(lambda: box.setdefault("out", fn()))
            secs = time.perf_counter() - t0
            c1 = dict(kernels.COUNTS)
            dk = device_kernels(fn)
            kernels.COUNTS.update(c1)
        dev_ms = sum(v[0] for v in dk.values())
        launched = sum(c1[k] - c0[k] for k in c1)
        seen = sum(v[1] for k, v in dk.items() if k != "eager")
        steps[name] = dict(wall_s=secs, span_ms=span, kernel_ms=dev_ms,
                           kernels=dk, launched=launched, seen=seen)
        parts = ", ".join(f"{k} {v[0]:.1f} ms / {v[1]}" for k, v in
                          sorted(dk.items(), key=lambda kv: -kv[1][0]))
        span_s = "" if span is None else f"span {span:9.2f} ms   "
        short = (f" (the profiler saw {seen} of {launched} hand-written "
                 f"launches)" if seen != launched else "")
        print(f"  {bits} {name:14s} wall {secs:9.4f} s   {span_s}kernels "
              f"{dev_ms:9.2f} ms: {parts or 'none'}{short}", flush=True)
        return box["out"]

    cfg = pt.get_config()
    saved = (cfg.keygen_device, cfg.keygen_parallel)
    if bits >= 4096:
        pt.set_config(keygen_device="1", keygen_parallel="0")
    kernels.reset_counts()
    try:
        pk, sk = step("keygen", lambda: pt.PaillierKeypair.generate_keypair(
            bits, device=dev), once=True)
    finally:
        pt.set_config(keygen_device=saved[0], keygen_parallel=saved[1])
    pub = pk.pubkey.context
    if pk.n.bit_length() != bits:
        raise AssertionError(f"keygen({bits}) made a {pk.n.bit_length()}-bit "
                             f"key")
    before = comb_registry.total_bytes
    comb = step("comb build", lambda: pub.comb_rns, once=True)
    base = pub.rns_plan()[0]
    n_win = -(-pub.randbits // pub.comb_window)
    nbytes_comb = comb.numel() * comb.element_size()
    if nbytes_comb != n_win * base.CH * (1 << pub.comb_window) * 4 or \
            comb_registry.total_bytes - before != nbytes_comb:
        raise AssertionError(f"comb of {nbytes_comb} B is not the one "
                             f"registered")
    print(f"  {bits} comb: window {pub.comb_window}, {n_win} windows x "
          f"CH={base.CH} x {1 << pub.comb_window} entries = {nbytes_comb} B "
          f"registered", flush=True)
    if bits == 4096 and (pub.comb_window, nbytes_comb) != (11, 1591648256):
        raise AssertionError(f"4096-bit key took comb window "
                             f"{pub.comb_window} ({nbytes_comb} B)")
    ct_x = step("encrypt", lambda: pk.encrypt(x))
    ct_y = pk.encrypt(y)
    got = step("decrypt", lambda: sk.decrypt(ct_x))
    ct_s = step("x + y", lambda: ct_x + ct_y)
    ct_t = step("x.sum()", lambda: ct_x.sum())
    ct_m = step("x * w", lambda: ct_x * w)
    ct_d = step("x.dot(w)", lambda: ct_x.dot(w))
    checks = (("decrypt(encrypt(x))", got, x),
              ("x + y", sk.decrypt(ct_s), x + y),
              ("x.sum()", sk.decrypt(ct_t), x.sum()),
              ("x * w", sk.decrypt(ct_m), x * w),
              ("x.dot(w)", sk.decrypt(ct_d), x @ w))
    for what, have, want in checks:
        if not np.allclose(have, want):
            raise AssertionError(f"{bits} bits: {what} differs from numpy")
    # one column under injected obfuscator digits against Python's pow;
    # r < 2^randbits, as sample_obfuscator_digits draws it (the comb holds
    # no window bits past randbits: 187 windows of 11 bits cover 2,057)
    n, nsq = pk.n, pk.n * pk.n
    dig = np.random.default_rng(bits).integers(
        0, 1 << pub.comb_window, size=(n_win, 256)).astype(np.uint16)
    dig[-1] &= (1 << (pub.randbits - pub.comb_window * (n_win - 1))) - 1
    pub.sample_obfuscator_digits = lambda b: dig[:, :b]
    try:
        ct_k = pk.encrypt(x[:1])
    finally:
        del pub.sample_obfuscator_digits
    r = sum(int(dig[j, 0]) << (pub.comb_window * j) for j in range(n_win))
    enc = encode_vector(x[:1], n, pk.max_int)[0][0]
    if ct_k.ciphertextBN(0).value() != \
            (1 + enc * n) * pow(pub.hs, r, nsq) % nsq:
        raise AssertionError(f"{bits} bits: the ciphertext differs from "
                             f"Python's pow")
    counts = dict(kernels.COUNTS)
    print(f"  {bits} bits, B={B}: every result allclose to numpy, the "
          f"injected-digit column equals Python's pow ({tag})", flush=True)
    print(f"  kernel launches over the {bits}-bit rung: {counts}",
          flush=True)
    pub.free()
    return dict(steps=steps, counts=counts, window=pub.comb_window,
                comb_bytes=nbytes_comb)


def ladder(dev, tag: str) -> dict:
    """Phase 11: the key ladder of the reference's own configurations,
    end to end through the public API (``LADDER``).  1024 bits, B=256:
    ``examples/torch_paillier_example.py`` (round trips, pickles,
    re-randomization, the 13 hybrid modes) and
    ``examples/torch_federated_example.py`` (its own world-size-1 NCCL
    group), both in this process; then 3072 bits at B=10240 and 4096 bits
    at B=256 (``ladder_rung``).  The launch counters are set to 0 before
    each rung and read after it."""
    from pailliercryptolib_python_tpu_torch import kernels
    (bits, B), rungs = LADDER[0], {}
    kernels.reset_counts()
    _, t_ex = run_example("examples/torch_paillier_example.py",
                          ["--bits", str(bits), "--batch", str(B)],
                          "all checks passed")
    _, t_fed = run_example("examples/torch_federated_example.py",
                           ["--bits", str(bits), "--per-rank", str(B)],
                           "totals verified")
    counts = dict(kernels.COUNTS)
    print(f"  {bits} examples: paillier {t_ex:.2f} s, federated "
          f"{t_fed:.2f} s ({tag})", flush=True)
    print(f"  kernel launches over the {bits}-bit rung: {counts}",
          flush=True)
    rungs[bits] = dict(counts=counts, times=dict(paillier_example_s=t_ex,
                                                 federated_example_s=t_fed))
    for bits, B in LADDER[1:]:
        rungs[bits] = ladder_rung(dev, bits, B, tag)
    return rungs


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
    tile_kernel_report()

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

    print(f"[7] third slice: 2048-bit key, B={BATCH} ({card})", flush=True)
    t0 = time.perf_counter()
    s3 = third_slice(dev, kd, card, s2["exps"])
    print(f"    phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[8] fourth slice: 2048-bit key, B={BATCH} ({card})", flush=True)
    t0 = time.perf_counter()
    s4 = fourth_slice(dev, kd, card, mp, s3["limb"])
    print(f"    phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[9] fifth slice: tools/torch_kbench.py, B={BATCH} ({card})",
          flush=True)
    t0 = time.perf_counter()
    s5 = fifth_slice(dev, card)
    print(f"    phase 9: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[10] sixth slice: the sharded layer in a world-size-1 NCCL "
          f"group, B={BATCH} ({card})", flush=True)
    t0 = time.perf_counter()
    s6 = sixth_slice(dev, kd, card)
    print(f"    phase 10: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"[11] the key ladder: " + ", ".join(
        f"{b} bits B={n}" for b, n in LADDER) + f" ({card})", flush=True)
    t0 = time.perf_counter()
    s11 = ladder(dev, card)
    print(f"    phase 11: {time.perf_counter() - t0:.1f} s", flush=True)

    missing = ([k for k in FIRST_SLICE if mp["counts"][k] <= 0]
               + [k for k in SECOND_SLICE if s2["counts"][k] <= 0]
               + [k for k in THIRD_SLICE if s3["counts"][k] <= 0]
               + [k for k in FOURTH_SLICE if s4["counts"][k] <= 0]
               + [k for k in FIFTH_SLICE if s5["counts"][k] <= 0]
               + [k for k in SIXTH_SLICE if s6["counts"][k] <= 0]
               + [f"{k} ({b} bits)" for b, r in s11.items()
                  for k in LADDER_SLICE + (LADDER_KEYGEN if b >= 4096
                                           else ())
                  if r["counts"][k] <= 0])
    if missing:
        raise AssertionError(f"a phase never launched {missing}")
    phases = (mp, s2, s3, s4, s5, s6, *s11.values())
    launches = {k: sum(s["counts"][k] for s in phases) for k in KERNELS}
    print(f"[5] every kernel launched: phase 4 {mp['counts']}, phase 6 "
          f"{s2['counts']}, phase 7 {s3['counts']}, phase 8 {s4['counts']}, "
          f"phase 9 {s5['counts']}, phase 10 {s6['counts']}, phase 11 "
          + ", ".join(f"{b} bits {r['counts']}" for b, r in s11.items()),
          flush=True)
    print(f"    phases 3-11: {time.perf_counter() - t_all:.1f} s; library "
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
