#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, step by step, on one GPU.

    python3 tools/torch_profile.py

Runs the API steps of ``chip_smoke.py`` phases 4 and 6 at a 2048-bit key
(``fixed_key_ints(2048)``) and B=4096.  Each step runs once to warm up,
once under the host clock (ending in ``torch.cuda.synchronize()``: the
wall time), and once under ``torch.profiler``.  From the profiled run it
prints the device kernel time, the share of it in each hand-written
kernel (K1..K7) and in the eager aten/cuBLAS kernels, with launch
counts, and the busy share: device kernel time over the unprofiled wall
time.  Needs one CUDA card; imports nothing of JAX.  The last line is a
JSON object of the same numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4096
SEED = 20261016
KERNEL_NAMES = (("rns_exp_elem_kernel", "K5"), ("rns_exp_sched_kernel", "K2"),
                ("rns_mul_kernel", "K1"), ("mm3_exp_shared_kernel", "K7"),
                ("mm3_exp_kernel", "K4"), ("mm3_mul_kernel", "K3"))


def label(kernel_name: str) -> str:
    for sub, tag in KERNEL_NAMES:
        if sub in kernel_name:
            return tag
    return "eager"


def wall(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_kernels(fn) -> dict:
    """{label: [ms, launches]} of the device kernels fn runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        slot = out.setdefault(label(e.name), [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import pailliercryptolib_python_tpu_torch as pt
    from pailliercryptolib_python_tpu_torch.models import paillier as sch
    from pailliercryptolib_python_tpu_torch.utils.fixtures import \
        fixed_key_ints

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kd = fixed_key_ints(2048)
    rng = np.random.default_rng(SEED + 3)
    x = rng.uniform(-1000.0, 1000.0, BATCH)
    y = rng.uniform(-1000.0, 1000.0, BATCH)
    w = rng.uniform(-1.0, 1.0, BATCH)
    v = rng.uniform(-1000.0, 1000.0, 64)
    W = rng.uniform(-1.0, 1.0, (64, 64))

    def keys():
        ipub = pt.ipclPublicKey(kd["n"], kd["bits"], True, kd["hs"],
                                kd["randbits"], device=dev)
        pk = pt.PaillierPublicKey(ipub)
        return pk, pt.PaillierPrivateKey(pk, kd["p"], kd["q"])

    pk, sk = keys()
    pt.set_config(decrypt_engine="limb")
    sk_limb = pt.PaillierPrivateKey(pk, kd["p"], kd["q"])
    pt.set_config(decrypt_engine="auto")
    ct_x, ct_y, ct_v = pk.encrypt(x), pk.encrypt(y), pk.encrypt(v)
    steps = {
        "comb build": lambda: sch.PublicContext(
            kd["n"], kd["bits"], True, kd["hs"], kd["randbits"],
            device=dev).comb_rns,
        "encrypt 4096": lambda: pk.encrypt(x),
        "x + y": lambda: ct_x + ct_y,
        "x.sum()": lambda: ct_x.sum(),
        "decrypt 4096 (K2)": lambda: sk.decrypt(ct_x),
        "decrypt 4096 (K7)": lambda: sk_limb.decrypt(ct_x),
        "x * w": lambda: ct_x * w,
        "x.dot(w)": lambda: ct_x.dot(w),
        "x - y": lambda: ct_x - ct_y,
        "v @ W": lambda: ct_v @ W,
        "apply_obfuscator": lambda: ct_y.apply_obfuscator(),
    }
    print(f"card: {card} | torch {torch.__version__}", flush=True)
    rows = {}
    for name, fn in steps.items():
        fn()
        t = wall(fn)
        ker = device_kernels(fn)
        busy = sum(ms for ms, _ in ker.values())
        rows[name] = dict(wall_s=t, device_ms=busy,
                          busy_share=busy / (1e3 * t), kernels=ker)
        top = sorted(ker.items(), key=lambda kv: -kv[1][0])[:3]
        print(f"  {name:20s} wall {t:8.4f} s  device {busy:9.1f} ms  busy "
              f"{busy / (1e3 * t):5.2f}  " + "  ".join(
                  f"{k}: {ms:.1f} ms / {n}" for k, (ms, n) in top),
              flush=True)
    print(card)
    print(json.dumps({"card": card, "steps": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
