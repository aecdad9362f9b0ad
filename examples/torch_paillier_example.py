#!/usr/bin/env python3
"""End-to-end example of the PyTorch/CUDA port, through the
``ipcl_python_torch`` alias.

Counterpart of ``examples/paillier_example.py``: encrypt / decrypt round
trips, every HE op (ct + ct, ct + pt, ct * pt, matmul, reductions),
broadcasting, pickle round trips of keys and ciphertexts,
re-randomization, and an encrypt / decrypt / multiply timing sweep over
all 13 hybrid modes after ``context.initializeContext`` (a mode sets how
finely ``encrypt`` pipelines a batch and what share of it a host thread
encrypts with Python integers).

Run:
    python examples/torch_paillier_example.py [--bits 1024] [--batch 256]
        [--device cuda]

The default device is ``cuda``; ``--device cpu`` runs every kernel's plain
PyTorch twin (keep ``--bits`` at 256 and ``--batch`` small there).
``main(argv)`` restores the default device and the hybrid-mode knobs it
changed, so another program can call it in its own process.
"""

import argparse
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def check(name, ok):
    print(f"  {name:<42s} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"example failed at: {name}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from ipcl_python_torch import (PaillierKeypair, __version__, context,
                                   hybridControl, hybridMode)
    from pailliercryptolib_python_tpu_torch import (get_config, get_device,
                                                    set_config, set_device)

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    def ms(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    prev_device = get_device()
    cfg = get_config()
    prev_knobs = dict(encrypt_pipeline_chunks=cfg.encrypt_pipeline_chunks,
                      encrypt_host_ratio=cfg.encrypt_host_ratio)
    set_device(args.device)
    try:
        context.initializeContext("QAT")
        print(f"ipcl_python_torch {__version__} on {args.device}; "
              f"accelerator active: {context.isQATActive()}")

        t0 = time.perf_counter()
        pk, sk = PaillierKeypair.generate_keypair(args.bits)
        print(f"keygen({args.bits}): {time.perf_counter() - t0:.2f}s")

        rng = np.random.default_rng(0)
        B = args.batch
        x = rng.random(B) * 100
        y = rng.random(B) * 10

        print("HE operation round trips:")
        ct_x, ct_y = pk.encrypt(x), pk.encrypt(y)
        check("encrypt/decrypt", np.allclose(sk.decrypt(ct_x), x))
        check("ct + ct", np.allclose(sk.decrypt(ct_x + ct_y), x + y))
        check("ct + pt", np.allclose(sk.decrypt(ct_x + y), x + y))
        check("ct + scalar (broadcast)",
              np.allclose(sk.decrypt(ct_x + 3.5), x + 3.5))
        check("ct * pt", np.allclose(sk.decrypt(ct_x * y), x * y))
        check("ct * negative pt", np.allclose(sk.decrypt(ct_x * -y), -x * y))
        check("ct / scalar", np.allclose(sk.decrypt(ct_x / 4.0), x / 4.0))
        check("sum", np.isclose(sk.decrypt(ct_x.sum()), x.sum()))
        check("mean", np.isclose(sk.decrypt(ct_x.mean()), x.mean()))
        check("dot", np.isclose(sk.decrypt(ct_x.dot(y)), x.dot(y)))

        a = rng.random((4, 5))
        b = rng.random((5, 3))
        ct_a = pk.encrypt(a.flatten())
        check("ct @ pt", np.allclose(
            np.array(sk.decrypt(ct_a @ b)).reshape(4, 3), a @ b))
        ct_b = pk.encrypt(b.flatten())
        check("pt @ ct", np.allclose(
            np.array(sk.decrypt(a @ ct_b)).reshape(4, 3), a @ b))

        print("serialization round trips:")
        pk2 = pickle.loads(pickle.dumps(pk))
        sk2 = pickle.loads(pickle.dumps(sk))
        ct2 = pickle.loads(pickle.dumps(ct_x))
        check("pickled pk encrypts",
              np.allclose(sk.decrypt(pk2.encrypt(x)), x))
        check("pickled sk decrypts", np.allclose(sk2.decrypt(ct_x), x))
        check("pickled ct decrypts", np.allclose(sk.decrypt(ct2), x))

        print("re-randomization:")
        before = ct_x.ciphertextBN(0).value()
        ct_x.apply_obfuscator()
        check("ciphertext changed", ct_x.ciphertextBN(0).value() != before)
        check("value preserved", np.allclose(sk.decrypt(ct_x), x))

        print("hybrid-mode sweep (encrypt / decrypt / multiply ms):")
        for mode in hybridMode:
            hybridControl.setHybridMode(mode)
            box = {}
            t_enc = ms(lambda: box.setdefault("ct", pk.encrypt(x)))
            t_dec = ms(lambda: box.setdefault("pt", sk.decrypt(box["ct"])))
            t_mul = ms(lambda: box["ct"] * y)
            check(f"{mode.name} round trip", np.allclose(box["pt"], x))
            print(f"  {mode.name:<12s} {t_enc:8.1f} {t_dec:8.1f} "
                  f"{t_mul:8.1f}", flush=True)
        hybridControl.setHybridOff()
        context.terminateContext()
        print("all checks passed", flush=True)
    finally:
        context.terminateContext()
        set_config(**prev_knobs)
        set_device(prev_device)


if __name__ == "__main__":
    main()
