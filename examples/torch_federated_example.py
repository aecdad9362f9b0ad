#!/usr/bin/env python3
"""Federated encrypted aggregation on the PyTorch/CUDA port's sharded
layer (``parallel/`` over ``torch.distributed``).

Counterpart of ``examples/federated_example.py``: K parties encrypt their
local update vectors under a shared public key; the aggregator sums the
ciphertexts elementwise (HE add = modular product mod n^2) and reduces
them to one encrypted total, the batch split over the ranks of a
("dcn_host", "ici_chip") mesh.  Only the key holder (rank 0) decrypts,
and checks both results against Python integers.

Run in one process (a world-size-1 group of its own):
    python examples/torch_federated_example.py [--device cuda] [--bits 256]
Under torchrun, one rank per card:
    torchrun --nproc-per-node 4 examples/torch_federated_example.py
The backend follows the device: NCCL for ``cuda``, gloo for
``--device cpu``.  The PAILLIER_COORDINATOR / PAILLIER_NUM_PROCESSES /
PAILLIER_PROCESS_ID contract works too (``parallel.distributed``).  A
group the caller already made is used as it is and left open.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bits", type=int, default=256)
    ap.add_argument("--per-rank", type=int, default=32,
                    help="values each rank owns")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from pailliercryptolib_python_tpu_torch.models import paillier as sch
    from pailliercryptolib_python_tpu_torch.parallel import distributed, mesh
    from pailliercryptolib_python_tpu_torch.parallel.collective import (
        federated_aggregate, sharded_he_sum)

    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        # under torchrun one rank a card, else the current card
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tmp = None
    owned = not dist.is_initialized()
    if owned:
        if "WORLD_SIZE" in os.environ:                      # torchrun
            distributed.initialize(
                init_method="env://",
                num_processes=int(os.environ["WORLD_SIZE"]),
                process_id=int(os.environ["RANK"]), device=dev)
        elif not distributed.initialize(device=dev):        # one process
            tmp = tempfile.TemporaryDirectory()
            distributed.initialize(init_method=f"file://{tmp.name}/store",
                                   num_processes=1, process_id=0,
                                   device=dev)
    try:
        rank, world = distributed.process_info()
        m = mesh.make_mesh(device_type=dev.type)
        if rank == 0:
            print(f"ranks: {world} ({dist.get_backend()}); mesh: "
                  f"{dict(zip(m.mesh_dim_names, m.shape))}", flush=True)

        # the key holder generates the keypair and shares the public key
        kd = sch.generate_key_ints(args.bits, enable_DJN=True, device=dev) \
            if rank == 0 else None
        shared = [None if kd is None else
                  {k: kd[k] for k in ("n", "bits", "hs", "randbits")}]
        dist.broadcast_object_list(shared, src=0)
        pk = shared[0]
        pub = sch.PublicContext(pk["n"], pk["bits"], True, pk["hs"],
                                pk["randbits"], device=dev)

        # K parties hold local gradient-like updates; every rank sees the
        # same values (one seed) and encrypts only the columns it owns
        K, B = 3, world * args.per_rank
        rng = np.random.default_rng(0)
        parties = [[int(v) for v in rng.integers(0, 10**6, size=B)]
                   for _ in range(K)]
        lo, hi = mesh.batch_bounds(m, B, rank)
        cts = [pub.encrypt(p[lo:hi])[:, :hi - lo].contiguous()
               for p in parties]

        # elementwise encrypted aggregation (no communication), then the
        # encrypted all-reduce to one total (one all-gather)
        agg = federated_aggregate(cts, pub.ctx, m)
        total_ct = sharded_he_sum(agg, pub.ctx, m)

        # the key holder gathers the aggregated blocks and opens them
        blocks = [torch.empty_like(agg) for _ in range(world)]
        dist.all_gather(blocks, agg.contiguous())
        out = {"rank": rank, "world": world, "values": B}
        if rank == 0:
            priv = sch.PrivateContext(pub, kd["p"], kd["q"])
            ranks = mesh.mesh_ranks(m)
            elem = priv.decrypt_to_ints(
                torch.cat([blocks[r] for r in ranks], dim=1), B)
            total = priv.decrypt_to_ints(total_ct, 1)[0]
            expect_elem = [sum(col) % pk["n"] for col in zip(*parties)]
            expect_total = sum(expect_elem) % pk["n"]
            if elem != expect_elem:
                raise AssertionError("elementwise aggregation mismatch")
            if total != expect_total:
                raise AssertionError("encrypted all-reduce mismatch")
            out.update(elem=elem, total=total)
            print(f"aggregated {B} values from {K} parties across {world} "
                  f"ranks on {dev.type}; totals verified", flush=True)
        return out
    finally:
        if owned:
            distributed.shutdown()
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    main()
