"""Two gloo processes on the CPU (``torch.multiprocessing.spawn``): the
port's sharded HE sum crosses the process boundary, and the one-step
federated dry run runs over a (2, 1) mesh, the counterpart of
``tests/test_distributed_2proc.py`` for the JAX package.

Each rank joins the group through ``parallel.distributed.initialize``
(file init in the test's temporary directory), encrypts its own 64
values of the batch 1..128 at the fixed 256-bit key, and all-reduces
the ciphertexts; rank 0 decrypts the total and holds it against numpy's
sum.  Every rank writes what it saw to a file the test reads."""

import json
import os

import numpy as np
import torch.multiprocessing as mp

B_LOC = 64


def _rank(rank: int, world: int, tmp: str) -> None:
    import torch
    from pailliercryptolib_python_tpu_torch.models import paillier as sch
    from pailliercryptolib_python_tpu_torch.parallel import (
        collective, distributed, entry, mesh)
    from pailliercryptolib_python_tpu_torch.utils.fixtures import \
        fixed_key_ints

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    assert distributed.initialize(init_method=f"file://{tmp}/store",
                                  num_processes=world, process_id=rank,
                                  device=cpu)
    try:
        assert distributed.process_info() == (rank, world)
        m = mesh.make_mesh(world, 1, "cpu")
        kd = fixed_key_ints(256)
        pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                                kd["randbits"], device=cpu)
        priv = sch.PrivateContext(pub, kd["p"], kd["q"])
        lo, hi = mesh.batch_bounds(m, world * B_LOC, rank)
        ct = pub.encrypt([v + 1 for v in range(lo, hi)], pad_to=hi - lo)
        with collective.count_collectives() as calls:
            total = collective.sharded_he_sum(ct, pub.ctx, m)
        out = {"rank": rank, "columns": [lo, hi], "calls": dict(calls),
               "total_limbs": total.reshape(-1).tolist()}
        if rank == 0:
            out["decrypted"] = priv.decrypt_to_ints(total, 1)[0]
        out["dryrun"] = entry.dryrun_multichip(world, device=cpu)["total"]
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        distributed.shutdown()


def test_two_process_he_sum_and_dryrun(tmp_path):
    mp.spawn(_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert [r["columns"] for r in res] == [[0, B_LOC], [B_LOC, 2 * B_LOC]]
    assert all(r["calls"] == {"all_gather": 1} for r in res)
    # the total is replicated: both ranks fold the same partials
    assert res[0]["total_limbs"] == res[1]["total_limbs"]
    assert res[0]["decrypted"] == int(np.arange(1, 2 * B_LOC + 1).sum())
    assert res[0]["dryrun"] == res[1]["dryrun"]
