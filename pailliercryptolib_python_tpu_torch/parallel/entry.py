"""Driver entry points of the port: the batched encrypt step and a
one-step federated dry run over a process group.

Counterpart of the repository's ``__graft_entry__.py`` (``entry``,
``dryrun_multichip``), which drives the JAX package.

* ``entry()`` -- (fn, example_args): one batched 2048-bit DJN encryption
  step (1 + m*n into the Montgomery domain, then the fixed-base comb
  obfuscator hs^r, no squarings) on the port's default device.
* ``dryrun_multichip(n)`` -- in an initialized group of n ranks: a
  ("dcn_host", "ici_chip") mesh, each rank encrypting its block of two
  parties' updates, the cross-party combine, the encrypted all-reduce,
  ct*pt and the CRT decrypt on the rank's columns, every result checked
  against Python's integers.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..device import resolve
from ..models import paillier as sch
from ..ops.limb import limbs_to_ints
from ..utils.fixtures import fixed_key_ints
from .collective import count_collectives, federated_aggregate, \
    sharded_he_sum
from .distributed import process_info
from .mesh import batch_bounds, make_mesh, mesh_shape
from .sharded_ops import sharded_decrypt, sharded_mul_pt


def entry(bits: int = 2048, B: int = 256, device=None):
    """(fn, example_args) for the batched DJN encrypt step:
    ``fn(m_limbs, digits, comb_table, n_limbs, ctx)`` returns the (L, B)
    Montgomery ciphertexts of B seeded 60-bit messages under the fixed
    `bits`-bit key (2048 or 256), with fresh obfuscator digits, through
    the limb comb (kernel K3 per window on CUDA)."""
    kd = fixed_key_ints(bits, enable_DJN=True)
    pub = sch.PublicContext(kd["n"], kd["bits"], True, kd["hs"],
                            kd["randbits"], device=device)
    rng = np.random.default_rng(0)
    msgs = [int(v) for v in rng.integers(0, 2**60, size=B)]
    m_limbs = pub.encodings_to_device(msgs)
    digits = pub.sample_obfuscator_digits(B)

    def encrypt_step(m_limbs, digits, comb_table, n_limbs, ctx):
        return sch._encrypt_djn(m_limbs, digits, comb_table, n_limbs, ctx,
                                ctx.num_limbs)

    return encrypt_step, (m_limbs, digits, pub.comb_table, pub.n_limbs,
                          pub.ctx)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One federated step in the initialized process group of world size
    `n_devices` on `device` (the port's default when None): a (2, n/2)
    mesh for an even n > 2, else (1, n); the fixed 256-bit key; a batch
    of 16 columns a rank.  Each rank encrypts its block of two parties'
    updates, combines them (``federated_aggregate``), all-reduces the
    batch (``sharded_he_sum``), scales it (``sharded_mul_pt``) and
    decrypts (``sharded_decrypt``, counted: no collective may run in
    it); raises on any mismatch with Python's integers.  Returns a
    summary dict."""
    rank, world = process_info()
    if not dist.is_initialized() or world != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs an "
                           f"initialized group of {n_devices} ranks "
                           f"(has {world})")
    dev = resolve(device)
    rows = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    mesh = make_mesh(rows, n_devices // rows, dev.type)
    kd = fixed_key_ints(256, enable_DJN=True)
    n = kd["n"]
    pub = sch.PublicContext(n, kd["bits"], True, kd["hs"], kd["randbits"],
                            device=dev)
    priv = sch.PrivateContext(pub, kd["p"], kd["q"])
    B = n_devices * 16
    rng = np.random.default_rng(1)
    parties = [[int(v) for v in rng.integers(0, 1000, size=B)]
               for _ in range(2)]
    scales = [int(v) for v in rng.integers(1, 100, size=B)]
    lo, hi = batch_bounds(mesh, B, rank)
    cts = [pub.encrypt(pv[lo:hi], pad_to=hi - lo) for pv in parties]
    agg = federated_aggregate(cts, pub.ctx, mesh)
    total = sharded_he_sum(agg, pub.ctx, mesh)
    scaled = sharded_mul_pt(pub, agg, scales[lo:hi], mesh)
    with count_collectives() as calls:
        plain = sharded_decrypt(priv, scaled, mesh)
    if calls:
        raise AssertionError(f"collectives ran inside the sharded "
                             f"decrypt: {dict(calls)}")
    want = [(a + b) % n for a, b in zip(*parties)]
    if priv.decrypt_to_ints(agg, hi - lo) != want[lo:hi]:
        raise AssertionError("sharded aggregation mismatch")
    if limbs_to_ints(plain) != [w * s % n for w, s in
                                zip(want[lo:hi], scales[lo:hi])]:
        raise AssertionError("sharded mul_pt + decrypt mismatch")
    got_total = priv.decrypt_to_ints(total, 1)[0]
    if got_total != sum(want) % n:
        raise AssertionError(f"sharded HE all-reduce mismatch: {got_total}"
                             f" != {sum(want) % n}")
    return {"mesh": mesh_shape(mesh), "rank": rank, "B": B,
            "columns": (lo, hi), "total": got_total}
