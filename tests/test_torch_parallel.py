"""The port's sharded layer (``pailliercryptolib_python_tpu_torch/
parallel``) against the JAX package's (``pailliercryptolib_python_tpu/
parallel``) on the CPU, at the fixed 256-bit key.

* Layout: ``batch_bounds`` gives each rank the columns the JAX batch
  sharding gives the mesh position of the same index, on the 8 CPU
  devices of ``tests/conftest.py`` ((1, 1), (2, 4), (1, 8) meshes).
* HE sum: the local fold (``ops.reduction.tree_fold``) and the fold of
  the partials over 8 blocks in one process equal JAX ``sharded_he_sum``
  on ``make_mesh(2, 4)`` limb for limb; the fold's padding of segments
  narrower than a power of two.
* In a world-size-1 gloo group: ``sharded_he_sum`` (one all-gather),
  ``sharded_elementwise`` add, ``federated_aggregate``,
  ``sharded_decrypt`` and ``sharded_mul_pt`` (no collective inside
  their chains, ``count_collectives``) against the unsharded port and
  the JAX package (the JAX CRT decrypt compiles for ~50 s a batch width
  on the CPU, so its plaintext, Python's integers, stands in for it);
  the mesh, ``shard_batch``, ``replicate``, ``entry`` and
  ``dryrun_multichip(1)``; the backend / device pairing.
* Configuration: the PAILLIER_* launch contract and PAILLIER_MESH_SHAPE.

The two-process run is ``tests/test_torch_distributed_2proc.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pailliercryptolib_python_tpu.models import paillier as jsch
from pailliercryptolib_python_tpu.parallel import collective as jcoll
from pailliercryptolib_python_tpu.parallel import mesh as jmesh
from pailliercryptolib_python_tpu.utils import config as jcfg
from pailliercryptolib_python_tpu.utils.fixtures import fixed_key_ints
from pailliercryptolib_python_tpu_torch.models import paillier as tsch
from pailliercryptolib_python_tpu_torch.ops import montgomery as tmg
from pailliercryptolib_python_tpu_torch.ops.limb import limbs_to_ints
from pailliercryptolib_python_tpu_torch.ops.reduction import tree_fold
from pailliercryptolib_python_tpu_torch.parallel import collective as coll
from pailliercryptolib_python_tpu_torch.parallel import distributed as pdist
from pailliercryptolib_python_tpu_torch.parallel import entry as pentry
from pailliercryptolib_python_tpu_torch.parallel import mesh as pmesh
from pailliercryptolib_python_tpu_torch.parallel import sharded_ops as so
from pailliercryptolib_python_tpu_torch.utils import config as tcfg

CPU = torch.device("cpu")
KD = fixed_key_ints(256)
N = KD["n"]
B = 64


@pytest.fixture(scope="module")
def keys():
    """(JAX pub, port pub, port priv, xs, ct): B values encrypted by the
    JAX package (obfuscated), the same ciphertexts as a port tensor."""
    prev = jcfg.get_config().encrypt_engine
    jcfg.set_config(encrypt_engine="rns")
    try:
        jpub = jsch.PublicContext(N, KD["bits"], True, KD["hs"],
                                  KD["randbits"])
        xs = [int(v) for v in np.random.default_rng(5).integers(
            0, 10**6, size=B)]
        jct = np.asarray(jpub.encrypt(xs))
    finally:
        jcfg.set_config(encrypt_engine=prev)
    tpub = tsch.PublicContext(N, KD["bits"], True, KD["hs"], KD["randbits"],
                              device=CPU)
    tpriv = tsch.PrivateContext(tpub, KD["p"], KD["q"])
    return jpub, tpub, tpriv, xs, torch.from_numpy(jct.astype(np.int32))


def _jax_he_sum(keys, H, C):
    """JAX ``sharded_he_sum`` of the batch on an (H, C) mesh."""
    jpub, _, _, _, ct = keys
    mesh = jmesh.make_mesh(H, C, devices=jax.devices()[:H * C])
    total = jcoll.sharded_he_sum(
        jmesh.shard_batch(jnp.asarray(ct.numpy().astype(np.uint32)), mesh),
        jpub.ctx, mesh)
    return np.asarray(total).astype(np.int64)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A world-size-1 gloo process group (file init)."""
    path = tmp_path_factory.mktemp("pg") / "store"
    assert pdist.initialize(init_method=f"file://{path}", num_processes=1,
                            process_id=0, device="cpu")
    yield pmesh.make_mesh(device_type="cpu")
    pdist.shutdown()
    assert not dist.is_initialized()


def _same(port, ref):
    p = np.asarray(port.numpy() if isinstance(port, torch.Tensor)
                   else port).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    assert p.shape == r.shape and np.array_equal(p, r)


# ---------------------------------------------------------------------------
# Layout and the HE sum's folds, no process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (1, 8)])
def test_batch_bounds_match_jax_sharding(shape):
    H, C = shape
    jm = jmesh.make_mesh(H, C, devices=jax.devices()[:H * C])
    idx = jmesh.batch_sharding(jm).devices_indices_map((3, B))
    for h in range(H):
        for c in range(C):
            cols = idx[jm.devices[h, c]][1]
            want = (cols.start or 0, B if cols.stop is None else cols.stop)
            assert pmesh.batch_bounds(shape, B, h * C + c) == want
    with pytest.raises(ValueError, match="does not split"):
        pmesh.batch_bounds(shape, B + 1, 0) if H * C > 1 else \
            pmesh.batch_bounds((3, 1), B, 0)


def test_he_sum_folds_over_8_blocks_equal_jax(keys):
    """8 blocks of 8 columns, each folded alone (``tree_fold``, the one
    fold of the package), the partials folded in block order: the
    reference's program on its (2, 4) mesh.  One fold over 8 segments
    gives the same partials."""
    _, tpub, _, _, ct = keys
    parts = [tree_fold(ct[:, lo:lo + 8], tpub.ctx) for lo in range(0, B, 8)]
    _same(tree_fold(ct, tpub.ctx, 8), torch.cat(parts, dim=1))
    total = coll.fold_partials(parts, tpub.ctx)
    assert total.shape == (tpub.L, 1)
    _same(total, _jax_he_sum(keys, 2, 4))


def test_local_tree_reduce_pads_with_one(keys):
    """A block whose width is not a power of two is padded with the
    Montgomery one (an encryption of zero)."""
    _, tpub, tpriv, xs, ct = keys
    total = tree_fold(ct[:, :5], tpub.ctx)
    _same(coll.local_tree_reduce(ct[:, :5], tpub.ctx), total)
    assert tpriv.decrypt_to_ints(total, 1) == [sum(xs[:5]) % N]


@pytest.mark.parametrize("groups,seg", [(3, 5), (4, 8), (1, 6)],
                         ids=["3x5", "4x8-of-64", "1x6-of-64"])
def test_tree_fold_pads_each_segment(keys, groups, seg):
    """Segments narrower than a power of two, or fewer columns than the
    batch: each segment's HE sum, as ``segment_tree_reduce`` returns them
    ahead of its padding columns."""
    _, tpub, tpriv, xs, ct = keys
    sums = tree_fold(ct, tpub.ctx, groups, seg)
    assert sums.shape == (tpub.L, groups)
    _same(tpub.segment_tree_reduce(ct, groups, seg)[:, :groups], sums)
    assert tpriv.decrypt_to_ints(sums, groups) == [
        sum(xs[g * seg:(g + 1) * seg]) % N for g in range(groups)]


# ---------------------------------------------------------------------------
# A world-size-1 gloo group
# ---------------------------------------------------------------------------

def test_mesh_shard_and_replicate(group, keys):
    _, tpub, _, _, ct = keys
    assert pmesh.mesh_shape(group) == (1, 1)
    assert group.mesh_dim_names == (pmesh.DCN_AXIS, pmesh.ICI_AXIS)
    assert pmesh.mesh_ranks(group) == [0]
    assert pdist.process_info() == (0, 1)
    assert pdist.initialize() is True                  # idempotent
    _same(pmesh.shard_batch(ct, group), ct)
    rep = pmesh.replicate(tpub.ctx, group)
    assert isinstance(rep, tmg.MontCtx)
    for f in dataclasses.fields(rep):
        a, b = getattr(rep, f.name), getattr(tpub.ctx, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        else:
            assert a == b
    with pytest.raises(ValueError, match="does not cover"):
        pmesh.make_mesh(2, 1, "cpu")


def test_sharded_he_sum_one_all_gather(group, keys):
    """One rank folds the whole batch: the tree of ``tree_reduce`` and
    of the JAX program on a (1, 1) mesh (another tree, such as the (2, 4)
    mesh's, gives the same sum mod n^2, but its representative below
    2n^2 may differ)."""
    _, tpub, tpriv, xs, ct = keys
    with coll.count_collectives() as calls:
        total = coll.sharded_he_sum(ct, tpub.ctx, group)
    assert dict(calls) == {"all_gather": 1}
    _same(total, tpub.tree_reduce(ct, B)[:, :1])
    _same(total, _jax_he_sum(keys, 1, 1))
    assert tpriv.decrypt_to_ints(total, 1) == [sum(xs) % N]


def test_sharded_elementwise_and_federated_aggregate(group, keys):
    jpub, tpub, tpriv, xs, ct = keys
    parties = [ct, ct.flip(1).contiguous(), ct.roll(1, 1).contiguous()]
    add = coll.sharded_elementwise(tpub.add_ct, group)
    with coll.count_collectives() as calls:
        two = add(parties[0], parties[1])
        agg = coll.federated_aggregate(parties, tpub.ctx, group)
    assert not calls
    _same(two, tpub.add_ct(parties[0], parties[1]))
    _same(agg, tpub.add_ct(two, parties[2]))
    jp = [jnp.asarray(p.numpy().astype(np.uint32)) for p in parties]
    _same(two, jpub.add_ct(jp[0], jp[1]))
    _same(agg, jcoll.federated_aggregate(jp, jpub.ctx))
    rev, rot = xs[::-1], xs[-1:] + xs[:-1]
    assert tpriv.decrypt_to_ints(agg, B) == [
        (a + b + c) % N for a, b, c in zip(xs, rev, rot)]


def test_sharded_decrypt_runs_no_collective(group, keys):
    _, tpub, tpriv, xs, ct = keys
    with coll.count_collectives() as calls:
        plain = so.sharded_decrypt(tpriv, ct, group)
    assert not calls
    _same(plain, tpriv.decrypt_device(ct))
    assert limbs_to_ints(plain) == xs


def test_sharded_mul_pt_runs_no_collective(group, keys):
    """The full window count on every rank: equal to ``mul_pt`` under
    ``fixed_shape_ops`` in both packages, limb for limb, at 8 columns."""
    jpub, tpub, tpriv, xs, ct = keys
    ct8 = ct[:, :8].contiguous()
    exps = [int(e) for e in np.random.default_rng(6).integers(
        1, 2**31, size=8)]
    with coll.count_collectives() as calls:
        out = so.sharded_mul_pt(tpub, ct8, exps, group)
    assert not calls
    tprev, jprev = (tcfg.get_config().fixed_shape_ops,
                    jcfg.get_config().fixed_shape_ops)
    tcfg.set_config(fixed_shape_ops=True)
    jcfg.set_config(fixed_shape_ops=True)
    try:
        _same(out, tpub.mul_pt(ct8, exps))
        _same(out, jpub.mul_pt(jnp.asarray(ct8.numpy().astype(np.uint32)),
                               exps))
    finally:
        tcfg.set_config(fixed_shape_ops=tprev)
        jcfg.set_config(fixed_shape_ops=jprev)
    assert tpriv.decrypt_to_ints(out, 8) == [
        x * e % N for x, e in zip(xs[:8], exps)]


def test_entry_and_dryrun(group):
    """``entry`` at the 256-bit key on the CPU: its step's ciphertexts
    decrypt to its messages; ``dryrun_multichip(1)`` in this group."""
    fn, args = pentry.entry(bits=256, B=8, device=CPU)
    ct = fn(*args)
    priv = tsch.PrivateContext(tsch.PublicContext(
        N, KD["bits"], True, KD["hs"], KD["randbits"], device=CPU),
        KD["p"], KD["q"])
    msgs = [int(v) for v in np.random.default_rng(0).integers(
        0, 2**60, size=8)]
    assert priv.decrypt_to_ints(ct, 8) == msgs
    res = pentry.dryrun_multichip(1, device=CPU)
    assert res["mesh"] == (1, 1) and res["columns"] == (0, 16)
    with pytest.raises(RuntimeError, match="group of 2 ranks"):
        pentry.dryrun_multichip(2, device=CPU)


class _OnDevice(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card needed)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_backend_must_serve_the_device(group, keys):
    """A CUDA tensor needs an NCCL group: with the gloo group every
    sharded op raises before any work, and nothing falls back."""
    _, tpub, tpriv, _, ct = keys
    fake = ct.as_subclass(_OnDevice)
    for run in (lambda: coll.sharded_he_sum(fake, tpub.ctx, group),
                lambda: so.sharded_decrypt(tpriv, fake, group),
                lambda: so.sharded_mul_pt(tpub, fake, [1], group),
                lambda: coll.federated_aggregate([fake, fake], tpub.ctx,
                                                 group),
                lambda: coll.sharded_elementwise(tpub.add_ct, group)(
                    fake, fake)):
        with pytest.raises(ValueError, match="needs a nccl process group"):
            run()


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

def test_env_contract_and_no_group(monkeypatch):
    for k in ("PAILLIER_COORDINATOR", "PAILLIER_NUM_PROCESSES",
              "PAILLIER_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.launch_info_from_env() is None
    if not dist.is_initialized():
        assert pdist.initialize() is False           # one process: no-op
        assert pdist.process_info() == (0, 1)
        with pytest.raises(RuntimeError, match="initialized process group"):
            pdist.require_group(torch.zeros(1))
    monkeypatch.setenv("PAILLIER_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("PAILLIER_NUM_PROCESSES", "4")
    monkeypatch.setenv("PAILLIER_PROCESS_ID", "2")
    assert pdist.launch_info_from_env() == {
        "coordinator_address": "10.0.0.1:8476", "num_processes": 4,
        "process_id": 2}
    monkeypatch.setenv("PAILLIER_NUM_PROCESSES", "1")
    assert pdist.launch_info_from_env() is None
    assert pdist.backend_for("cpu") == "gloo"
    assert pdist.backend_for("cuda") == "nccl"


def test_mesh_shape_knobs(monkeypatch):
    monkeypatch.setenv("PAILLIER_MESH_SHAPE", "2,4")
    cfg = tcfg.Config()
    assert (cfg.mesh_hosts, cfg.mesh_chips) == (2, 4)
    assert (cfg.mesh_hosts, cfg.mesh_chips) == (
        jcfg.Config().mesh_hosts, jcfg.Config().mesh_chips)
    monkeypatch.delenv("PAILLIER_MESH_SHAPE")
    assert tcfg.Config().mesh_hosts is None
    prev = (tcfg.get_config().mesh_hosts, tcfg.get_config().mesh_chips)
    tcfg.set_config(mesh_hosts=3, mesh_chips=1)
    try:
        with pytest.raises(RuntimeError if not dist.is_initialized()
                           else ValueError):
            pmesh.make_mesh(device_type="cpu")
    finally:
        tcfg.set_config(mesh_hosts=prev[0], mesh_chips=prev[1])
