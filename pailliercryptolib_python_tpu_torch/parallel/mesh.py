"""Device mesh and batch layout for sharded HE work on ``torch.distributed``.

Counterpart of ``pailliercryptolib_python_tpu/parallel/mesh.py``.
Ciphertexts are (L, B) limb tensors: L (limbs) replicated, B (batch)
split over a ("dcn_host", "ici_chip") mesh of the process group's ranks,
in the order of the reference's ``PartitionSpec(None, (dcn_host,
ici_chip))``: the rank at mesh position (h, c) of an (H, C) mesh owns
block h*C + c of B/n contiguous columns (n = H*C).  Each rank holds its
block as an ordinary tensor on its own device, so elementwise HE ops run
on it with no communication and reductions gather the per-rank partials
(``collective.py``).  The mesh spans every rank of the group.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..device import resolve
from ..utils.config import get_config

DCN_AXIS = "dcn_host"
ICI_AXIS = "ici_chip"


def make_mesh(n_hosts: int | None = None, chips_per_host: int | None = None,
              device_type: str | None = None):
    """A ("dcn_host", "ici_chip") ``DeviceMesh`` of shape (n_hosts,
    chips_per_host) over the initialized process group's ranks (rank h*C
    + c at position (h, c)).  The shape defaults to the config knobs
    ``mesh_hosts`` / ``mesh_chips`` (``PAILLIER_MESH_SHAPE="H,C"``), else
    (1, world size); device_type to the port's default device's."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.initialize)")
    world = dist.get_world_size()
    cfg = get_config()
    if n_hosts is None and chips_per_host is None and cfg.mesh_hosts:
        n_hosts, chips_per_host = cfg.mesh_hosts, cfg.mesh_chips
    n_hosts = 1 if n_hosts is None else n_hosts
    if chips_per_host is None:
        chips_per_host = world // n_hosts
    if n_hosts * chips_per_host != world:
        raise ValueError(f"a ({n_hosts}, {chips_per_host}) mesh does not "
                         f"cover the group's {world} ranks")
    return init_device_mesh(device_type or resolve(None).type,
                            (n_hosts, chips_per_host),
                            mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def mesh_shape(mesh) -> tuple:
    """(H, C) of a ``DeviceMesh``, or of an (H, C) tuple given instead."""
    return tuple(mesh) if isinstance(mesh, tuple) else tuple(mesh.shape)


def mesh_ranks(mesh) -> list:
    """The ranks in block order (position (h, c) at index h*C + c); an
    (H, C) tuple stands for the ranks 0 .. H*C - 1 in order."""
    if isinstance(mesh, tuple):
        return list(range(math.prod(mesh)))
    return mesh.mesh.flatten().tolist()


def batch_bounds(mesh, B: int, rank: int) -> tuple:
    """(lo, hi): the columns [lo, hi) of a B-wide batch that `rank` owns.
    Raises unless the mesh's size divides B."""
    n = math.prod(mesh_shape(mesh))
    if B % n:
        raise ValueError(f"batch of {B} columns does not split over a mesh "
                         f"of {n} ranks")
    i = mesh_ranks(mesh).index(rank)
    return i * (B // n), (i + 1) * (B // n)


def shard_batch(arr: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (L, B/n) block of the (L, B) batch `arr` (a contiguous
    copy).  Raises unless n divides B."""
    lo, hi = batch_bounds(mesh, arr.shape[1], dist.get_rank())
    return arr[:, lo:hi].contiguous()


def replicate(tree, mesh, src: int | None = None):
    """`tree` (a tensor, or a dataclass of them such as ``MontCtx``) with
    every tensor broadcast from rank `src` (default: the mesh's first
    rank): key material is shared, only ciphertexts shard.  Returns
    copies; Python values are kept as they are."""
    src = mesh_ranks(mesh)[0] if src is None else src

    def bcast(t):
        t = t.detach().contiguous().clone()
        dist.broadcast(t, src=src)
        return t

    return _map_tensors(tree, bcast)


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init})
    return tree
