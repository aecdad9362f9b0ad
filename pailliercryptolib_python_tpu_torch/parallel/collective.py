"""Sharded HE collectives on ``torch.distributed``: the encrypted
all-reduce and the elementwise ops over a batch split across ranks.

Counterpart of ``pailliercryptolib_python_tpu/parallel/collective.py``.
Ciphertext addition is a Montgomery product mod n^2, so an encrypted
all-reduce is a product tree over the batch: each rank folds its own
block (``ops.reduction.tree_fold``, the fold of ``PublicContext``'s sums
too: log2 rounds, each multiplying the upper half into the lower, as
the reference's ``_local_tree_reduce``), the (L, 1) partials are
all-gathered in rank order, and every rank folds them the same way.  The
reference gathers over ICI, then DCN; that order is the mesh's block
order, h*C + c, so the result equals the JAX program limb for limb.  The
list form of ``dist.all_gather`` runs on gloo as well as NCCL.
"""

from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

from ..ops import montgomery as mg
from ..ops.reduction import tree_fold
from .distributed import require_group
from .mesh import mesh_ranks

# The collectives and point-to-point calls of ``torch.distributed`` that
# count_collectives watches.
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_gather_object",
               "all_reduce", "all_to_all", "all_to_all_single", "barrier",
               "broadcast", "broadcast_object_list", "gather", "irecv",
               "isend", "recv", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "scatter", "send")


def local_tree_reduce(x: torch.Tensor, ctx: mg.MontCtx) -> torch.Tensor:
    """The HE sum of a (L, Bloc) block as (L, 1) (``ops.reduction.
    tree_fold``, one segment).  A name of its own so that a rank's
    partial can be replaced (``portbench/tests/multicard_systems.py``)."""
    return tree_fold(x, ctx)


def fold_partials(parts: list, ctx: mg.MontCtx) -> torch.Tensor:
    """The ranks' (L, 1) partials, in block order, folded into their
    (L, 1) HE sum (the reference's fold of the gathered partials)."""
    return local_tree_reduce(torch.cat(parts, dim=1), ctx)


def sharded_he_sum(ct_local: torch.Tensor, ctx: mg.MontCtx,
                   mesh) -> torch.Tensor:
    """HE sum of a batch split over the mesh -> (L, 1), the same on
    every rank.  One ``dist.all_gather`` of the (L, 1) partials.  Padding
    columns must hold the Montgomery one (an encryption of zero)."""
    require_group(ct_local)
    ranks = mesh_ranks(mesh)
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError("the mesh must span every rank of the group")
    partial = local_tree_reduce(ct_local, ctx).contiguous()
    parts = [torch.empty_like(partial) for _ in ranks]
    dist.all_gather(parts, partial)
    return fold_partials([parts[r] for r in ranks], ctx)


def sharded_elementwise(fn, mesh):
    """``fn`` over the ranks' blocks: an elementwise HE op (add_ct,
    obfuscate, encrypt_raw) needs no communication, so the wrapper
    checks the group against its tensor arguments and calls fn on this
    rank's blocks as they are."""

    def wrapper(*args, **kwargs):
        require_group(*[a for a in (*args, *kwargs.values())
                        if isinstance(a, torch.Tensor)])
        return fn(*args, **kwargs)

    return wrapper


def federated_aggregate(cts: list, ctx: mg.MontCtx,
                        mesh=None) -> torch.Tensor:
    """The elementwise HE sum of K parties' (L, Bloc) ciphertext blocks
    (the federated-learning aggregate): K - 1 products, no traffic.  With
    a mesh, the group is checked against the blocks first."""
    if mesh is not None:
        require_group(*cts)
    acc = cts[0]
    for other in cts[1:]:
        acc = mg.mont_mul(acc, other, ctx)
    return acc


@contextlib.contextmanager
def count_collectives():
    """Count the calls of ``torch.distributed``'s collectives
    (``COLLECTIVES``) made through the module while the block runs;
    yields the ``collections.Counter``.  The port's counterpart of the
    reference's compiled-HLO audit: a shard's decrypt or ct*pt chain must
    leave it empty."""
    counts = collections.Counter()
    saved = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def counted(*args, _name=name, _fn=fn, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        setattr(dist, name, counted)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
