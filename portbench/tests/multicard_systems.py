"""Systems for the CPU tests of a run over several ranks, each named in
the run's description (``"module:attribute"``) and built in every rank
process: the port as one rank (``ShardedPortSystem``), with its timed
path broken underneath in ``parallel.collective``, a rank that dies in
the window, or a rank that loads a JAX module.  Each records its process id in the directory
``PORTBENCH_TEST_PIDS`` names, so that a test can see every rank gone."""

import os
import signal
import sys
import types

from pailliercryptolib_python_tpu_torch.ops import montgomery as mg
from pailliercryptolib_python_tpu_torch.parallel import collective
from portbench.systems import ShardedPortSystem


def _rank() -> int:
    return int(os.environ["PAILLIER_PROCESS_ID"])


def _record() -> None:
    pids = os.environ.get("PORTBENCH_TEST_PIDS")
    if pids:
        open(os.path.join(pids, str(os.getpid())), "w").close()


def sound(key, device):
    _record()
    return ShardedPortSystem(key, device)


class _Dies(ShardedPortSystem):
    """Rank 2 kills itself at its third request (warm-up included)."""

    calls = 0

    def sharded_sum(self, parts):
        self.calls += 1
        if self.rank == 2 and self.calls == 3:
            os.kill(os.getpid(), signal.SIGKILL)
        return super().sharded_sum(parts)


def dies(key, device):
    _record()
    return _Dies(key, device)


def unchanged(key, device):
    """The parties' combine returns its state unchanged: party 0's."""
    collective.federated_aggregate = lambda cts, ctx, mesh=None: cts[0]
    return sound(key, device)


def half(key, device):
    """Half of each batch left out, the rest standing in for it."""
    orig = collective.local_tree_reduce

    def reduce_half(x, ctx):
        h = max(1, x.shape[1] // 2)
        s = orig(x[:, :h], ctx)
        return mg.mont_mul(s, s, ctx)
    collective.local_tree_reduce = reduce_half
    return sound(key, device)


class _NoExchange:
    """``torch.distributed`` with the all-gather left out: every slot
    gets this rank's own partial."""

    def __init__(self, dist):
        self._dist = dist

    def __getattr__(self, name):
        return getattr(self._dist, name)

    @staticmethod
    def all_gather(parts, t, group=None, async_op=False):
        for p in parts:
            p.copy_(t)


def no_exchange(key, device):
    collective.dist = _NoExchange(collective.dist)
    return sound(key, device)


def _alter_on(rank):
    orig = collective.fold_partials

    def fold(parts, ctx):
        out = orig(parts, ctx)
        return mg.mont_mul(out, out, ctx) if _rank() == rank else out
    collective.fold_partials = fold


def altered(key, device):
    """Rank 0's total altered where it is produced."""
    _alter_on(0)
    return sound(key, device)


def altered_elsewhere(key, device):
    """Rank 1's total altered: rank 0's answers stay right."""
    _alter_on(1)
    return sound(key, device)


def jax_elsewhere(key, device):
    """Rank 1 alone has a module named ``jax`` loaded."""
    if _rank() == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    return sound(key, device)
