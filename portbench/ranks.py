"""A run of a cell over several cards: one process a card, in lockstep.

A cell whose ``chips`` is above 1 runs as that many processes.  The
process started as ``portbench/run.py`` is rank 0.  Before it imports
torch it starts ranks 1 .. chips-1 as ``python3 portbench/run.py --rank
<r>`` (``launch``), which import torch and the port meanwhile; once it
has found the cards it hands each rank the run's description (``spec``,
JSON on stdin) and runs the cell with them (``lead``).  Every rank sets
the port's launch contract in its environment (``PAILLIER_COORDINATOR``
on a free local port, ``PAILLIER_NUM_PROCESSES``,
``PAILLIER_PROCESS_ID``) and, on a card, loads the port's kernel
library under the checkout's build lock (``load_kernels``), so that the
first to hold it builds the library if need be and no two build into
the same directory.  Rank r drives card r.  Every rank makes the same
request kinds and the same cycle from the seed, and builds its system
(``spec["system"]``, by default ``systems.ShardedPortSystem``: the
port's process group and a (1, chips) mesh).

``Lockstep`` keeps the ranks together on a gloo group of its own, so
that the device trace sees only the program's collectives: rank 0
broadcasts "go" or "stop" before each request, outside the request's
clock, and every rank then issues the same request; a barrier after
every rank's warm-up ends the set-up; after the window each rank sends
rank 0 its memory peak, its answer to the window's last request and the
JAX modules it has loaded, so that a module loaded on any rank makes
rank 0 exit with code 3.  Rank 0 alone times, traces, judges and
prints.

Every wait is bounded.  On rank 0 a ``Watchdog`` ends the run with exit
code 1, every other rank killed and waited for, as soon as a rank exits
with another code than 0, or when rank 0 has made no step for
STALL_SECONDS (the process group's rendezvous and every collective
included); the control group's calls time out after as long.  A rank
dies with rank 0 (``PR_SET_PDEATHSIG``), so none outlives it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import importlib
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

STALL_SECONDS = 120.0
DEFAULT_SYSTEM = "portbench.systems:ShardedPortSystem"
HERE = os.path.dirname(os.path.abspath(__file__))
RUN_PY = os.path.join(HERE, "run.py")
BUILD_LOCK = os.path.join(os.path.dirname(HERE), ".portbench_cache",
                          "kernels.lock")


def load_factory(name: str):
    """The system factory ``"module:attribute"``."""
    module, attr = name.split(":")
    return getattr(importlib.import_module(module), attr)


def device_of(spec: dict, rank: int) -> str:
    return f"cuda:{rank}" if spec["device"] == "cuda" else "cpu"


def set_contract(coordinator: str, world: int, rank: int) -> None:
    """The port's launch contract (``parallel/distributed.py``)."""
    os.environ["PAILLIER_COORDINATOR"] = coordinator
    os.environ["PAILLIER_NUM_PROCESSES"] = str(world)
    os.environ["PAILLIER_PROCESS_ID"] = str(rank)


@contextlib.contextmanager
def build_lock():
    """The checkout's lock on the port's kernel build, held until the
    block ends (``flock``; the kernel lets it go with the process)."""
    os.makedirs(os.path.dirname(BUILD_LOCK), exist_ok=True)
    with open(BUILD_LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def load_kernels(spec: dict) -> None:
    """The port's kernel library on a card, built by the first process
    to hold the build lock; nothing on the CPU."""
    if spec["device"] == "cuda":
        from pailliercryptolib_python_tpu_torch import kernels
        with build_lock():
            kernels.lib()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def stop(procs: list) -> None:
    """Kill the ranks still running and wait until each has ended."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def die_with_parent() -> None:
    """Have the kernel kill this process when its parent ends.  (A
    parent that ended before the first look leaves stdin at its end, so
    the rank fails at reading its description.)"""
    parent = os.getppid()
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL, 0, 0, 0)        # PR_SET_PDEATHSIG
    if os.getppid() != parent:                     # it ended meanwhile
        os._exit(1)


class Watchdog(threading.Thread):
    """Rank 0's bound on every wait: until ``close``, the run ends with
    exit code 1 when a rank exits with another code than 0, or when no
    step has been made for STALL_SECONDS while ``stalls`` is on."""

    def __init__(self, procs: list, log=sys.stderr):
        super().__init__(daemon=True)
        self.procs, self.log = procs, log
        self.stalls = True
        self._open = True
        self._lock = threading.Lock()
        self._last = time.monotonic()

    def beat(self) -> None:
        self._last = time.monotonic()

    def close(self) -> None:
        with self._lock:
            self._open = False

    def run(self) -> None:
        while self._open:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code:
                    self._fail(f"rank {r} exited with code {code}")
            if self.stalls and time.monotonic() - self._last > STALL_SECONDS:
                self._fail(f"no step in {STALL_SECONDS:.0f} s")
            time.sleep(0.2)

    def _fail(self, why: str) -> None:
        with self._lock:
            if not self._open:
                return
            print(f"portbench: {why}; ending the run", file=self.log,
                  flush=True)
            stop(self.procs)
            os._exit(1)


class Lockstep:
    """The ranks' own gloo group: go or stop, the barrier, the gathers."""

    def __init__(self, rank: int, world: int, watchdog: Watchdog | None):
        self.rank, self.world = rank, world
        self.watchdog = watchdog
        self.group = None

    def join(self) -> None:
        """Make the group; after the program's group, on every rank."""
        from datetime import timedelta
        import torch
        import torch.distributed as dist
        self._dist = dist
        self.group = dist.new_group(
            backend="gloo", timeout=timedelta(seconds=STALL_SECONDS))
        self._flag = torch.zeros(1, dtype=torch.int32)

    def beat(self) -> None:
        if self.watchdog is not None:
            self.watchdog.beat()

    def go(self, more: bool) -> bool:
        """Rank 0's `more`, on every rank."""
        self.beat()
        self._flag[0] = int(more)
        self._dist.broadcast(self._flag, src=0, group=self.group)
        return bool(self._flag[0])

    def barrier(self) -> None:
        self.beat()
        self._dist.barrier(group=self.group)

    def finish(self, memory_peak: int, last, found: list) -> tuple:
        """Gather each rank's (memory peak, last answer, JAX modules
        loaded) on rank 0.  Returns (the largest peak, the number of
        ranks whose last answer is not rank 0's, the modules the other
        ranks found, each named with its rank) on rank 0, (None, None,
        None) elsewhere."""
        self.beat()
        mine = (int(memory_peak), pickle.dumps(last), list(found))
        out = [None] * self.world if self.rank == 0 else None
        self._dist.gather_object(mine, out, dst=0, group=self.group)
        if self.watchdog is not None:
            self.watchdog.stalls = False       # the rest waits on no rank
        if self.rank != 0:
            return None, None, None
        return (max(p for p, _, _ in out),
                sum(b != out[0][1] for _, b, _ in out[1:]),
                [f"{m} (rank {r})" for r, (_, _, ms) in enumerate(out)
                 for m in ms if r])


def start_ranks(world: int) -> list:
    """Ranks 1 .. world-1 as processes of their own, which import torch
    and the port, then wait for the run's description on stdin; their
    stdout goes to this process's stderr, so that rank 0's result line
    stays the last line of stdout."""
    procs = []
    try:
        for r in range(1, world):
            procs.append(subprocess.Popen(
                [sys.executable, RUN_PY, "--rank", str(r)],
                stdin=subprocess.PIPE, stdout=2, text=True))
    except BaseException:
        stop(procs)
        raise
    return procs


def launch(spec: dict) -> tuple:
    """Rank 0's start, before it imports torch: the port's contract for
    this process, ranks 1 .. world-1 started; returns (the run's
    description as ``lead`` hands it on, the ranks' processes)."""
    spec = dict(spec, coordinator=f"localhost:{free_port()}")
    set_contract(spec["coordinator"], spec["world"], 0)
    return spec, start_ranks(spec["world"])


def lead(spec: dict, procs: list, run_cell) -> dict:
    """Rank 0, after ``launch``: hand each rank `spec`, load the
    kernels, run the cell with the other ranks; returns the result.
    Every rank is ended and waited for on return and on any failure."""
    watchdog = None
    try:
        for p in procs:
            p.stdin.write(json.dumps(spec))
            p.stdin.close()
        load_kernels(spec)
        watchdog = Watchdog(procs)
        watchdog.start()
        result = run_cell(spec, 0, Lockstep(0, spec["world"], watchdog))
        for p in procs:                  # they end after the gathers
            p.wait(timeout=STALL_SECONDS)
        bad = {r: p.returncode for r, p in enumerate(procs, 1)
               if p.returncode}
        if bad:
            raise RuntimeError(f"ranks ended with codes {bad}")
        return result
    finally:
        if watchdog is not None:
            watchdog.close()
        stop(procs)


def follow(rank: int, run_cell) -> None:
    """Rank r > 0: import torch and the port while rank 0 starts, read
    the run's description from stdin, run the cell with rank 0, print
    nothing."""
    die_with_parent()
    import torch  # noqa: F401
    import pailliercryptolib_python_tpu_torch  # noqa: F401
    spec = json.load(sys.stdin)
    set_contract(spec["coordinator"], spec["world"], rank)
    load_kernels(spec)
    run_cell(spec, rank, Lockstep(rank, spec["world"], None))
