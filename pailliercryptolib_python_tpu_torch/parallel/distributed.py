"""The process group's lifecycle on ``torch.distributed``.

Counterpart of ``pailliercryptolib_python_tpu/parallel/distributed.py``
(``jax.distributed``).  Every process calls :func:`initialize` before it
touches a sharded op; :func:`mesh.make_mesh` then lays the ranks out on
the ("dcn_host", "ici_chip") mesh.  The backend follows the device:
NCCL for a CUDA device, gloo for the CPU.

Environment contract (the reference's):
  PAILLIER_COORDINATOR   "host:port" of process 0, the TCP store
                         (``init_method="tcp://host:port"``)
  PAILLIER_NUM_PROCESSES number of processes (the world size)
  PAILLIER_PROCESS_ID    this process's rank in [0, num_processes)

Without the contract (or with one process) :func:`initialize` is a
no-op; explicit arguments create a group of any size, one included,
which a single process needs before it calls a sharded op.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve

_initialized = False


def launch_info_from_env() -> dict | None:
    """The launch contract from the environment, as keyword arguments of
    :func:`initialize`, or None for a single-process run."""
    coord = os.environ.get("PAILLIER_COORDINATOR")
    nproc = os.environ.get("PAILLIER_NUM_PROCESSES")
    pid = os.environ.get("PAILLIER_PROCESS_ID")
    if not (coord and nproc and pid) or int(nproc) <= 1:
        return None
    return {"coordinator_address": coord, "num_processes": int(nproc),
            "process_id": int(pid)}


def backend_for(device=None) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU (the port's default
    device when None)."""
    return "nccl" if resolve(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               init_method: str | None = None) -> bool:
    """Join the process group (idempotent); True when a group is active.

    Explicit arguments win (``init_method``, e.g. ``file:///tmp/pg``,
    in place of a coordinator address); otherwise the PAILLIER_* contract
    is read, and without it (or with one process) nothing happens and
    the call returns False.  The backend is ``backend_for(device)``."""
    global _initialized
    if dist.is_initialized():
        return True
    if coordinator_address is None and init_method is None:
        info = launch_info_from_env()
        if info is None:
            return False
        coordinator_address = info["coordinator_address"]
        num_processes = info["num_processes"]
        process_id = info["process_id"]
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id "
                         "with an explicit address")
    dist.init_process_group(
        backend_for(device),
        init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    _initialized = True
    return True


def shutdown() -> None:
    """Destroy the process group that :func:`initialize` created."""
    global _initialized
    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_info() -> tuple[int, int]:
    """(rank, world size) of the active group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def require_group(*tensors: torch.Tensor) -> None:
    """Raise unless a process group is active whose backend serves the
    tensors' device: NCCL for CUDA tensors, gloo for CPU tensors."""
    if not dist.is_initialized():
        raise RuntimeError("sharded ops need an initialized process group "
                           "(parallel.distributed.initialize)")
    backend = dist.get_backend()
    for t in tensors:
        need = backend_for(t.device)
        if backend != need:
            raise ValueError(f"a {t.device.type} tensor needs a {need} "
                             f"process group; the group is {backend}")
