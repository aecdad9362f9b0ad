"""Build, bind and count the hand-written CUDA kernels.

The sources in ``csrc/*.cu`` are compiled at first use, one nvcc per
source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o build/<name>.o csrc/<name>.cu

then linked with ``nvcc -shared -o build/libpct_kernels.so build/*.o``
in this package's git-ignored ``build/`` directory, and loaded with
ctypes.  Each C entry point launches one kernel on the stream it is
given and returns ``cudaGetLastError()``; ``launch`` raises on any
nonzero code.  There is no fallback: a tensor that is not on a CUDA
device never reaches this module (``require_cuda`` raises).

``COUNTS`` holds one launch counter per kernel.  ``launch`` adds one to
a kernel's counter exactly where it launches it, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from .ops.limb import h2d

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libpct_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

COUNTS = {"rns_mul": 0, "rns_exp_sched": 0, "rns_exp_elem": 0,
          "rns_exp_shared": 0, "mm3_mul": 0, "mm3_exp": 0,
          "mm3_exp_shared": 0, "mm3_sqr": 0, "mont_mul": 0, "mont_exp": 0,
          "mont_chain": 0, "mm2_mul": 0, "mm2_sqr": 0, "mm2_exp": 0,
          "mm2_exp_shared": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C signatures: pointers are c_void_p (ctypes would cut a Python int to
# 32 bits otherwise); the last argument of each is the CUDA stream.
_SIGS = {
    "mm3_mul": [_P, _P, _P, _P, _P, _I, _I, _P],
    "mm3_exp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mm3_sqr": [_P, _P, _P, _U, _I, _I, _P],
    "rns_mul": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rns_exp_sched": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
    "rns_exp_elem": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _P],
    "rns_exp_shared": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _P],
    "mm3_exp_shared": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mont_mul": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mont_exp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mont_chain": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mm2_mul": [_P, _P, _P, _P, _P, _I, _I, _P],
    "mm2_sqr": [_P, _P, _P, _P, _I, _I, _P],
    "mm2_exp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mm2_exp_shared": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lib = None
_lock = threading.Lock()
build_log = ""           # nvcc's output (register / shared-memory report)
build_seconds = None


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH (atomic rename) unless it is newer
    than every source; return the path.  The sources compile in
    parallel, one nvcc process each, into a private temporary directory."""
    global build_log, build_seconds
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    newest = max(os.path.getmtime(s) for s in
                 srcs + glob.glob(os.path.join(CSRC, "*.cuh")))
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate(timeout=900)[0] for p in procs]
        tmp = os.path.join(tmpdir, "lib.so")
        link = None
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True,
                                  timeout=300)
            logs.append(link.stdout + link.stderr)
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, args in _SIGS.items():
                fn = getattr(handle, "pct_" + name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def mont_exp_shape(L: int, B: int) -> tuple:
    """(g, K) of the cooperative kernels K8-K15 at L limbs and B
    columns: a group of g lanes per column, K 32-bit words a lane
    (``csrc/coop.cuh`` ``coop_shape``), read from the built library."""
    v = int(lib().pct_mont_exp_shape(L, B))
    return v // 100, v % 100


def mm2_exp_shared_table_words(L: int, B: int, window: int) -> int:
    """The 32-bit words of table scratch a launch of K15
    (``mm2_exp_shared``) needs at L limbs, B columns and 2^window
    entries, read from the built library (``csrc/mont2.cu``)."""
    fn = lib().pct_mm2_exp_shared_table_words
    fn.restype = ctypes.c_longlong
    words = int(fn(L, B, window))
    if words < 0:
        raise ValueError(f"K15 takes no launch at L={L}, B={B}, "
                         f"window={window}")
    return words


def mm3_smem_bytes(name: str, L: int) -> int:
    """The dynamic shared memory a launch of K3 (``mm3_mul``), K4
    (``mm3_exp``) or K7 (``mm3_exp_shared``) asks for at L limbs, read
    from the built library (``csrc/mont3.cu`` ``mm3_smem``)."""
    fn = lib().pct_mm3_smem
    fn.restype = ctypes.c_longlong
    return int(fn(L, ("mm3_mul", "mm3_exp", "mm3_exp_shared").index(name)))


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel operands must share one CUDA device; "
                             f"got {[str(x.device) for x in tensors]}")


def digit_tensor(digits, window: int, device, below: int | None = None
                 ) -> torch.Tensor:
    """Exponent digits, made on the host (numpy or a CPU tensor), checked
    there to lie in [0, below) (below = 2^window unless given), as a
    contiguous int32 tensor on `device`, copied without a host
    synchronization (``limb.h2d``).  The tensor carries the bound it was
    checked against (``checked_below``), so a caller may keep it on the
    device and pass it again.  Any other tensor on a device raises:
    checking it would cost a copy back and a synchronize."""
    below = (1 << window) if below is None else below
    if isinstance(digits, torch.Tensor):
        if digits.device.type != "cpu":
            checked = getattr(digits, "checked_below", None)
            if checked is not None and checked <= below:
                return digits
            raise ValueError("exponent digits must be given on the host "
                             f"(got a tensor on {digits.device})")
        digits = digits.numpy()
    d = np.asarray(digits).astype(np.int64)
    if d.size and (d.min() < 0 or d.max() >= below):
        raise ValueError(f"exponent digit outside [0, 2^{window})")
    t = h2d(torch.from_numpy(np.ascontiguousarray(d.astype(np.int32))),
            device)
    t.checked_below = below
    return t


def launch(name: str, *args) -> None:
    """Call kernel `name` with tensors passed as device pointers and the
    current stream appended; count the launch; raise on a CUDA error."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    err = _call(name, conv, dev)
    COUNTS[name] += 1
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def _call(name: str, conv: list, dev: torch.device) -> int:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return getattr(lib(), "pct_" + name)(*conv, stream)
