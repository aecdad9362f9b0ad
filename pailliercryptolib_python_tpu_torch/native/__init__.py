"""Host-side C helpers (sieve window, limb pack/unpack, fixed-point
decode, window extraction).

``sieve.c`` beside this file is the package's own copy of the JAX
package's C source, unchanged; it is compiled at first use into this
package's git-ignored ``build/`` directory.  Every entry point keeps the
pure-Python fallback of the original, so the port works without a C
toolchain.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sieve.c")
BUILD_DIR = os.path.join(_PKG, "build")
_MOD_NAME = "pailliercryptolib_python_tpu_torch.native._paillier_native"
_native = None


def _build() -> str | None:
    """Compile sieve.c into BUILD_DIR (atomic rename, so concurrent test
    workers never load a half-written file).  Returns the path or None."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(BUILD_DIR, "_paillier_native" + suffix)
    if not os.path.exists(_SRC):
        return out if os.path.exists(out) else None
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    include = sysconfig.get_paths()["include"]
    cmd = [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC",
           f"-I{include}", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def _load():
    global _native
    if _native is not None:
        return _native
    _native = False
    path = _build()
    if path:
        loader = importlib.machinery.ExtensionFileLoader(_MOD_NAME, path)
        spec = importlib.util.spec_from_file_location(_MOD_NAME, path,
                                                      loader=loader)
        try:
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _native = mod
        except ImportError:
            pass
    return _native


def sieve_window(base: int, count: int, primes) -> bytearray:
    """mask[i] == 1 iff base + 2i survives trial division by `primes`."""
    mod = _load()
    nb = max(1, (base.bit_length() + 7) // 8)
    if mod:
        return mod.sieve_window(base.to_bytes(nb, "little"), count,
                                tuple(primes))
    mask = bytearray(b"\x01" * count)
    for p in primes:
        if p <= 2:
            continue
        r = base % p
        j = ((p - r) * ((p + 1) // 2)) % p
        while j < count:
            if base + 2 * j != p:
                mask[j] = 0
            j += p
    return mask


def pack_limbs16(xs, num_limbs: int) -> np.ndarray:
    """(num_limbs, len(xs)) uint32 limb array from Python ints."""
    mod = _load()
    if not isinstance(xs, (list, tuple)):
        xs = list(xs)
    if mod:
        raw = mod.pack_ints16(xs, num_limbs)
        return np.frombuffer(raw, dtype=np.uint32).reshape(num_limbs, len(xs))
    nbytes = num_limbs * 2
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    out = np.frombuffer(buf, dtype="<u2").reshape(len(xs), num_limbs)
    return np.ascontiguousarray(out.T).astype(np.uint32)


def unpack_limbs16(arr) -> list:
    """List of Python ints from a (L, B) canonical limb array."""
    mod = _load()
    arr = np.ascontiguousarray(np.asarray(arr).astype(np.uint32))
    if mod:
        return mod.unpack_ints16(arr.tobytes(), arr.shape[1], arr.shape[0])
    rows = np.ascontiguousarray(arr.T).astype("<u2").tobytes()
    nb = arr.shape[0] * 2
    return [int.from_bytes(rows[i * nb:(i + 1) * nb], "little")
            for i in range(arr.shape[1])]


def decode_limbs16(arr, count: int, exps, n: int, max_int: int):
    """Fixed-point decode straight off the (L, B) canonical limb array
    (first `count` columns).  None when the C extension is unavailable
    (callers fall back to limb unpack + the scalar decode loop)."""
    mod = _load()
    if not mod:
        return None
    arr = np.ascontiguousarray(np.asarray(arr).astype(np.uint32))
    L, stride = arr.shape
    nb = L * 2
    e = np.ascontiguousarray(np.asarray(exps, dtype=np.int64))
    return mod.decode_limbs16(arr.tobytes(), count, stride, L, e.tobytes(),
                              n.to_bytes(nb, "little"),
                              max_int.to_bytes(nb, "little"),
                              (n - max_int).to_bytes(nb, "little"))


def extract_windows(buf: bytes, count: int, rbytes: int, window: int,
                    n_win: int):
    """(n_win, count) uint32 digits: out[w, c] = bits [w*window,
    (w+1)*window) of row c of a (count, rbytes) byte buffer.  None when
    the C extension is unavailable."""
    mod = _load()
    if mod:
        raw = mod.extract_windows(buf, count, rbytes, window, n_win)
        return np.frombuffer(raw, dtype=np.uint32).reshape(n_win, count)
    return None
