"""Runtime knobs, under the JAX package's field names so a test can
``set_config`` both packages alike (``pailliercryptolib_python_tpu/utils/
config.py``), and the registry that bounds the device memory of the
per-key comb tables.

  * comb_window_tpu / comb_window_cpu  (PAILLIER_COMB_WINDOW)
        largest fixed-base comb window; ``comb_window_tpu`` is the
        accelerator value and applies to CUDA contexts.
  * comb_hbm_budget_bytes              (PAILLIER_COMB_HBM_BUDGET)
        device memory allowed across all live comb tables; a key's table
        must fit half of it, and the least recently used keys drop their
        tables when a new one would exceed it (``comb_registry``).
  * exp_window                         (PAILLIER_EXP_WINDOW)
        carried so ``set_config`` takes the same names in both packages;
        the per-element modexp window is the constant 4, as in the JAX
        package, which reads this knob nowhere either.
  * rns_exp_window                     (PAILLIER_RNS_WINDOW)
        window of the fixed-window RNS decrypt chain (kernel K6,
        ``PrivateContext.rdig_p`` / ``rdig_q``); its table is 2^w states.
  * encrypt_pipeline_chunks            (PAILLIER_ENC_CHUNKS)
        ``PaillierPublicKey.encrypt`` cuts a batch of at least 256 per
        chunk into this many chunks, so the host stage of one chunk
        (encode, pack, entropy) overlaps the device work of the one
        before; ``hybridControl.setHybridMode`` sets it.
  * encrypt_host_ratio                 (PAILLIER_HOST_RATIO)
        share of each encrypt batch that a host thread encrypts with
        Python bigints while the device encrypts the rest; active only
        after ``context.initializeContext`` (``hybridControl`` sets it).
  * decrypt_engine                     (PAILLIER_DECRYPT_ENGINE)
        "auto" / "rns": the RNS chain (kernel K2); "limb": the shared-
        exponent limb modexp (kernel K7) on p^2/q^2 contexts with mm3
        weights, else the fused per-element chain over [p^2]*B ++
        [q^2]*B (kernel K10).
  * encrypt_engine                     (PAILLIER_ENCRYPT_ENGINE)
        DJN encrypt / re-randomize engine: "auto" / "rns" the RNS comb
        (kernel K1), "limb" the limb comb (kernel K3, or K9 on a modulus
        without mm3 weights).  Keys past the RNS bound, or whose RNS comb
        exceeds half of comb_hbm_budget_bytes, take the limb comb
        whatever the knob.  Unlike the JAX package, whose "auto" picks
        the limb comb on its CPU backend, "auto" is RNS on every device.
        ct*pt takes its RNS route (kernel K5) when either engine knob
        allows RNS.
  * matmul_chunk_columns               (PAILLIER_MATMUL_CHUNK)
        most ciphertext columns ``@`` materializes per chunk; one
        reduction group is the indivisible unit, so a group wider than
        this is still processed whole.
  * fixed_shape_ops                    (PAILLIER_FIXED_SHAPE=1)
        ct*pt runs the full mod-n window count and inverts the whole
        batch, so device time does not depend on plaintext size or sign.
  * keygen_parallel                    (PAILLIER_KEYGEN_PARALLEL)
        concurrent p/q prime searches in a 2-process pool: "auto"
        (>= 3072-bit keys), "1" always, "0" serial.
  * keygen_device                      (PAILLIER_KEYGEN_DEVICE)
        the base-2 Miller-Rabin round of keygen over all sieve survivors
        of a window at once on the device (kernels K10 and K9): "1"
        always, "auto" on a CUDA device for primes of >= 1024 bits, "0"
        (default) on the host.  Pool workers run it on the CPU.
  * mesh_hosts / mesh_chips            (PAILLIER_MESH_SHAPE="H,C")
        default shape of ``parallel.mesh.make_mesh``: H rows on the
        ("dcn_host") axis and C columns on the ("ici_chip") axis of the
        process group's ranks; unset, the mesh is (1, world size).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclasses.dataclass
class Config:
    comb_window_tpu: int = _env_int("PAILLIER_COMB_WINDOW", 12)
    comb_window_cpu: int = _env_int("PAILLIER_COMB_WINDOW", 8)
    comb_hbm_budget_bytes: int = _env_int(
        "PAILLIER_COMB_HBM_BUDGET", 4 * 1024**3)
    exp_window: int = _env_int("PAILLIER_EXP_WINDOW", 4)
    matmul_chunk_columns: int = _env_int("PAILLIER_MATMUL_CHUNK", 1 << 15)
    decrypt_engine: str = os.environ.get("PAILLIER_DECRYPT_ENGINE", "auto")
    rns_exp_window: int = _env_int("PAILLIER_RNS_WINDOW", 5)
    encrypt_engine: str = os.environ.get("PAILLIER_ENCRYPT_ENGINE", "auto")
    fixed_shape_ops: bool = os.environ.get("PAILLIER_FIXED_SHAPE") == "1"
    keygen_parallel: str = os.environ.get("PAILLIER_KEYGEN_PARALLEL",
                                          "auto")
    keygen_device: str = os.environ.get("PAILLIER_KEYGEN_DEVICE", "0")
    encrypt_pipeline_chunks: int = _env_int("PAILLIER_ENC_CHUNKS", 1)
    encrypt_host_ratio: float = float(
        os.environ.get("PAILLIER_HOST_RATIO", "0") or 0)
    mesh_hosts: int | None = None
    mesh_chips: int | None = None

    def __post_init__(self):
        shape = os.environ.get("PAILLIER_MESH_SHAPE")
        if shape and self.mesh_hosts is None:
            h, c = shape.split(",")
            self.mesh_hosts, self.mesh_chips = int(h), int(c)


_config = Config()
_lock = threading.Lock()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Update knobs in place; returns the live config."""
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise ValueError(f"set_config: unknown knob {k!r}")
        setattr(_config, k, v)
    return _config


def comb_table_bytes(randbits: int, L: int, window: int) -> int:
    """Bytes of a fixed-base comb table of L-row uint32 entries."""
    return -(-randbits // window) * L * (1 << window) * 4


def choose_comb_window(randbits: int, L: int, max_window: int) -> int:
    """Largest window <= max_window whose table fits half the budget."""
    cap = max(1, _config.comb_hbm_budget_bytes // 2)
    for w in range(max_window, 2, -1):
        if comb_table_bytes(randbits, L, w) <= cap:
            return w
    return 2


class _CombRegistry:
    """Least-recently-used registry of the live per-key comb tables,
    bounded by ``comb_hbm_budget_bytes``.

    Owners (PublicContext instances) register the bytes of their tables
    when they build them; when the running total would exceed the budget
    the least recently used owners are told to drop theirs (the device
    memory is freed once nothing refers to it).  A touch on every use
    keeps hot keys resident."""

    def __init__(self):
        self._entries: OrderedDict[int, tuple] = OrderedDict()
        self._total = 0

    def register(self, owner, nbytes: int) -> None:
        with _lock:
            key = id(owner)
            if key in self._entries:
                self._total -= self._entries.pop(key)[1]
            budget = get_config().comb_hbm_budget_bytes
            while self._entries and self._total + nbytes > budget:
                _, (old_owner, old_bytes) = self._entries.popitem(last=False)
                self._total -= old_bytes
                old_owner._drop_comb()
            self._entries[key] = (owner, nbytes)
            self._total += nbytes

    def touch(self, owner) -> None:
        with _lock:
            key = id(owner)
            if key in self._entries:
                self._entries.move_to_end(key)

    def unregister(self, owner) -> None:
        with _lock:
            ent = self._entries.pop(id(owner), None)
            if ent is not None:
                self._total -= ent[1]

    @property
    def total_bytes(self) -> int:
        return self._total

    def __len__(self):
        return len(self._entries)


comb_registry = _CombRegistry()
