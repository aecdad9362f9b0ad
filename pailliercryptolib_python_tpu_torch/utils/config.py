"""Runtime knobs, under the JAX package's field names so a test can
``set_config`` both packages alike (``pailliercryptolib_python_tpu/utils/
config.py``).  Only the knobs the port reads are here.

  * comb_window_tpu / comb_window_cpu  (PAILLIER_COMB_WINDOW)
        largest fixed-base comb window; ``comb_window_tpu`` is the
        accelerator value and applies to CUDA contexts.
  * comb_hbm_budget_bytes              (PAILLIER_COMB_HBM_BUDGET)
        device-memory budget the per-key comb table must fit half of.
  * decrypt_engine                     (PAILLIER_DECRYPT_ENGINE)
        "auto" / "rns": the RNS chain (kernel K2); "limb": the shared-
        exponent limb modexp (kernel K7).
  * encrypt_engine                     (PAILLIER_ENCRYPT_ENGINE)
        "auto" or "rns"; the limb comb is still to be ported, so "limb"
        raises NotImplementedError.  ct*pt takes its RNS route (kernel
        K5) when either engine knob allows RNS.
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
"""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclasses.dataclass
class Config:
    comb_window_tpu: int = _env_int("PAILLIER_COMB_WINDOW", 12)
    comb_window_cpu: int = _env_int("PAILLIER_COMB_WINDOW", 8)
    comb_hbm_budget_bytes: int = _env_int(
        "PAILLIER_COMB_HBM_BUDGET", 4 * 1024**3)
    matmul_chunk_columns: int = _env_int("PAILLIER_MATMUL_CHUNK", 1 << 15)
    decrypt_engine: str = os.environ.get("PAILLIER_DECRYPT_ENGINE", "auto")
    encrypt_engine: str = os.environ.get("PAILLIER_ENCRYPT_ENGINE", "auto")
    fixed_shape_ops: bool = os.environ.get("PAILLIER_FIXED_SHAPE") == "1"
    keygen_parallel: str = os.environ.get("PAILLIER_KEYGEN_PARALLEL",
                                          "auto")


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    """Update knobs in place; returns the live config."""
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise ValueError(f"set_config: unknown knob {k!r}")
        setattr(_config, k, v)
    return _config


def require_rns(knob: str) -> None:
    """The encrypt engine is RNS only: the limb comb is not ported."""
    v = getattr(_config, knob)
    if v not in ("auto", "rns"):
        raise NotImplementedError(
            f"{knob}={v!r}: the port runs only the RNS engine here (the "
            f"limb comb is still to be ported, see ROADMAP.md)")


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
