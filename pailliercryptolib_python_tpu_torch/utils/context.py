"""Runtime context and hybrid-mode controls.

Counterpart of ``pailliercryptolib_python_tpu/utils/context.py``, with
the same members and the same two mode tables.  The reference library
exposes an accelerator runtime lifecycle (``context``) and an
accelerator/CPU work-split policy (``hybridControl`` over ``hybridMode``).
Here the accelerator is the CUDA device, and a mode sets two knobs of
``utils/config.py``:

* ``encrypt_pipeline_chunks``: how finely ``PaillierPublicKey.encrypt``
  chunks a batch, so the host stage of chunk i+1 (fixed-point encode,
  limb packing, entropy) overlaps the device work of chunk i, which was
  only enqueued:

      QAT                    -> 1 chunk
      OPTIMAL / PREF_QAT*    -> 4 chunks
      HALF                   -> 2 chunks
      PREF_IPP* / IPP        -> 8 chunks
      UNDEFINED              -> the config default, untouched

* ``encrypt_host_ratio``: the share of each encrypt batch that a host
  thread encrypts with Python bigints while the device encrypts the rest
  (``api._hybrid_split_encrypt``); active only once
  ``context.initializeContext`` was called.  IPP routes everything to the
  host.

``context`` reports state and moves no work.
"""

from __future__ import annotations

import enum


class hybridMode(enum.IntEnum):
    """Accelerator/CPU work-split ratios (values of ipcl::HybridMode)."""

    OPTIMAL = 0
    QAT = 1
    PREF_QAT90 = 2
    PREF_QAT80 = 3
    PREF_QAT70 = 4
    PREF_QAT60 = 5
    HALF = 6
    PREF_IPP60 = 7
    PREF_IPP70 = 8
    PREF_IPP80 = 9
    PREF_IPP90 = 10
    IPP = 11
    UNDEFINED = 12


# the enum's members at module level too
OPTIMAL = hybridMode.OPTIMAL
QAT = hybridMode.QAT
HALF = hybridMode.HALF
IPP = hybridMode.IPP
UNDEFINED = hybridMode.UNDEFINED


class context:
    """Accelerator runtime lifecycle.  Nothing needs starting for a CUDA
    device, so these record the caller's choice and report state."""

    _initialized = False
    _runtime_choice = None

    @staticmethod
    def initializeContext(runtime_choice: str) -> bool:
        context._initialized = True
        context._runtime_choice = runtime_choice
        return True

    @staticmethod
    def terminateContext() -> bool:
        context._initialized = False
        context._runtime_choice = None
        return True

    @staticmethod
    def isQATRunning() -> bool:
        """True when the context is initialized and the port's default
        device is an accelerator (not the CPU)."""
        if not context._initialized:
            return False
        from ..device import get_device
        return get_device().type != "cpu"

    @staticmethod
    def isQATActive() -> bool:
        return context.isQATRunning()


_MODE_CHUNKS = {
    hybridMode.QAT: 1,
    hybridMode.OPTIMAL: 4,
    hybridMode.PREF_QAT90: 4, hybridMode.PREF_QAT80: 4,
    hybridMode.PREF_QAT70: 4, hybridMode.PREF_QAT60: 4,
    hybridMode.HALF: 2,
    hybridMode.PREF_IPP60: 8, hybridMode.PREF_IPP70: 8,
    hybridMode.PREF_IPP80: 8, hybridMode.PREF_IPP90: 8,
    hybridMode.IPP: 8,
}

_MODE_HOST_RATIO = {
    hybridMode.QAT: 0.0, hybridMode.OPTIMAL: 0.0,
    hybridMode.PREF_QAT90: 0.1, hybridMode.PREF_QAT80: 0.2,
    hybridMode.PREF_QAT70: 0.3, hybridMode.PREF_QAT60: 0.4,
    hybridMode.HALF: 0.5,
    hybridMode.PREF_IPP60: 0.6, hybridMode.PREF_IPP70: 0.7,
    hybridMode.PREF_IPP80: 0.8, hybridMode.PREF_IPP90: 0.9,
    hybridMode.IPP: 1.0,
}


class hybridControl:
    """Work-split policy: a mode sets the encrypt pipelining depth and the
    host share (module docstring); UNDEFINED leaves the config as it is."""

    _mode = hybridMode.UNDEFINED

    @staticmethod
    def setHybridMode(mode: hybridMode) -> None:
        from . import config as _config
        hybridControl._mode = hybridMode(mode)
        chunks = _MODE_CHUNKS.get(hybridControl._mode)
        if chunks is not None:
            _config.set_config(encrypt_pipeline_chunks=chunks)
        ratio = _MODE_HOST_RATIO.get(hybridControl._mode)
        if ratio is not None:
            _config.set_config(encrypt_host_ratio=ratio)

    @staticmethod
    def setHybridOff() -> None:
        hybridControl.setHybridMode(hybridMode.IPP)

    @staticmethod
    def getHybridMode() -> hybridMode:
        return hybridControl._mode
