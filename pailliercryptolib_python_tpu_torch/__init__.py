"""pailliercryptolib_python_tpu_torch -- the Paillier library on PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``pailliercryptolib_python_tpu`` (JAX/Pallas on a TPU), which
stays in the repository as its reference.  This package imports ``torch``
and never ``jax``.  Main path: keygen -> DJN encrypt (RNS comb) ->
ciphertext ``+`` / ``sum`` -> CRT decrypt, on the default device
``cuda`` (``set_device`` changes it; the CPU is used only when asked).
``context`` / ``hybridControl`` / ``hybridMode`` are the runtime controls:
a mode sets how ``encrypt`` pipelines a batch in chunks and what share of
it a host thread encrypts.

On a CUDA tensor each of the fifteen kernels (``kernels.COUNTS``)
launches or raises; on a CPU tensor its plain PyTorch twin runs.
"""

from .api import (
    PaillierKeypair,
    PaillierPublicKey,
    PaillierPrivateKey,
    PaillierEncryptedNumber,
    BNUtils,
)
from .fixedpoint import FixedPointNumber, FixedPointEndec
from .bindings.containers import (
    BigNumber,
    ipclBigNumber,
    ipclKeypair,
    ipclPublicKey,
    ipclPrivateKey,
    ipclPlainText,
    ipclCipherText,
)
from .device import get_device, set_device
from .models.paillier import from_jax_state
from .utils.config import get_config, set_config
from .utils.context import context, hybridControl, hybridMode

__version__ = "0.1.0"

__all__ = [
    "PaillierKeypair",
    "PaillierPublicKey",
    "PaillierPrivateKey",
    "PaillierEncryptedNumber",
    "BNUtils",
    "FixedPointNumber",
    "FixedPointEndec",
    "BigNumber",
    "ipclBigNumber",
    "ipclKeypair",
    "ipclPublicKey",
    "ipclPrivateKey",
    "ipclPlainText",
    "ipclCipherText",
    "from_jax_state",
    "get_device",
    "set_device",
    "get_config",
    "set_config",
    "context",
    "hybridControl",
    "hybridMode",
]
