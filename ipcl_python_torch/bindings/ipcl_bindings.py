"""Alias module mirroring ``ipcl_python.bindings.ipcl_bindings`` over the
port's containers and runtime controls."""

from pailliercryptolib_python_tpu_torch.bindings.containers import (  # noqa: F401
    ipclKeypair,
    ipclPublicKey,
    ipclPrivateKey,
    ipclPlainText,
    ipclCipherText,
    ipclBigNumber,
)
from pailliercryptolib_python_tpu_torch.utils.context import (  # noqa: F401
    context,
    hybridControl,
    hybridMode,
)
