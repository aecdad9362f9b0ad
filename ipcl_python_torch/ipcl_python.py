"""Alias module: ``from ipcl_python_torch.ipcl_python import
PaillierKeypair`` (the port's ``api``)."""

from pailliercryptolib_python_tpu_torch.api import (  # noqa: F401
    PaillierKeypair,
    PaillierPublicKey,
    PaillierPrivateKey,
    PaillierEncryptedNumber,
    BNUtils,
)
