"""Alias module: ``from ipcl_python_torch.bindings.fixedpoint import ...``
(the port's ``fixedpoint``)."""

from pailliercryptolib_python_tpu_torch.fixedpoint import (  # noqa: F401
    FixedPointNumber,
    FixedPointEndec,
)
