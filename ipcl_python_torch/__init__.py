"""Import alias of the PyTorch/CUDA port: ``import ipcl_python_torch``
-> ``pailliercryptolib_python_tpu_torch``.

Mirrors ``ipcl_python``'s layout and names (which point at the JAX
package) so that code written against ``ipcl_python`` switches to the
port by changing the import.  ``__version__`` is the port's ("0.1.0"),
not the reference package's ("2.0.0").  Imports ``torch``, never
``jax``.
"""

from pailliercryptolib_python_tpu_torch import (  # noqa: F401
    PaillierKeypair,
    PaillierPublicKey,
    PaillierPrivateKey,
    PaillierEncryptedNumber,
    BNUtils,
    context,
    hybridControl,
    hybridMode,
    ipclBigNumber,
    ipclKeypair,
    ipclPublicKey,
    ipclPrivateKey,
    ipclPlainText,
    ipclCipherText,
    __version__,
)
from pailliercryptolib_python_tpu_torch import api as ipcl_python  # noqa: F401
