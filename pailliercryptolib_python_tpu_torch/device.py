"""The port's default device.

Every context and constructor takes an explicit ``device``; this module
only supplies the value used when a caller passes ``None``.  The default
is ``cuda``.  The CPU is used only when a caller or a test asks for it:
nothing here looks at ``torch.cuda.is_available()``, so a missing card
surfaces as an error at the first allocation instead of a silent move to
the CPU.
"""

from __future__ import annotations

import torch

_default = torch.device("cuda")


def set_device(device) -> torch.device:
    """Set the default device for contexts built without one."""
    global _default
    _default = torch.device(device)
    return _default


def get_device() -> torch.device:
    return _default


def resolve(device=None) -> torch.device:
    """``device`` as a torch.device, or the default when it is None."""
    return _default if device is None else torch.device(device)
