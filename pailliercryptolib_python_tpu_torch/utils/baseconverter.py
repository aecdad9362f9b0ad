"""Base-conversion helpers: hexadecimal and decimal strings of big
numbers (the reference library's ``baseconverter`` surface).

Counterpart of ``pailliercryptolib_python_tpu/utils/baseconverter.py``.
"""

from __future__ import annotations


def hex2dec(hex_str: str) -> str:
    """Hexadecimal string (no 0x prefix) -> decimal string."""
    if not hex_str:
        return "0"
    return str(int(hex_str, 16))


def dec2hex(dec_str: str) -> str:
    """Decimal string -> lowercase hexadecimal string (no 0x prefix)."""
    if not dec_str:
        return "0"
    return format(int(dec_str, 10), "x")


def BN2dec(bn) -> str:
    """Decimal string of a BigNumber (or anything with .value())."""
    v = bn.value() if hasattr(bn, "value") else int(bn)
    return str(v)


def getbase(number: str, base: int) -> int:
    """Parse `number` in the given base (2..36)."""
    return int(number, base)


def getdec(number: str, base: int) -> str:
    """Render `number` (a string in `base`) as a decimal string."""
    return str(int(number, base))
