"""decrypt_roofline: the least chip time of the window's `decrypt` requests
(``workmodel.py``: the larger of int8 operations over 1,979 TOP/s and
bytes over 3.35 TB/s) over the device time inside those requests
(union of the trace's device activity)."""


def read(run):
    return run.roofline_pct("decrypt")
