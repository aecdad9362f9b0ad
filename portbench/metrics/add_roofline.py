"""add_roofline: the least chip time of the window's K3 add requests,
`sum_parties` and `sharded_sum` (``workmodel.py``: the larger of int8
operations over 1,979 TOP/s and bytes over 3.35 TB/s; a `sharded_sum`
counts rank 0's own work: its columns' products, its tree, the fold of
the partials), over the device time inside those requests on the traced
card (union of the trace's device activity, a collective's kernels
included)."""


def read(run):
    return run.roofline_pct("sum_parties", "sharded_sum")
