"""align_squarings_useful_pct: of the squarings the exponent alignment's
chain (K16, ``mm3_sqr_chain``) ran in the window, the share its shifts
needed, 100 x ``align_squarings_needed`` / ``align_squarings_run`` of the
program's counters (``utils/profiling.py`` ``COUNTERS``; a warp runs the
largest shift d among its columns, so the rest is the padding of warps
whose columns differ in d).  The program counts them only while a
profiler is active, and never resets them: the reading is the traced
window's work alone because a traced run is a process of its own, with
one traced window.  None where the program has no such counters or
aligned nothing by squaring."""

import sys

MODULE = "pailliercryptolib_python_tpu_torch.utils.profiling"


def read(run):
    if run.trace is None:
        return None
    counters = getattr(sys.modules.get(MODULE), "COUNTERS", None)
    if not counters or not counters.get("align_squarings_run"):
        return None
    return (100.0 * counters["align_squarings_needed"]
            / counters["align_squarings_run"])
