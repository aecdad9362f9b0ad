"""exp_windows_useful_pct: of the ct*pt modexp windows the kernels ran in
the window (``mul_pt``, both routes: K5, K4), the share its exponents
needed, 100 x ``exp_windows_needed`` / ``exp_windows_run`` of the
program's counters (``utils/profiling.py`` ``COUNTERS``).  The program
counts them only while a profiler is active, and never resets them: the
reading is the traced window's work alone because a traced run is a
process of its own, with one traced window.  A second traced window in
the same process would add its counts to the first's.  None where the
program has no such counters or ran no ct*pt."""

import sys

MODULE = "pailliercryptolib_python_tpu_torch.utils.profiling"


def read(run):
    if run.trace is None:
        return None
    counters = getattr(sys.modules.get(MODULE), "COUNTERS", None)
    if not counters or not counters.get("exp_windows_run"):
        return None
    return (100.0 * counters["exp_windows_needed"]
            / counters["exp_windows_run"])
