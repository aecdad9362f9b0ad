"""decrypt_sm_fill_pct: of the SM slots the decrypt chain's launches
(K2, ``rns_exp_sched``) took in the window, the share its CTAs filled,
100 x ``sched_ctas`` / ``sched_sm_slots`` of the program's counters
(``utils/profiling.py`` ``COUNTERS``; one CTA a tile of 32 columns, one
CTA an SM, ceil(CTAs / SMs) x SMs slots a launch).  The program counts
them only while a profiler is active, and never resets them: the
reading is the traced window's work alone because a traced run is a
process of its own, with one traced window.  None where the program
has no such counters or launched no K2."""

import sys

MODULE = "pailliercryptolib_python_tpu_torch.utils.profiling"


def read(run):
    if run.trace is None:
        return None
    counters = getattr(sys.modules.get(MODULE), "COUNTERS", None)
    if not counters or not counters.get("sched_sm_slots"):
        return None
    return 100.0 * counters["sched_ctas"] / counters["sched_sm_slots"]
