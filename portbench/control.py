#!/usr/bin/env python3
"""The control: the plain reference in the program's place, one
precision below the configuration's (floats rounded to float32 before
they are encoded, its ciphertexts all under one obfuscator), driven
through the same cell, window and judge as a run of the program.  The
judge must find it wrong.

    python3 portbench/control.py --workload <name> --seed <n>
                                 [--requests N]

prints the run's result line, whose ``checks`` give the numbers the
control reads; the benchmark's own runs never run it.  It needs no
card: the control computes on the host.  ``--requests`` (default 16,
as many answers as a run judges of a sampled kind) ends the window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from portbench import run, traffic
    from portbench.systems import ControlSystem
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=16)
    a = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}[a.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    result = run.run_cell(a.workload, config, traffic.load(cell["traffic"]),
                          a.seed, 3600.0, False, ControlSystem, "host", [],
                          time.perf_counter(), max_requests=a.requests)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
