"""A run over several ranks on the CPU: four rank processes over gloo
(``ranks.py``), the port on its plain twins, the 255-bit test key, the
``fl_sharded_x4`` mix at 16 columns a rank.  The harness's look for
cards is skipped: the test starts rank 0 as ``run.py --rank 0`` with
the run's description on stdin, as ``run.py --workload`` does for a
cell on four cards after that look.

Sound, it is correct and the ranks agree; with the control in the
program's place ``correct`` comes out false; a rank killed in the
window ends the run with exit code 1, every rank gone.  The planted
faults are ``test_portbench_multicard_faults.py``'s."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import run as R
from portbench import traffic
from portbench.systems import ControlSystem

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANKS = 4
COLUMNS = 16                               # a rank's
TIMEOUT = 120


def small_mix():
    mix = traffic.load("fl_sharded_x4")
    mix["ops"][0].update(batch=RANKS * COLUMNS)
    return mix


def run_ranks(cfg, system, tmp_path, requests=3):
    spec = {"workload": "p2048.fl_sharded_x4", "config": cfg,
            "mix": small_mix(), "seed": 2**31 + 99, "seconds": 60.0,
            "trace": 0, "metrics": [], "world": RANKS, "device": "cpu",
            "system": f"portbench.tests.multicard_systems:{system}",
            "max_requests": requests}
    env = dict(os.environ, PORTBENCH_TEST_PIDS=str(tmp_path))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "portbench/run.py", "--rank", "0"],
                         input=json.dumps(spec), text=True,
                         capture_output=True, cwd=ROOT, env=env,
                         timeout=TIMEOUT)
    return out, time.perf_counter() - t0


def result(out):
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def gone(tmp_path):
    """Every rank process that recorded itself has ended."""
    pids = [int(p) for p in os.listdir(tmp_path)]
    assert len(pids) == RANKS
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_sound_run_is_correct_and_the_ranks_agree(test_config, tmp_path):
    out, _ = run_ranks(test_config, "sound", tmp_path)
    res = result(out)
    assert res["correct"] and res["attempted"] == 3, res
    assert res["checks"]["ranks_disagree"] == {"value": 0, "limit": 0}
    assert res["device"]["count"] == RANKS
    assert list(res)[-1] == "checks"
    gone(tmp_path)


def test_control_is_not_correct(test_config):
    import torch
    torch.set_num_threads(1)
    res = R.run_cell("p2048.fl_sharded_x4", test_config, small_mix(), 11,
                     60.0, False, ControlSystem, "host", [],
                     time.perf_counter(), max_requests=2)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] == 2


def test_a_killed_rank_ends_the_run(test_config, tmp_path):
    out, seconds = run_ranks(test_config, "dies", tmp_path, requests=50)
    assert out.returncode == 1, out.stderr[-3000:]
    assert "rank 2 exited with code -9" in out.stderr
    assert not out.stdout.strip()
    assert seconds < TIMEOUT
    gone(tmp_path)
