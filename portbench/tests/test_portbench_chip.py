"""On the card: each cell runs short and is correct; the control, at
the cell's own sizes, is not.  The chip tests skip without the cards
a cell asks for; the control needs none (it computes on the host), so
it runs everywhere."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["p2048.hetero_lr", "p3072.decrypt", "p2048.encrypt",
         "p2048.fedavg_sum", "p2048.fl_sharded_x4"]


def last_line(cmd, timeout):
    out = subprocess.run([sys.executable, *cmd], cwd=ROOT, text=True,
                         capture_output=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = {w["name"]: w["chips"] for w in json.load(
        open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]}[cell]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    res = last_line(["portbench/run.py", "--workload", cell, "--seed",
                     str(2**31 + 7), "--seconds", "2", "--trace", "0"], 1500)
    assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_sizes_is_not_correct(cell):
    res = last_line(["portbench/control.py", "--workload", cell, "--seed",
                     "11", "--requests", "2"], 900)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] == 2
    if cell == "p2048.encrypt":           # its one fixed obfuscator
        assert res["checks"]["unfresh_ciphertexts"]["value"] > 0
