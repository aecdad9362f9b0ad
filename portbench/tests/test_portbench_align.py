"""The reader of ``align_squarings_useful_pct`` (the alignment's squaring
chain, K16: the squarings its shifts needed over those its warps ran)
and its entry in BENCHMARK.json."""

import json
import os

import pytest

from portbench import run as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRIC = "align_squarings_useful_pct"


class _Run:
    trace = object()


def test_reader(monkeypatch):
    from pailliercryptolib_python_tpu_torch.utils import profiling
    read = R.load_reader(METRIC)
    counters = dict(profiling.COUNTERS)
    monkeypatch.setattr(profiling, "COUNTERS", counters)
    counters.update(align_launches=1, align_columns=7,
                    align_squarings_needed=22, align_squarings_run=34)
    assert read(_Run()) == pytest.approx(100 * 22 / 34)
    counters.update(align_squarings_needed=0, align_squarings_run=0)
    assert read(_Run()) is None                   # nothing aligned
    run = _Run()
    run.trace = None
    assert read(run) is None                      # an untraced run
    monkeypatch.setattr(profiling, "COUNTERS", {"exp_columns": 1})
    assert read(_Run()) is None                   # a program without them


def test_benchmark_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    metric = {m["name"]: m for m in b["per_layer"]}[METRIC]
    assert metric == {"name": METRIC, "unit": "%", "better": "higher",
                      "source": "program_counter",
                      "layer": "kernels.py and ops wrappers",
                      "moves": "values_per_s",
                      "workloads": ["p2048.fedavg_sum", "p2048.hetero_lr"]}
    cells = {w["name"] for w in b["workloads"]}
    assert set(metric["workloads"]) <= cells
