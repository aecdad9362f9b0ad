"""No module whose top-level name is jax or the JAX package
(pailliercryptolib_python_tpu, compared whole: the port's name begins
with it) is loaded by the benchmark; the reference imports nothing of
the port."""

import ast
import os
import subprocess
import sys

from portbench import run as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PB = os.path.join(ROOT, "portbench")


def imported(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_only_python_and_numpy():
    assert imported(os.path.join(PB, "reference.py")) <= {
        "__future__", "random", "numpy"}


def test_no_file_names_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                mods = imported(os.path.join(dirpath, f))
                assert not mods & set(R.FORBIDDEN), f


def test_a_run_loads_no_jax_module(test_config):
    """A whole CPU run of a cell in a fresh process, then sys.modules."""
    code = f"""
import json, sys, time
sys.path.insert(0, {ROOT!r})
from portbench import run as R, traffic
from portbench.systems import PortSystem
mix = traffic.load("fedavg_8x4096")
mix["ops"][0].update(parties=2, batch=4, pool=1)
cfg = json.load(open({os.path.join(PB, 'tests', 'data',
                                   'paillier_256.json')!r}))
res = R.run_cell("t", cfg, mix, 1, 0.2, False, PortSystem, "cpu", [],
                 time.perf_counter(), max_requests=1)
assert res["correct"], res
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "pailliercryptolib_python_tpu_torch" in loaded
    assert not loaded & set(R.FORBIDDEN)


def test_the_harness_sees_a_jax_module(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "pailliercryptolib_python_tpu.api",
                        types.ModuleType("x"))
    assert R.forbidden_modules() == ["pailliercryptolib_python_tpu"]
    monkeypatch.delitem(sys.modules, "pailliercryptolib_python_tpu.api")
    monkeypatch.setitem(sys.modules, "pailliercryptolib_python_tpu_torch_x",
                        types.ModuleType("y"))
    assert R.forbidden_modules() == []
