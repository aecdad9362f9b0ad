"""The port's user-facing surface on the CPU: the two examples
(``examples/torch_paillier_example.py`` at 256 bits, B=8, and
``examples/torch_federated_example.py`` in a world-size-1 gloo group),
the ``ipcl_python_torch`` alias against ``ipcl_python``'s names, and
``tools/torch_gen_api_docs.py``.  Neither the alias nor the docs tool
may load jax (checked in a fresh interpreter)."""

import importlib
import importlib.util
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import ipcl_python_torch
from pailliercryptolib_python_tpu_torch import get_config, get_device
from pailliercryptolib_python_tpu_torch.parallel import distributed as pdist

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
ALIAS_MODULES = ("", ".ipcl_python", ".bindings.fixedpoint",
                 ".bindings.ipcl_bindings")


def _load(rel: str):
    """A script of the repository as a module (scripts are no package)."""
    path = os.path.join(ROOT, rel)
    name = "_ex_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _public(mod) -> set:
    return {n for n in vars(mod) if not n.startswith("_")}


@pytest.fixture
def one_thread():
    """Torch on one thread: in the parallel test run the workers' intra-op
    pools oversubscribe the cores, and the plain twins' many small ops
    slow down most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_paillier_example_on_the_cpu(capsys, one_thread):
    cfg = get_config()
    before = (get_device(), cfg.encrypt_pipeline_chunks,
              cfg.encrypt_host_ratio)
    _load("examples/torch_paillier_example.py").main(
        ["--device", "cpu", "--bits", "256", "--batch", "8"])
    out = capsys.readouterr().out
    assert "FAIL" not in out and out.rstrip().endswith("all checks passed")
    assert "ipcl_python_torch 0.1.0 on cpu" in out
    # the sweep ran every hybrid mode, each round trip checked
    for mode in ipcl_python_torch.hybridMode:
        assert f"{mode.name} round trip" in out
    # the caller's default device and hybrid knobs are back
    assert (get_device(), cfg.encrypt_pipeline_chunks,
            cfg.encrypt_host_ratio) == before


def test_federated_example_in_a_gloo_group_of_one(tmp_path, capsys,
                                                 one_thread):
    assert not dist.is_initialized()
    assert pdist.initialize(init_method=f"file://{tmp_path}/store",
                            num_processes=1, process_id=0, device="cpu")
    try:
        res = _load("examples/torch_federated_example.py").main(
            ["--device", "cpu"])
        # a group the caller made stays open
        assert dist.is_initialized()
    finally:
        pdist.shutdown()
    assert not dist.is_initialized()
    assert res["world"] == 1 and res["values"] == 32
    import numpy as np
    rng = np.random.default_rng(0)
    parties = [[int(v) for v in rng.integers(0, 10**6, size=32)]
               for _ in range(3)]
    assert res["elem"] == [sum(c) for c in zip(*parties)]
    assert res["total"] == sum(sum(p) for p in parties)
    assert "totals verified" in capsys.readouterr().out


def test_federated_example_makes_its_own_group(capsys, one_thread):
    res = _load("examples/torch_federated_example.py").main(
        ["--device", "cpu", "--per-rank", "4"])
    assert not dist.is_initialized()
    assert len(res["elem"]) == 4 and res["total"] == sum(res["elem"])
    assert "totals verified" in capsys.readouterr().out


@pytest.mark.parametrize("sub", ALIAS_MODULES)
def test_alias_mirrors_ipcl_python(sub):
    ref = importlib.import_module("ipcl_python" + sub)
    port = importlib.import_module("ipcl_python_torch" + sub)
    assert _public(port) == _public(ref)
    for name in _public(port):
        obj = getattr(port, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")
                       ).startswith("pailliercryptolib_python_tpu_torch"), name


def test_alias_reports_the_ports_version():
    import pailliercryptolib_python_tpu_torch as tpt
    assert ipcl_python_torch.__version__ == tpt.__version__ == "0.1.0"
    assert ipcl_python_torch.PaillierKeypair is tpt.PaillierKeypair
    # the package's ``ipcl_python`` is the port's api module until the
    # alias module of that name is imported over it, as in ipcl_python
    assert ipcl_python_torch.ipcl_python.PaillierKeypair is \
        tpt.api.PaillierKeypair


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """One fresh interpreter: import the alias's modules, then run the
    docs tool into a temporary path; prints whether jax was loaded after
    each, and whether a JAX or XLA variable was set."""
    path = tmp_path_factory.mktemp("docs") / "API_torch.md"
    mods = ", ".join("ipcl_python_torch" + s for s in ALIAS_MODULES)
    code = (f"import os, runpy, sys, {mods}\n"
            "before = set(os.environ)\n"
            "print('jax' in sys.modules)\n"
            "runpy.run_path('tools/torch_gen_api_docs.py')['main']("
            f"['--out', {str(path)!r}])\n"
            "print('jax' in sys.modules, any(k.startswith(('JAX_', 'XLA_')) "
            "and k not in before for k in os.environ))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines(), path


def test_alias_does_not_load_jax(fresh):
    assert fresh[0][0] == "False"


def test_api_docs_cover_the_surface(fresh):
    lines, path = fresh
    assert lines[-1] == "False False"         # no jax, no JAX_* variable
    text = path.read_text()
    docs = _load("tools/torch_gen_api_docs.py")
    for modname, names in docs.SURFACE:
        assert f"## module `{modname}`" in text
        mod = importlib.import_module(modname)
        for name in names or [n for n in vars(mod) if callable(
                getattr(mod, n)) and not n.startswith("_")
                and getattr(getattr(mod, n), "__module__", "") == modname]:
            assert f"`def {name}(" in text or f"`class {name}`" in text, name
    assert "ipcl_python_torch" in text and "0.1.0" in text


def test_package_data_ships_every_kernel_source(monkeypatch):
    """An installed copy builds its kernels and sieve at first use, so
    setup.py must ship every source they read: each csrc/*.cu, each
    header they include, and native/sieve.c; and the alias package."""
    import fnmatch
    import re
    import setuptools
    seen = {}
    monkeypatch.setattr(setuptools, "setup", lambda **kw: seen.update(kw))
    monkeypatch.chdir(ROOT)
    with open(os.path.join(ROOT, "setup.py")) as f:
        exec(compile(f.read(), "setup.py", "exec"), {"__name__": "setup"})
    pkg = "pailliercryptolib_python_tpu_torch"
    pats = seen["package_data"][pkg]
    root = os.path.join(ROOT, pkg)
    need = {"native/sieve.c"}
    for name in os.listdir(os.path.join(root, "csrc")):
        need.add(f"csrc/{name}")
        with open(os.path.join(root, "csrc", name)) as f:
            need |= {f"csrc/{h}" for h in re.findall(
                r'#include "([^"]+)"', f.read())}
    assert {p for p in need if not any(fnmatch.fnmatch(p, g)
                                       for g in pats)} == set()
    assert {"ipcl_python_torch", "ipcl_python_torch.bindings",
            pkg} <= set(seen["packages"])
