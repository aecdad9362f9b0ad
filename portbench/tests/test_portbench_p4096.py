"""The 4096-bit key holder's cell, ``p4096.decrypt_small``: its
configuration against the port's own widths at that key, its frozen key
material against the recorded search, the plain reference's decryption
at that key, the SM-fill reader, and the cell's entries in
BENCHMARK.json.  On the card (marked ``chip``) a short run of the cell
is correct; the control at the cell's own size is not."""

import json
import math
import os
import random
import subprocess
import sys

import pytest

from portbench import keysearch, traffic
from portbench import reference as ref
from portbench import run as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "p4096.decrypt_small"
METRIC = "decrypt_sm_fill_pct"


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def config():
    conf = {c["name"]: c for c in bench()["configs"]}["paillier_4096"]
    with open(os.path.join(ROOT, conf["file"])) as f:
        return json.load(f)


def test_widths_are_the_ports(config, monkeypatch):
    """Every width in the file is what the port computes at this key, the
    comb at the card's window (12, shrunk by the budget)."""
    import torch
    from pailliercryptolib_python_tpu_torch.models import paillier as P
    from pailliercryptolib_python_tpu_torch.utils import config as C
    torch.set_num_threads(1)
    k = config["key"]
    cfg = C.get_config()
    monkeypatch.setattr(cfg, "comb_window_cpu", cfg.comb_window_tpu)
    pub = P.PublicContext(k["n"], k["bits"], True, k["hs"], k["randbits"],
                          device="cpu")
    priv = P.PrivateContext(pub, k["p"], k["q"])
    CH = pub.rns_plan()[0].CH
    n_win = -(-pub.randbits // pub.comb_window)
    assert config["widths"] == {
        "n_bits": pub.bits, "nsq_bits": 2 * pub.bits, "nsq_limbs": pub.L,
        "nsq_channels": CH,
        "half_bits": max((k["p"] ** 2).bit_length(),
                         (k["q"] ** 2).bit_length()),
        "half_limbs": priv.Lh, "half_channels": priv.rns_base.CH,
        "comb_window": pub.comb_window, "comb_windows": n_win,
        "comb_bytes": n_win * CH * (1 << pub.comb_window) * 4}
    assert (priv.rns_sched_window, len(priv.rsched_p)) == (3, 2731)


def test_key_material(config):
    k = config["key"]
    assert config["reduced"] == []
    assert k["bits"] == 4096 and k["randbits"] == 2048
    for x in (k["p"], k["q"]):
        assert x.bit_length() == 2048 and x >> 2046 == 3
        assert keysearch.is_probable_prime(x, random.Random(1), 8)
    assert k["n"] == k["p"] * k["q"] and k["n"].bit_length() == 4096
    assert math.gcd(k["n"], (k["p"] - 1) * (k["q"] - 1)) == 1
    assert config["key_search"] == {"code": "portbench/keysearch.py",
                                    "seed": 4096, "primes": "searched"}


def test_key_comes_from_the_recorded_search(config):
    """p, q and hs are what keysearch.py gives for seed 4096 (~30 s)."""
    got = keysearch.key_for(4096, config["key_search"]["seed"])
    assert {f: got[f] for f in config["key"]} == config["key"]


def test_reference_decrypts_at_this_key(config):
    """Four seeded ciphertexts decrypt to their plaintexts, the reference's
    CRT against Paillier's own L(c^lambda mod n^2) * mu mod n."""
    k = config["key"]
    key = ref.Key(k)
    n, nsq = key.n, key.nsq
    lam = math.lcm(key.p - 1, key.q - 1)
    mu = pow((pow(n + 1, lam, nsq) - 1) // n, -1, n)
    rng = random.Random(4096)
    for _ in range(4):
        m = rng.randrange(n)
        c = key.encrypt(m, key.obfuscator(rng.getrandbits(k["randbits"])))
        assert key.decrypt(c) == m
        assert (pow(c, lam, nsq) - 1) // n * mu % n == m


class _Run:
    trace = object()


def test_sm_fill_reader(monkeypatch):
    from pailliercryptolib_python_tpu_torch.utils import profiling
    read = R.load_reader(METRIC)
    counters = dict(profiling.COUNTERS)
    monkeypatch.setattr(profiling, "COUNTERS", counters)
    counters.update(sched_launches=32, sched_ctas=32 * 8,
                    sched_sm_slots=32 * 132)
    assert read(_Run()) == pytest.approx(100 * 8 / 132)
    assert round(read(_Run()), 2) == 6.06
    counters.update(sched_launches=0, sched_ctas=0, sched_sm_slots=0)
    assert read(_Run()) is None                   # no K2 launch counted
    run = _Run()
    run.trace = None
    assert read(run) is None                      # an untraced run
    monkeypatch.setattr(profiling, "COUNTERS", {"exp_columns": 1})
    assert read(_Run()) is None                   # a program without them


def test_benchmark_entries():
    b = bench()
    cell = {w["name"]: w for w in b["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "paillier_4096", "decrypt_256", 1)
    conf = {c["name"]: c for c in b["configs"]}["paillier_4096"]
    assert conf["reduced"] == [] and len(conf["source"]) <= 200
    assert os.path.exists(os.path.join(ROOT, conf["file"]))
    metric = {m["name"]: m for m in b["per_layer"]}[METRIC]
    assert metric["workloads"] == [CELL] and metric["moves"] == "values_per_s"
    assert metric["source"] == "program_counter" and metric["unit"] == "%"
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                       METRIC + ".py"))
    fours = sum(w["chips"] == 4 for w in b["workloads"])
    assert fours <= max(1, len(b["workloads"]) // 4)
    mix = traffic.load(cell["traffic"])
    (op,) = mix["ops"]
    assert (op["op"], op["batch"], op["pool"]) == ("decrypt", 256, 4)
    assert mix["traced_requests"] == 16


def _last_line(cmd, timeout):
    out = subprocess.run([sys.executable, *cmd], cwd=ROOT, text=True,
                         capture_output=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.chip
def test_cell_is_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _last_line(["portbench/run.py", "--workload", CELL, "--seed",
                      str(2**31 + 4096), "--seconds", "2", "--trace", "0"],
                     1500)
    assert res["correct"] and res["device"]["platform"] == "gpu", res


def test_control_at_the_cells_size_is_not_correct():
    res = _last_line(["portbench/control.py", "--workload", CELL, "--seed",
                      "11", "--requests", "2"], 900)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] == 2
