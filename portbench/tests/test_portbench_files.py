"""BENCHMARK.json, every configuration and every traffic mix parse, and
each name they use finds its file."""

import json
import math
import os
import random

import pytest

from portbench import keysearch, kinds, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name):
    conf = {c["name"]: c for c in bench()["configs"]}[name]
    with open(os.path.join(ROOT, conf["file"])) as f:
        return json.load(f)


def test_benchmark_names_and_files():
    b = bench()
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME_CHARS and len(n) <= 64, n
    confs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert w["config"] in confs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "portbench", "workloads",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "values_per_s", "request_ms_p50",
            "request_ms_p95"} <= e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py")), m["name"]
    cells = {x["name"] for x in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells)), m["name"]


@pytest.mark.parametrize("name", ["paillier_2048", "paillier_3072"])
def test_config_key_material(name):
    c = config(name)
    k = c["key"]
    assert c["reduced"] == []
    assert k["n"] == k["p"] * k["q"] and k["n"].bit_length() == k["bits"]
    assert k["randbits"] == k["bits"] // 2
    rng = random.Random(1)
    assert keysearch.is_probable_prime(k["p"], rng, 8)
    assert keysearch.is_probable_prime(k["q"], rng, 8)
    assert math.gcd(k["n"], (k["p"] - 1) * (k["q"] - 1)) == 1
    w = c["widths"]
    assert w["n_bits"] == k["bits"]
    assert w["comb_bytes"] == (w["comb_windows"] * w["nsq_channels"]
                               * (1 << w["comb_window"]) * 4)


def test_keys_come_from_the_recorded_search():
    """The frozen keys are what keysearch.py gives for the recorded seed:
    the 3072-bit primes searched, the 2048-bit DJN base derived."""
    c3 = config("paillier_3072")
    k3 = keysearch.key_for(3072, c3["key_search"]["seed"])
    assert {f: k3[f] for f in c3["key"]} == c3["key"]
    c2 = config("paillier_2048")
    k2 = keysearch.key_for(2048, c2["key_search"]["seed"],
                           c2["key"]["p"], c2["key"]["q"])
    assert {f: k2[f] for f in c2["key"]} == c2["key"]


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(os.path.join(ROOT, "portbench", "workloads"))))
def test_workload_parses(name):
    mix = traffic.load(name)
    for o in mix["ops"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "kinds",
                                           o["op"] + ".py"))
        k = kinds.load(o["op"])(o, 7, 0)
        assert k.op == o["op"]
        assert k.n_variants >= 1
        assert all(k.values(v) > 0 for v in range(k.n_variants))
    assert mix["value"] and mix["traced_requests"] > 0


def test_a_kind_is_found_by_its_file_name():
    ops = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench",
                                                         "kinds"))
                 if f.endswith(".py") and f != "__init__.py")
    assert ops == ["decrypt", "encrypt", "matmul", "sum_parties"]
    assert all(kinds.load(op).op == op for op in ops)
    with pytest.raises(ValueError):
        kinds.load("../run")
