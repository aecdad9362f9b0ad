"""``tools/torch_kbench.py`` on the CPU at tiny sizes: every subcommand
runs with ``--device cpu`` (each wrapper then runs its plain twin), every
variant is ok against Python's ``pow``, the variants of one function
agree limb for limb, and a variant that returns wrong limbs makes
``main`` return non-zero."""

import importlib.util
import os

import pytest
import torch

from pailliercryptolib_python_tpu_torch.ops import mont2

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "torch_kbench.py")


@pytest.fixture(scope="module")
def kb():
    spec = importlib.util.spec_from_file_location("torch_kbench", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = {
    "mul": (["mul", "--L", "17", "--B", "8", "--chain", "3"],
            ["mul_v1_cios", "mul_v2_mm", "mul_v3_byte"]),
    "sqr": (["sqr", "--L", "17", "--B", "8", "--chain", "3"],
            ["sqr_v2_as_mul", "sqr_v2_sqr", "sqr_v3_byte"]),
    "exp": (["exp", "--L", "9", "--B", "8", "--nwin", "3"],
            ["exp_v1_cios", "exp_v2_mm", "exp_v3_byte"]),
    "expshared": (["expshared", "--L", "17", "--B", "8", "--ebits", "32",
                   "--window", "5", "--variants", "v2,v3,rns,rnssched"],
                  ["expshared_v2_w5", "expshared_v3_w5",
                   "expshared_rns_w5_k21", "expsched_rns_w7_k21"]),
    "crt": (["crt", "--bits", "256", "--B", "8"], ["crt_decrypt_to_ints"]),
}


@pytest.mark.parametrize("cmd", list(CASES))
def test_subcommand_on_cpu(kb, cmd, capsys):
    argv, names = CASES[cmd]
    argv = argv + ["--device", "cpu", "--iters", "1"]
    res = kb.run(argv)
    assert list(res["variants"]) == names
    assert all(v["ok"] for v in res["variants"].values())
    assert res["agree"]
    outs = [v["out"] for v in res["variants"].values()
            if v["out"] is not None]
    if cmd != "expshared":
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
    else:                                  # the limb variants, v2 and v3
        assert torch.equal(outs[0], outs[1])
    if cmd == "crt":
        assert sorted(res["stages"]) == [
            "stage1_reduce", "stage2_rns_p_half", "stage2_rns_q_half",
            "stage3_recombine", "stage4_d2h", "stage5_to_ints"]
    printed = capsys.readouterr().out
    for n in names:
        assert f"{n}: ok=True" in printed
    assert kb.main(argv) == 0


def test_a_wrong_variant_fails_main(kb, monkeypatch, capsys):
    """The repair of the reference's run_variants, which printed FAILED
    and went on to exit 0: a variant whose limbs are wrong is reported
    ok=False and main returns 1."""
    real = mont2.mm2_mul_plain

    def wrong(a, b, wmu, wm):
        out = real(a, b, wmu, wm).clone()
        out[0] ^= 1
        return out

    monkeypatch.setattr(mont2, "mm2_mul_plain", wrong)
    argv = ["mul", "--L", "9", "--B", "4", "--chain", "2", "--device", "cpu",
            "--iters", "1"]
    assert kb.main(argv) == 1
    printed = capsys.readouterr().out
    assert "mul_v2_mm: ok=False" in printed
    assert "mul_v1_cios: ok=True" in printed


@pytest.mark.parametrize("argv", [
    ["mul", "--L", "9", "--B", "8", "--chain", "2"],
    ["exp", "--L", "9", "--B", "8", "--nwin", "2"],
])
def test_a_single_variant_wrong_in_its_last_column_fails_main(
        kb, monkeypatch, capsys, argv):
    """With one variant there is no second one to disagree with: the
    oracle alone must catch a wrong column, the last one included."""
    real = mont2.mm2_mul_plain

    def wrong(a, b, wmu, wm):
        out = real(a, b, wmu, wm).clone()
        out[0, -1] ^= 1
        return out

    monkeypatch.setattr(mont2, "mm2_mul_plain", wrong)
    assert kb.main(argv + ["--variants", "v2", "--device", "cpu",
                           "--iters", "1"]) == 1
    assert ": ok=False" in capsys.readouterr().out


def test_sample_cols_spans_the_batch(kb):
    assert kb.sample_cols(8) == list(range(8))
    cols = kb.sample_cols(4096)
    assert len(cols) == 64 and cols[0] == 0 and cols[-1] == 4095
    assert cols == sorted(set(cols)) and cols == kb.sample_cols(4096)


def test_default_device_is_cuda(kb):
    assert kb.parse(["mul"]).device == "cuda"


def test_imports_nothing_of_jax():
    """The microbench imports torch and the port, never JAX or the JAX
    package (its docstring may name the reference's tools/kbench.py)."""
    import ast
    tree = ast.parse(open(_PATH).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    roots = {m.split(".")[0] for m in mods}
    assert "jax" not in roots and "pailliercryptolib_python_tpu" not in roots
    assert "pailliercryptolib_python_tpu_torch" in roots
