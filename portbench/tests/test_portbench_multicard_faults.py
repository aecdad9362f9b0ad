"""A run over four ranks on the CPU, as ``test_portbench_multicard.py``
runs it, with the timed path broken underneath in the port's
``parallel.collective`` (the system factories of
``multicard_systems.py``, one a fault): ``correct`` comes out false.

Faults: a step that returns its state unchanged (the parties' combine);
half of each batch left out, the rest standing in for it (the tree);
the exchange between the ranks left out (the all-gather); the total
altered where it is produced (the fold), on rank 0, or on another rank
alone, which only ``ranks_disagree`` sees.  A JAX module loaded on a
rank other than 0 makes rank 0 exit with code 3 and print no result."""

import pytest

from portbench.tests.test_portbench_multicard import (gone, result,
                                                      run_ranks)


@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange",
                                   "altered", "altered_elsewhere"])
def test_fault_is_not_correct(test_config, tmp_path, fault):
    res = result(run_ranks(test_config, fault, tmp_path)[0])
    assert not res["correct"], (fault, res["checks"])
    wrong = res["checks"]["wrong_answers"]["value"]
    disagree = res["checks"]["ranks_disagree"]["value"]
    if fault == "altered_elsewhere":       # rank 0's answers are right
        assert (wrong, disagree) == (0, 1)
    elif fault in ("altered", "no_exchange"):   # rank 0's total its own
        assert (wrong, disagree) == (3, 3)
    else:                                  # wrong alike on every rank
        assert (wrong, disagree) == (3, 0)


def test_jax_on_another_rank_ends_the_run(test_config, tmp_path):
    out, _ = run_ranks(test_config, "jax_elsewhere", tmp_path)
    assert out.returncode == 3, out.stderr[-3000:]
    assert "jax (rank 1)" in out.stderr
    assert not out.stdout.strip()
    gone(tmp_path)
