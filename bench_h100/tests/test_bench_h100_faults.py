"""Each fault a cell can have, planted under the timed path of a whole
run on the CPU (the look for a card skipped), makes ``correct`` false;
a JAX module in one rank's process keeps the run from printing a
result."""
import copy

import pytest

from bench_h100 import harness, spec as specs
from bench_h100.tests.cells import SMALL, TWO_RANKS

BENCH = specs.load_benchmark()
CASES = [(w, f) for w in SMALL for f in ("state_unchanged", "half_batch")]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f}" for w, f in CASES])
def test_a_planted_fault_is_not_correct(workload, fault):
    r = harness.run_cell(workload, 9, 0.1, False, "cpu", fault=fault,
                         overrides=SMALL[workload], bench=BENCH)
    assert not r["correct"], r["checks"]


def _over_two_ranks():
    over = copy.deepcopy(SMALL["gat_e.alipay_share.global"])
    over["mix"].update(TWO_RANKS)
    return over


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "no_exchange"])
def test_a_planted_fault_over_two_ranks_is_not_correct(fault):
    r = harness.run_cell("gat_e.alipay_share.global", 9, 0.1, False, "cpu",
                         fault=fault, overrides=_over_two_ranks(),
                         bench=BENCH)
    assert not r["correct"], r["checks"]


def test_jax_in_one_rank_prints_no_result(capsys):
    r = harness.run_cell("gat_e.alipay_share.global", 9, 0.1, False, "cpu",
                         fault="loads_jax", overrides=_over_two_ranks(),
                         bench=BENCH)
    assert r["forbidden"] == ["jax"]
    capsys.readouterr()
    assert harness.report(r) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
