"""The benchmark's inputs and reference against ``repro_torch`` on the
CPU, every cell at a test's size: the generators repeat from the seed
and the power-law one draws the program's degree distribution, and a
whole run of the harness (the program's first steps, the warm-up, the
window and the comparison) comes out correct, in one process and over
two ranks."""
import copy

import numpy as np
import pytest

from bench_h100 import harness, spec as specs
from bench_h100.data.powerlaw_device import powerlaw_graph_device
from bench_h100.data.sbm_device import sbm_graph_device
from bench_h100.tests.cells import SMALL, TWO_RANKS

BENCH = specs.load_benchmark()


def _undirected_and_simple(g, n):
    key = g["src"].astype(np.int64) * n + g["dst"]
    assert len(np.unique(key)) == len(key) and (g["src"] != g["dst"]).all()
    rev = set(zip(g["dst"].tolist(), g["src"].tolist()))
    assert rev == set(zip(g["src"].tolist(), g["dst"].tolist()))


@pytest.mark.parametrize("make", [
    lambda s: powerlaw_graph_device(400, 6, 7, 4, seed=s, device="cpu"),
    lambda s: sbm_graph_device(300, 5, 7, 0.3, 0.02, seed=s, device="cpu"),
], ids=["powerlaw_device", "sbm_device"])
def test_a_generator_repeats_from_the_seed(make):
    a, b, c = make(4), make(4), make(5)
    for k in ("src", "dst", "x", "y", "edge_attr", "train_mask"):
        assert (a[k] is None and b[k] is None) or np.array_equal(a[k], b[k])
    assert not np.array_equal(a["x"], c["x"])
    _undirected_and_simple(a, a["num_nodes"])


def test_powerlaw_draws_the_programs_degrees():
    """The same preferential attachment as the program's generator: the
    edge count and the in-degree's percentiles, hubs included, agree."""
    from repro_torch.graph.datasets import powerlaw_graph
    n = 50_000
    mine = powerlaw_graph_device(n, 6, 4, 4, seed=2, device="cpu")
    theirs = powerlaw_graph(n, seed=2)
    assert abs(len(mine["src"]) / len(theirs.src) - 1) < 0.01
    q = [50, 90, 99, 99.9]
    a = np.percentile(np.bincount(mine["dst"], minlength=n), q)
    b = np.percentile(np.bincount(theirs.dst, minlength=n), q)
    assert np.allclose(a, b, rtol=0.15), (a, b)
    assert 0.1 < mine["y"].mean() < 0.2 and mine["train_mask"].mean() == 0.5


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_run_on_the_cpu_is_correct(workload):
    r = harness.run_cell(workload, 7, 0.1, False, "cpu",
                         overrides=SMALL[workload], bench=BENCH)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 3 and r["failed"] == 0
    assert r["captures_in_window"] == 0 and r["forbidden"] == []
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2


def test_a_run_over_two_ranks_is_correct():
    over = copy.deepcopy(SMALL["gat_e.alipay_share.global"])
    over["mix"].update(TWO_RANKS)
    r = harness.run_cell("gat_e.alipay_share.global", 7, 0.1, False, "cpu",
                         overrides=over, bench=BENCH)
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and r["forbidden"] == []
