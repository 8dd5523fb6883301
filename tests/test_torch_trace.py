"""The program's counters and spans (``repro_torch.utils.trace``).

- A span adds its seconds and one call, and is a range of a running
  profile, nested in the ranges around it; the fit loop's spans cover
  each step's wait for its view, its dispatch and its loss reads.
- The one capture tally: counts made while a (faked) capture runs go to
  its tally, not to ``ops.launches`` or ``trace.counts``; each replay of
  a ``CapturedStep`` adds them once, each to the counter it was made for.
  The CPU routes count no launch.
- The exchange's bytes over two gloo ranks: one eager engine step's
  ``comm.*.bytes`` on each rank equal the payload reckoned from the
  shard plan's ``(L, P, s_pad, D)`` buffers and the gradient vector, and
  the two ranks' sum equals ``LocalComm``'s count for the same plan.
- The four-card GAT-E cell of the benchmark run small over two ranks:
  ``exchange_mb_per_step`` is the reckoned payload, to the byte, and
  ``setup.plan_s`` and ``setup.capture_s`` are read.
- On the card (``cuda``): replays of a captured engine step over
  ``LocalComm`` add the tallied bytes and launches once each, the bytes
  the eager first step sent.
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.trainer import CapturedStep
from repro_torch.kernels import ops
from repro_torch.kernels.plan import build_csc_plan
from repro_torch.launch.ranks import launch
from repro_torch.utils import trace

import torch_trace_workers as workers

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
A2A, GATHER = "comm.all_to_all.bytes", "comm.all_gather.bytes"
CELL = "gat_e.alipay_4share.global.4card"
# the four-card cell at a test's size over two ranks, one partition each
CELL_SMALL = {"cfg": {"num_nodes": 600},
              "mix": {"ranks": 2, "engine_partitions": 2, "rate_steps": 3,
                      "min_steps": 3}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def reckoned(model: str, world: int, s_pad: int, layers, params: int,
             L: int = 1) -> dict:
    """Bytes one of ``world`` ranks, ``L`` partitions each, sends in one
    training step: each exchange's (L, P, s_pad, D) float32 buffer less
    its own L rows, forward and backward (a layer exchanges its
    transform, and GAT-E its two logit halves, the softmax's max out and
    back and its two sums: ``2 * width + 5 * heads`` floats a row; GCN
    its transform and its sum, ``2 * width``); then the two reductions'
    L floats and the gradient vector gathered to the other ranks."""
    D = sum(2 * w + (5 * h if model == "gat_e" else 0) for w, h in layers)
    return {A2A: 2 * (world - 1) * L * L * s_pad * D * 4,
            GATHER: (world - 1) * (2 * L + params) * 4}


# -- spans ---------------------------------------------------------------------


def _calls(name: str) -> int:
    return trace.spans.get(name, {}).get("calls", 0)


def test_a_span_adds_its_seconds_and_one_call():
    before = dict(trace.spans.get("test.span", {"seconds": 0.0,
                                                "calls": 0}))
    for _ in range(2):
        with trace.span("test.span"):
            time.sleep(0.01)
    rec = trace.spans["test.span"]
    assert rec["calls"] == before["calls"] + 2
    assert rec["seconds"] - before["seconds"] >= 0.02


def test_a_span_is_a_nested_range_of_a_running_profile():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.outer"):
            with trace.span("test.inner"):
                torch.ones(4).sum()
    got = {e.name: e for e in prof.events()
           if e.name in ("test.outer", "test.inner")}
    assert set(got) == {"test.outer", "test.inner"}
    outer, inner = got["test.outer"].time_range, got["test.inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    # an operator-scope range: no user annotation for a device timeline
    assert not any(e.is_user_annotation for e in got.values())


def test_the_fit_loop_spans_each_step():
    from repro_torch.core.trainer import CompactTrainer
    from repro_torch.core.strategies import global_batch_view
    from repro_torch.core.views import GlobalViewStream
    from repro_torch.graph.datasets import sbm_graph
    from repro_torch.models import make_gnn
    from repro_torch.config import GNNConfig
    from repro_torch.optim import adam
    g = sbm_graph(num_nodes=120, num_classes=3, feature_dim=6, p_in=0.08,
                  p_out=0.01, seed=1).add_self_loops()
    model = make_gnn(GNNConfig(model="gcn", num_layers=2, hidden_dim=8,
                               num_classes=3, feature_dim=6), seed=0)
    names = ("step.stage_wait", "step.dispatch", "step.loss_wait",
             "plan.build")
    before = {k: _calls(k) for k in names}
    tr = CompactTrainer(model, g, adam(1e-2), device="cpu")
    tr.fit(GlobalViewStream(global_batch_view(g, 2)), steps=4)
    got = {k: _calls(k) - before[k] for k in names}
    # five waits (the last finds the stream's end), four dispatches, the
    # reads of steps 1 and 2 before steps 3 and 4, then the rest at once;
    # the graph's destination and source plans
    assert got == {"step.stage_wait": 5, "step.dispatch": 4,
                   "step.loss_wait": 3, "plan.build": 2}
    assert not hasattr(tr, "timing")


# -- the capture tally ---------------------------------------------------------


class _Graph:
    """A captured graph's stand-in: replaying it does nothing."""

    def replay(self):
        pass


def test_a_capture_tallies_and_each_replay_adds_it(monkeypatch):
    launches, counts = dict(ops.launches), dict(trace.counts)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with trace.capture_tally() as tally:
        ops._count("segment_sum")
        ops._count("segment_sum")
        trace.count(A2A, 96)
        trace.count(GATHER, 8)
    monkeypatch.undo()
    assert tally == {"segment_sum": 2, A2A: 96, GATHER: 8}
    assert ops.launches == launches and trace.counts == counts
    step = CapturedStep(_Graph(), static={}, out="out", counts=tally,
                        load=lambda static, staged: None)
    for _ in range(3):
        assert step.replay({}) == "out"
    assert ops.launches == {**launches,
                            "segment_sum": launches["segment_sum"] + 6}
    assert set(ops.launches) == set(launches)
    assert trace.counts[A2A] == counts.get(A2A, 0) + 288
    assert trace.counts[GATHER] == counts.get(GATHER, 0) + 24


def test_outside_a_capture_counts_go_straight_to_their_counters(
        monkeypatch):
    launches, counts = dict(ops.launches), dict(trace.counts)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with trace.capture_tally() as tally:      # no stream is capturing
        ops._count("edge_softmax")
        trace.count(A2A, 5)
    assert tally == {}
    assert ops.launches["edge_softmax"] == launches["edge_softmax"] + 1
    assert trace.counts[A2A] == counts.get(A2A, 0) + 5


def test_the_cpu_routes_count_no_launch(rng):
    E, N, D = 200, 30, 4
    plan = build_csc_plan(rng.integers(0, N, E), N)
    x = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32))
    before = dict(ops.launches)
    ops.segment_sum_op(x, plan)
    ops.segment_sum_bwd_op(torch.ones(N, D), plan)
    assert ops.launches == before


# -- the exchange's bytes ------------------------------------------------------


@pytest.mark.parametrize("model", ["gat_e", "gcn"])
def test_an_engine_step_counts_the_payload_each_rank_sends(model):
    outs = launch(workers.one_step, workers.P, args=(model,), device="cpu")
    for o in outs:
        assert o["sent"] == reckoned(model, workers.P, o["s_pad"],
                                     o["layers"], o["params"])
    local = workers.one_step(0, model, ranks=1)
    assert local["s_pad"] == outs[0]["s_pad"]
    assert local["sent"] == {k: outs[0]["sent"][k] + outs[1]["sent"][k]
                             for k in (A2A, GATHER)}


def test_the_four_card_cell_reads_its_exchange_and_set_up():
    from bench_h100 import harness, spec as specs
    from bench_h100.data import make_graph
    from bench_h100.program import port_graph
    from bench_h100.reference.train import param_shapes
    from repro_torch.core.partition import build_partitions
    bench = specs.load_benchmark()
    seed = 2600000123
    r = harness.run_cell(CELL, seed, 0.1, True, "cpu",
                         overrides=CELL_SMALL, bench=bench)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    c = specs.load_cell(bench, CELL, CELL_SMALL)
    cfg, mix = c["cfg"], c["mix"]
    g = port_graph(cfg, make_graph(cfg, mix, seed, torch.device("cpu")))
    plan = build_partitions(g, 2, mix["partition_method"],
                            gcn_norm=False).plan
    want = reckoned("gat_e", 2, plan.s_pad,
                    [(cfg["hidden_dim"], cfg["num_heads"])]
                    * cfg["num_layers"],
                    sum(int(np.prod(s)) for s in param_shapes(cfg).values()))
    assert abs(m["exchange_mb_per_step"] * 1e6 - sum(want.values())) < 0.5
    assert m["setup.plan_s"] > 0
    assert m["setup.capture_s"] == 0.0        # the CPU captures nothing
    assert (m["setup.plan_s"] + m["setup.capture_s"]
            <= m["setup.trainer_build_s"] + m["setup.first_steps_s"])


def test_the_four_card_cell_runs_the_workers_its_config_names():
    """The configuration's ``workers`` are the traffic's ranks, one
    partition each, and its nodes are that many workers' shares of the
    published graph."""
    from bench_h100 import spec as specs
    c = specs.load_cell(specs.load_benchmark(), CELL)
    cfg, mix = c["cfg"], c["mix"]
    pub = cfg["published"]
    assert cfg["workers"] == mix["ranks"] == mix["engine_partitions"] == 4
    assert cfg["num_nodes"] * pub["workers"] \
        == pub["num_nodes"] * cfg["workers"]
    assert set(cfg["reduced"]) == {"num_nodes", "workers"}


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2])
def test_cuda_replays_add_the_tallied_bytes_once_each(cuda, P):
    """A captured engine step over ``LocalComm``: its tally holds the
    bytes the eager first step sent, and each replay adds them, and its
    launches, once."""
    import dataclasses
    import repro_torch.api as api
    job = dataclasses.replace(workers.engine_job("gat_e", 1),
                              engine_partitions=P, device="cuda")
    trainer, views, *_ = api.make_trainer(job)
    counts = dict(trace.counts)
    trainer.fit(views, steps=1, prefetch=False)      # eager, then captured
    eager = {k: v - counts.get(k, 0) for k, v in trace.counts.items()
             if k.startswith("comm.")}
    step = trainer._graph
    assert {k: v for k, v in step.counts.items()
            if k.startswith("comm.")} == eager
    # LocalComm counts what its P partitions would send as P ranks
    assert sum(eager.values()) == P * sum(reckoned(
        "gat_e", P, trainer.plan.s_pad,
        [(layer.out_dim, layer.heads) for layer in trainer.model.layers],
        sum(p.numel() for p in trainer.params.values())).values())
    counts, launches = dict(trace.counts), dict(ops.launches)
    trainer.fit(views, steps=5, prefetch=False)
    torch.cuda.synchronize()
    for k, n in step.counts.items():
        if k in launches:
            assert ops.launches[k] == launches[k] + 5 * n, k
        else:
            assert trace.counts[k] == counts.get(k, 0) + 5 * n, k
    assert trainer.trace_counts["train_step"] == 1
