"""The port's fault-tolerant runtime (``repro_torch.runtime`` and the
runtime parts of ``CompactTrainer``), on the CPU.

The load-bearing contract is the reference's: view i is a pure function
of ``(seed, i)`` and every supervised unit is retried whole, so the loss
trajectory is bit for bit the same for any prefetch worker count, in
thread and in process mode, with prefetch off, and under injected faults
(killed workers and sampler processes, failed builds, stagings, steps and
saves, hung samplers, corrupted shared-memory slots). Divergence recovery
changes the trajectory by design; it is checked for what it restores.

The JAX package is the oracle where one is named: the injector's
decisions and the backoff, and the fault-free trajectory (within
``TRAIN_TOL`` of the JAX ``CompactTrainer`` on the same views and initial
parameters). Those tests import it inside, so that the ``cuda`` twins at
the end can run where JAX is not installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_runtime.py
"""
import multiprocessing
import operator
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint_steps, latest_step
from repro_torch.config import GNNConfig
from repro_torch.core.strategies import strategy_views
from repro_torch.core.trainer import CompactTrainer
from repro_torch.graph.datasets import sbm_graph
from repro_torch.models import make_gnn
from repro_torch.optim import adam
from repro_torch.runtime import (DivergenceError, FaultInjector, FaultPolicy,
                                 FaultRetriesExceeded, InjectedFault,
                                 PrefetchShutdownError, ProcessViewService,
                                 Retrier, StepTimeoutError, StreamPrefetcher,
                                 TransientError, ViewPrefetcher,
                                 sync_with_timeout)
from repro_torch.runtime import procpool
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TRAIN_TOL = 1e-4
# no real sleeping between retries
FAST = dict(backoff_base=0.0, backoff_cap=0.0, jitter=0.0)
# the reference's chaos plan (tests/test_faults.py): a killed worker,
# failed view builds, a failed device staging, a failed checkpoint save
CHAOS_PLAN = {
    "worker_kill": {1},
    "view_build": {0, 2},
    "device_put": {0},
    "checkpoint_save": {0},
}
VIEW_FIELDS = ("nodes", "hop_offsets", "src_local", "dst_local", "edge_ids",
               "loss_local")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def g():
    return sbm_graph(num_nodes=160, num_classes=4, feature_dim=8,
                     p_in=0.05, p_out=0.005, seed=0).add_self_loops()


CFG = dict(model="gcn", num_layers=2, hidden_dim=16, num_classes=4,
           feature_dim=8)


def _trainer(g, backend="csc", params=None, device="cpu", plan=None,
             policy_kw=None, hang_seconds=0.5, **kw):
    if plan is not None or policy_kw is not None:
        kw["fault_policy"] = FaultPolicy(**{**FAST, **(policy_kw or {})})
    if plan is not None:
        kw["injector"] = FaultInjector(plan, seed=0,
                                       hang_seconds=hang_seconds)
    model = make_gnn(GNNConfig(**CFG, aggregate_backend=backend), seed=0)
    return CompactTrainer(model, g, adam(1e-2), params=params,
                          device=device, **kw)


def _views(g, seed=0):
    return strategy_views(g, "mini", K=2, seed=seed, batch_nodes=24,
                          compact=True)


def _state(tr):
    return {k: p.detach().cpu().clone() for k, p in tr.params.items()}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _no_children():
    deadline = time.monotonic() + 5.0
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    return multiprocessing.active_children() == []


# -- faults: policy, injector, retrier ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_injector_and_backoff_take_the_references_decisions(seed):
    pytest.importorskip("jax")
    from repro.runtime.faults import FaultInjector as JaxInjector
    from repro.runtime.faults import FaultPolicy as JaxPolicy
    points = FaultInjector.POINTS
    plans = [{p: 0.3 for p in points}, {p: {1, 4, 9} for p in points}]
    for plan in plans:
        mine = FaultInjector(plan, seed=seed)
        ref = JaxInjector(plan, seed=seed)
        for p in points:
            assert [mine.fires(p, key=k) for k in range(40)] \
                == [ref.fires(p, key=k) for k in range(40)], p
            assert [mine.fires(p) for _ in range(40)] \
                == [ref.fires(p) for _ in range(40)], p
        assert mine.fired == ref.fired
    kw = dict(backoff_base=0.1, backoff_factor=2.0, backoff_cap=0.7,
              jitter=0.25, seed=seed)
    for stage in ("view_build", "step", "checkpoint_save"):
        assert [FaultPolicy(**kw).delay(stage, a) for a in range(8)] \
            == [JaxPolicy(**kw).delay(stage, a) for a in range(8)]


def _backoff_capped():
    p = FaultPolicy(backoff_base=0.1, backoff_factor=2.0, backoff_cap=0.3,
                    jitter=0.1, seed=7)
    d = [p.delay("s", a) for a in range(6)]
    assert d == [p.delay("s", a) for a in range(6)]
    assert all(x <= 0.3 * 1.1 + 1e-9 for x in d)
    assert d[1] > d[0] * 0.8


def _bad_divergence_action():
    with pytest.raises(ValueError, match="on_divergence"):
        FaultPolicy(on_divergence="explode")


def _unknown_point():
    with pytest.raises(ValueError, match="unknown injection point"):
        FaultInjector({"bogus": {0}})


def _occurrences_and_keys():
    inj = FaultInjector({"view_build": {1, 3}}, seed=0)
    assert [inj.fires("view_build") for _ in range(5)] \
        == [False, True, False, True, False]
    inj2 = FaultInjector({"view_build": {1, 3}}, seed=0)
    assert [inj2.fires("view_build", key=k) for k in (3, 0, 1)] \
        == [True, False, True]
    assert sorted(inj2.fired["view_build"]) == [1, 3]


def _rate_mode():
    a = FaultInjector({"step": 0.5}, seed=1)
    b = FaultInjector({"step": 0.5}, seed=1)
    assert [a.fires("step") for _ in range(64)] \
        == [b.fires("step") for _ in range(64)]
    assert 0 < a.total_fired() < 64


def _retries_transients():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("flake")
        return "ok"

    rt = Retrier(FaultPolicy(max_retries=3, **FAST))
    assert rt("stage", flaky) == "ok" and len(calls) == 3
    assert [e["stage"] for e in rt.events] == ["stage", "stage"]


def _exhaustion_is_typed():
    def always():
        raise TransientError("nope")

    with pytest.raises(FaultRetriesExceeded, match="3 consecutive"):
        Retrier(FaultPolicy(max_retries=2, **FAST))("stage", always)


def _no_retry_of_bugs():
    calls = []

    def broken():
        calls.append(1)
        raise KeyError("bug")

    with pytest.raises(KeyError):
        Retrier(FaultPolicy(max_retries=3, **FAST))("stage", broken)
    assert len(calls) == 1


def _keyed_injection_fires_once():
    inj = FaultInjector({"view_build": {5}})
    rt = Retrier(FaultPolicy(max_retries=2, **FAST), inj)
    assert rt("view_build", lambda: "v5", key=5) == "v5"
    assert inj.fired["view_build"] == [5]
    with pytest.raises(FaultRetriesExceeded) as ei:
        Retrier(FaultPolicy(max_retries=0, **FAST),
                FaultInjector({"view_build": {5}}))(
            "view_build", lambda: "v5", key=5)
    assert isinstance(ei.value.__cause__, InjectedFault)


def _sync_with_timeout():
    assert sync_with_timeout(lambda: 3.5, None) == 3.5
    assert sync_with_timeout(lambda: 3.5, 5.0) == 3.5
    with pytest.raises(StepTimeoutError):
        sync_with_timeout(lambda: time.sleep(10) or 0.0, 0.05)
    with pytest.raises(RuntimeError, match="boom"):
        sync_with_timeout(lambda: (_ for _ in ()).throw(
            RuntimeError("boom")), 5.0)


@pytest.mark.parametrize("check", [
    _backoff_capped, _bad_divergence_action, _unknown_point,
    _occurrences_and_keys, _rate_mode, _retries_transients,
    _exhaustion_is_typed, _no_retry_of_bugs, _keyed_injection_fires_once,
    _sync_with_timeout], ids=lambda f: f.__name__.lstrip("_"))
def test_policy_injector_and_retrier(check):
    check()


# -- supervised prefetchers -----------------------------------------------------


def test_view_prefetcher_close_joins_and_raises_on_a_stuck_thread():
    pf = ViewPrefetcher(iter(range(100)), lambda v: v, depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    release = threading.Event()

    def prepare(v):
        if v == 1:
            release.wait(30)      # blocking code close() cannot cancel
        return v

    pf = ViewPrefetcher(iter(range(10)), prepare, depth=1)
    assert next(pf) == 0
    with pytest.raises(PrefetchShutdownError, match="still alive"):
        pf.close(timeout=0.3)
    release.set()


def test_stream_prefetcher_respawns_killed_workers_in_order(g):
    inj = FaultInjector({"worker_kill": {1, 3}})
    rt = Retrier(FaultPolicy(max_retries=2, **FAST), inj)
    pf = StreamPrefetcher(_views(g), lambda v: np.array(v.loss_local),
                          steps=8, workers=3, runtime=rt)
    got = list(pf)
    pf.close()
    ref = [np.array(_views(g).build(i).loss_local) for i in range(8)]
    assert len(got) == 8
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert sorted(inj.fired["worker_kill"]) == [1, 3]
    assert all(not t.is_alive() for t in pf._threads)


def test_stream_prefetcher_respawn_cap_aborts(g):
    rt = Retrier(FaultPolicy(max_worker_respawns=2, **FAST),
                 FaultInjector({"worker_kill": 0.999}))
    pf = StreamPrefetcher(_views(g), lambda v: v, steps=8, workers=2,
                          runtime=rt)
    with pytest.raises(RuntimeError, match="max_worker_respawns"):
        list(pf)
    pf.close()


def test_stream_prefetcher_hang_is_reassigned_by_the_watchdog(g):
    inj = FaultInjector({"view_hang": {2}}, hang_seconds=10.0)
    rt = Retrier(FaultPolicy(timeouts={"view_build": 0.2}, **FAST), inj)
    pf = StreamPrefetcher(_views(g), lambda v: np.array(v.loss_local),
                          steps=6, workers=2, runtime=rt)
    assert len(list(pf)) == 6
    assert inj.fired["view_hang"] == [2]
    pf.close()
    pf = StreamPrefetcher(_views(g), lambda v: v, steps=64, workers=4)
    next(pf)
    pf.close()
    assert all(not t.is_alive() for t in pf._threads)


# -- the chaos contract ----------------------------------------------------------


def _jax_oracle(backend: str, steps: int):
    """The JAX CompactTrainer's losses over the reference's views of the
    same graph, and its initial params as a ``state_dict``."""
    pytest.importorskip("jax")
    import jax
    from repro.config import GNNConfig as JaxConfig
    from repro.core.strategies import strategy_views as jax_views
    from repro.core.trainer import CompactTrainer as JaxTrainer
    from repro.graph import sbm_graph as jax_sbm
    from repro.models import make_gnn as jax_make_gnn
    from repro.optim import adam as jax_adam
    jg = jax_sbm(num_nodes=160, num_classes=4, feature_dim=8, p_in=0.05,
                 p_out=0.005, seed=0).add_self_loops()
    model = jax_make_gnn(JaxConfig(**CFG, aggregate_backend=backend))
    params = model.init(jax.random.PRNGKey(0), 8)
    init = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tr = JaxTrainer(model, jg, jax_adam(1e-2), params=params)
    views = jax_views(jg, "mini", K=2, seed=0, batch_nodes=24, compact=True)
    return tr.fit(views, steps=steps, prefetch=False)["losses"], init


@pytest.mark.parametrize("backend", ["reference", "csc"])
def test_chaos_trajectory_is_bitwise_the_fault_free_run(g, tmp_path,
                                                        backend):
    want, init = _jax_oracle(backend, 8)
    base = _trainer(g, backend, params=init)
    ref = base.fit(_views(g), steps=8, prefetch_workers=3)["losses"]
    tr = _trainer(g, backend, params=init, plan=CHAOS_PLAN)
    got = tr.fit(_views(g), steps=8, prefetch_workers=3,
                 checkpoint_dir=str(tmp_path), checkpoint_every=3)["losses"]
    fired = tr.runtime.injector.fired
    assert tr.runtime.injector.total_fired() >= 3, fired
    assert {"worker_kill", "view_build", "device_put",
            "checkpoint_save"} <= set(fired)
    assert got == ref
    assert _same(_state(tr), _state(base))
    np.testing.assert_allclose(ref, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    tr.assert_trace_contract()


@pytest.mark.parametrize("mode,workers", [
    ("thread", 1), ("thread", 2), ("thread", 3), ("process", 2)])
def test_modes_and_worker_counts_are_bitwise_equal(g, mode, workers):
    base = _trainer(g)
    ref = base.fit(_views(g), steps=6, prefetch=False)["losses"]
    tr = _trainer(g)
    got = tr.fit(_views(g), steps=6, prefetch_workers=workers,
                 prefetch_mode=mode)["losses"]
    assert got == ref
    assert _same(_state(tr), _state(base))
    assert _no_children()


@pytest.mark.parametrize("strategy", ["mini", "cluster"])
def test_process_mode_dense_streams_are_bitwise_inline(g, strategy):
    """Sampler processes ship dense mask views (the ``"dense"`` payload)
    that train bitwise as inline staging's, and hand back the stream's
    own masks."""
    def views():
        return strategy_views(g, strategy, K=2, seed=0, batch_nodes=24,
                              clusters_per_batch=3, halo_hops=1)

    base = _trainer(g)
    ref = base.fit(views(), steps=5, prefetch=False)["losses"]
    tr, stream = _trainer(g), views()
    got = tr.fit(stream, steps=5, prefetch_workers=2,
                 prefetch_mode="process")["losses"]
    assert got == ref and stream.cursor == 5
    assert _same(_state(tr), _state(base))
    assert tr.buckets_touched == {(g.num_nodes, g.num_edges)}
    svc = ProcessViewService(views(), lambda v: v, 3, workers=2)
    try:
        shipped = list(svc)
    finally:
        svc.close()
    for i, v in enumerate(shipped):
        want = views().build(i)
        for f in ("node_active", "edge_active", "loss_mask"):
            assert np.array_equal(getattr(v, f), getattr(want, f)), (i, f)
        assert v.meta == want.meta
    assert _no_children()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_cursor_counts_the_views_consumed(g, mode):
    """Two back-to-back fits on one stream (1 step, then 5) are the one
    6-step fit: the cursor after the first counts the view consumed, not
    those the workers built ahead."""
    ref = _trainer(g).fit(_views(g), steps=6, prefetch=False)["losses"]
    tr, stream = _trainer(g), _views(g)
    got = tr.fit(stream, steps=1, prefetch_workers=2,
                 prefetch_mode=mode)["losses"]
    assert stream.cursor == 1
    got += tr.fit(stream, steps=5, prefetch_workers=2,
                  prefetch_mode=mode)["losses"]
    assert stream.cursor == 6 and tr.view_cursor == 6
    assert got == ref
    assert _no_children()


# -- divergence, rollback, resume --------------------------------------------------


def test_divergence_raise_restores_the_prestep_state(g):
    tr = _trainer(g, plan={"diverge": {2}}, policy_kw={"check_finite": True})
    ref = _trainer(g)
    ref.fit(_views(g), steps=2, prefetch=False)
    with pytest.raises(DivergenceError, match="non-finite"):
        tr.fit(_views(g), steps=6)
    assert tr.step_num == 2 and tr.opt_state["step"] == 2
    assert _same(_state(tr), _state(ref))


@pytest.mark.parametrize("action", ["skip_view", "rollback"])
def test_recovery_equals_a_run_that_never_saw_the_poison_view(
        g, tmp_path, action):
    """diverge at view 4: skip_view undoes the update, rollback restores
    the step-4 checkpoint; either way the result is, bit for bit, a run
    over views 0-3 and 5-7."""
    tr = _trainer(g, plan={"diverge": {4}},
                  policy_kw={"on_divergence": action})
    out = tr.fit(_views(g), steps=8, checkpoint_dir=str(tmp_path),
                 checkpoint_every=2)
    ev = [e for e in out["events"] if e.get("stage") == "diverge"]
    assert len(ev) == 1 and ev[0]["action"] == action
    assert all(np.isfinite(out["losses"]))
    assert tr.step_num == 7 and len(out["losses"]) == 7
    clean, stream = _trainer(g), _views(g)
    want = clean.fit(stream, steps=4, prefetch=False)["losses"]
    stream.seek(5)
    want += clean.fit(stream, steps=3, prefetch=False)["losses"]
    assert out["losses"] == want
    assert _same(_state(tr), _state(clean))
    assert clean.opt_state["step"] == tr.opt_state["step"] == 7
    tr.assert_trace_contract()


def test_skip_view_writes_the_snapshot_into_the_live_parameters(g):
    """The optimizer updates in place: after skip_view the model's own
    parameters (not a rebound dict) hold the pre-step values."""
    tr = _trainer(g, plan={"diverge": {2}},
                  policy_kw={"on_divergence": "skip_view"})
    live = list(tr.model.parameters())
    ids = [id(p) for p in live]
    tr.fit(_views(g), steps=3, prefetch=False)
    ref = _trainer(g)
    ref.fit(_views(g), steps=2, prefetch=False)
    assert [id(p) for p in tr.model.parameters()] == ids
    for p, q in zip(live, ref.model.parameters()):
        assert torch.equal(p.detach(), q.detach())
    for k in ("m", "v"):
        assert _same(tr.opt_state[k], ref.opt_state[k])


def test_rollback_without_a_checkpoint_raises(g):
    tr = _trainer(g, plan={"diverge": {1}},
                  policy_kw={"on_divergence": "rollback"})
    with pytest.raises(DivergenceError, match="no valid checkpoint"):
        tr.fit(_views(g), steps=4)


def test_rollback_walks_past_a_truncated_newest_checkpoint(g, tmp_path):
    seeder = _trainer(g, policy_kw={})
    seeder.fit(_views(g), steps=5, checkpoint_dir=str(tmp_path),
               checkpoint_every=2)
    assert checkpoint_steps(str(tmp_path)) == [2, 4]
    newest = tmp_path / "step_00000004.npz"
    newest.write_bytes(newest.read_bytes()[:-40])
    tr = _trainer(g, plan={"diverge": {1}},
                  policy_kw={"on_divergence": "rollback"})
    out = tr.fit(_views(g), steps=4, checkpoint_dir=str(tmp_path))
    assert len([e for e in out["events"] if e["stage"] == "diverge"]) == 1
    # restored step 2 (step 4 fails its checksum), then 2 more views
    assert tr.step_num == 4
    assert all(np.isfinite(out["losses"]))


def test_resume_restores_the_newest_valid_and_moves_the_stream(g, tmp_path):
    tr = _trainer(g, policy_kw={})
    full = tr.fit(_views(g), steps=6, checkpoint_dir=str(tmp_path),
                  checkpoint_every=3)["losses"]
    ref = _trainer(g)
    want = ref.fit(_views(g), steps=8, prefetch=False)["losses"]
    assert full == want[:6] and tr.view_cursor == 6
    tr2, stream2 = _trainer(g, policy_kw={}), _views(g)
    out = tr2.fit(stream2, steps=2, checkpoint_dir=str(tmp_path),
                  resume=True)
    assert tr2.step_num == 8 and stream2.cursor == 8
    assert out["losses"] == want[6:]
    assert _same(_state(tr2), _state(ref))


def test_resume_with_an_empty_dir_is_a_fresh_start(g, tmp_path):
    tr = _trainer(g, policy_kw={})
    out = tr.fit(_views(g), steps=3, checkpoint_dir=str(tmp_path),
                 resume=True)
    assert tr.step_num == 3 and len(out["losses"]) == 3


def test_no_policy_means_no_runtime_and_reset_starts_over(g):
    tr = _trainer(g)
    assert tr.runtime is None
    first = tr.fit(_views(g), steps=3)
    assert first["events"] == []
    tr.reset()
    assert tr.step_num == 0 and tr.opt_state["step"] == 0
    assert tr.fit(_views(g), steps=3)["losses"] == first["losses"]
    with pytest.raises(ValueError, match="prefetch_mode"):
        tr.fit(_views(g), steps=1, prefetch_mode="fibers")


# -- sampler processes ------------------------------------------------------------


def test_service_emits_the_streams_views_and_tracks_its_cursor(g):
    stream = _views(g)
    svc = ProcessViewService(stream, lambda v: v, 6, workers=2)
    try:
        assert stream.cursor == 0
        got = [next(svc)]
        assert stream.cursor == 1    # the cursor counts emitted views
        got += list(svc)
        assert stream.cursor == 6
    finally:
        svc.close()
    ref = _views(g)
    for i, v in enumerate(got):
        want = ref.build(i)
        for f in VIEW_FIELDS:
            assert np.array_equal(getattr(v, f), getattr(want, f)), (i, f)
    assert _no_children()


@pytest.mark.parametrize("point,policy_kw,hang", [
    ("proc_kill", {}, 0.5),
    ("proc_hang", {"worker_heartbeat_s": 0.6}, 30.0),
    ("slot_corrupt", {}, 0.5),
])
def test_sampler_faults_recover_bitwise(g, point, policy_kw, hang):
    ref = _trainer(g).fit(_views(g), steps=6, prefetch=False)["losses"]
    t0 = time.monotonic()
    tr = _trainer(g, plan={point: {1}}, policy_kw=policy_kw,
                  hang_seconds=hang)
    out = tr.fit(_views(g), steps=6, prefetch_workers=2,
                 prefetch_mode="process")
    # a hung sampler is killed by the watchdog, not waited out
    assert time.monotonic() - t0 < 25.0
    assert out["losses"] == ref
    ev = [e for e in out["events"] if e.get("stage") == point]
    assert ev and tr.runtime.injector.fired[point] == [1]
    if point == "slot_corrupt":
        assert ev[0]["view"] == 1 and "crc" in ev[0]["error"]
    assert _no_children()


class _StreamThatDiesInASampler:
    """A stream whose pickle raises when loaded: a sampler that gets it
    dies at start (the parent only copies and pickles it)."""

    def __init__(self, stream):
        self.__dict__.update(stream.__dict__)

    def __copy__(self):
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        return new

    def __reduce__(self):
        return operator.truediv, (1, 0)


def test_samplers_that_die_at_start_fail_the_pool(g):
    """A sampler that dies while it starts (here: its stream fails to
    unpickle) is respawned up to the cap, then the pool fails with a
    typed error and leaves no process behind."""
    stream = _StreamThatDiesInASampler(_views(g))
    rt = Retrier(FaultPolicy(max_proc_respawns=1, **FAST))
    t0 = time.monotonic()
    svc = ProcessViewService(stream, lambda v: v, 4, workers=2, runtime=rt)
    try:
        with pytest.raises(FaultRetriesExceeded, match="max_proc_respawns"):
            list(svc)
    finally:
        svc.close()
    assert time.monotonic() - t0 < 120
    assert _no_children()


def test_sampler_respawn_cap_raises_typed(g):
    with pytest.raises(FaultRetriesExceeded):
        _trainer(g, plan={"proc_kill": {0, 1, 2}},
                 policy_kw={"max_proc_respawns": 1}).fit(
            _views(g), steps=6, prefetch_workers=2, prefetch_mode="process")
    assert _no_children()


@pytest.mark.parametrize("plan", [{"proc_kill": {1}}, {"proc_hang": {1}},
                                  {"slot_corrupt": {1}}],
                         ids=lambda p: next(iter(p)))
def test_thread_mode_analogs_fire_and_recover(g, plan):
    ref = _trainer(g).fit(_views(g), steps=6, prefetch=False)["losses"]
    tr = _trainer(g, plan=plan, hang_seconds=0.2)
    out = tr.fit(_views(g), steps=6, prefetch_workers=2)
    assert out["losses"] == ref
    assert tr.runtime.injector.total_fired() > 0


def test_process_mode_degrades_to_threads_with_one_warning(g, monkeypatch):
    ref = _trainer(g).fit(_views(g), steps=4, prefetch=False)["losses"]
    monkeypatch.setattr(procpool, "shared_memory_available", lambda: False)
    monkeypatch.setattr(procpool, "_DEGRADE_WARNED", False)
    with pytest.warns(RuntimeWarning, match="degrading"):
        out = _trainer(g).fit(_views(g), steps=4, prefetch_mode="process")
    assert out["losses"] == ref
    out = _trainer(g).fit(_views(g), steps=4, prefetch_mode="process")
    assert out["losses"] == ref


def _marked_pids(marker: str) -> set:
    """Pids of live processes whose environment carries ``marker`` (the
    CLI's sampler processes inherit it)."""
    pids = set()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker.encode() in f.read():
                    pids.add(int(pid))
        except OSError:
            continue
    return pids


def test_sigterm_saves_a_checkpoint_and_resumes(tmp_path):
    """SIGTERM mid-fit: the CLI retires its sampler processes, saves a
    checkpoint and exits 128 + 15; ``--resume`` picks the run back up."""
    if not os.path.isdir("/proc"):
        pytest.skip("finding orphaned samplers needs /proc")
    ck = tmp_path / "ck"
    marker = f"REPRO_TORCH_DRILL={uuid.uuid4().hex}"
    key, value = marker.split("=")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **{key: value})
    args = [sys.executable, "-m", "repro_torch.launch.train", "gnn",
            "--dataset", "cora", "--strategy", "mini", "--compact",
            "--hidden", "16", "--steps", "5000", "--prefetch-mode",
            "process", "--prefetch-workers", "2", "--checkpoint-dir",
            str(ck), "--checkpoint-every", "5", "--device", "cpu"]
    proc = subprocess.Popen(args, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 240
        while (time.monotonic() < deadline and proc.poll() is None
               and not any(ck.glob("step_*.npz"))):
            time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1][-2000:]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 128 + signal.SIGTERM, (out, err[-2000:])
    assert "interrupted by signal" in err
    step = latest_step(str(ck))      # the interrupt's own save
    assert step is not None and step >= 5
    deadline = time.monotonic() + 10
    while _marked_pids(marker) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _marked_pids(marker), "orphaned sampler processes"
    resumed = subprocess.run(
        args[:args.index("--steps") + 1] + ["3"]
        + args[args.index("--steps") + 2:] + ["--resume"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert f"at step {step + 3} " in resumed.stdout


class _SignalledAfterFirst(dict):
    """Parameters whose iteration delivers SIGTERM once the optimizer has
    updated the first of them, in the middle of its in-place loop."""

    def items(self):
        for i, item in enumerate(super().items()):
            if i == 1:
                signal.raise_signal(signal.SIGTERM)
            yield item


def test_a_signal_inside_the_optimizer_stops_after_the_step(g, tmp_path,
                                                            monkeypatch):
    """SIGTERM lands between two parameters' updates of step 3. The CLI's
    handler lets the step finish, fit stops at the boundary, api.train
    saves step 3 whole, and the resumed run is bitwise the uninterrupted
    one: a checkpoint never holds a half-applied step."""
    import dataclasses
    from repro_torch import api, optim
    from repro_torch.launch.train import stop_between_steps_on_signals
    from repro_torch.runtime import TrainingInterrupted

    def job(**kw):
        return api.TrainJob(dataset=g, model="gcn", strategy="mini",
                            compact=True, hidden=16, batch_nodes=24,
                            eval_every=1, log_every=0, device="cpu", **kw)

    want = api.train(job(steps=6))
    real = optim.adam

    def adam(*a, **kw):
        opt, calls = real(*a, **kw), []

        def update(grads, state, params):
            calls.append(1)
            if len(calls) == 3:
                params = _SignalledAfterFirst(params)
            return opt.update(grads, state, params)
        return dataclasses.replace(opt, update=update)

    monkeypatch.setattr(optim, "adam", adam)
    ck = str(tmp_path)
    with pytest.raises(TrainingInterrupted) as e, \
            stop_between_steps_on_signals():
        api.train(job(steps=6, checkpoint_dir=ck))
    assert e.value.signum == signal.SIGTERM
    assert checkpoint_steps(ck) == [3]
    monkeypatch.setattr(optim, "adam", real)
    got = api.train(job(steps=3, checkpoint_dir=ck, resume=True))
    assert got.trainer.step_num == 6
    assert ([h["loss"] for h in got.history]
            == [h["loss"] for h in want.history][3:])
    assert _same(got.params, want.params)


def test_a_second_signal_stops_at_once_and_none_outlives_the_block():
    from repro_torch.launch.train import stop_between_steps_on_signals
    from repro_torch.runtime import take_interrupt
    with stop_between_steps_on_signals():
        signal.raise_signal(signal.SIGTERM)     # a request, no raise
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGTERM)
    assert take_interrupt() is None


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_modes_workers_and_chaos_are_bitwise_equal(g, cuda, tmp_path):
    base = _trainer(g, device=cuda)
    ref = base.fit(_views(g), steps=8, prefetch=False)["losses"]
    runs = [dict(prefetch_workers=1), dict(prefetch_workers=3),
            dict(prefetch_workers=2, prefetch_mode="process")]
    for kw in runs:
        tr = _trainer(g, device=cuda)
        assert tr.fit(_views(g), steps=8, **kw)["losses"] == ref, kw
        assert _same(_state(tr), _state(base)), kw
    tr = _trainer(g, device=cuda, plan={**CHAOS_PLAN, "proc_kill": {3}})
    got = tr.fit(_views(g), steps=8, prefetch_workers=3,
                 prefetch_mode="process", checkpoint_dir=str(tmp_path),
                 checkpoint_every=3)["losses"]
    assert got == ref and _same(_state(tr), _state(base))
    assert tr.runtime.injector.total_fired() >= 3


@pytest.mark.cuda
def test_cuda_resume_is_bitwise_the_uninterrupted_run(g, cuda, tmp_path):
    base = _trainer(g, device=cuda)
    ref = base.fit(_views(g), steps=8)["losses"]
    _trainer(g, device=cuda).fit(_views(g), steps=4,
                                 checkpoint_dir=str(tmp_path),
                                 checkpoint_every=2)
    tr, stream = _trainer(g, device=cuda), _views(g)
    got = tr.fit(stream, steps=4, checkpoint_dir=str(tmp_path), resume=True)
    assert got["losses"] == ref[4:] and stream.cursor == 8
    assert _same(_state(tr), _state(base))
