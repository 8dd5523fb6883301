"""Chaos harness (the counterpart of ``repro/runtime/chaos.py``): prove the
fault-tolerant runtime's contracts by running real training twice —
fault-free and under deterministic injected faults — and requiring the
loss trajectories **bit-identical**.

- ``python -m repro_torch.runtime.chaos --smoke``: one combined scenario
  (a killed prefetch worker, failed view builds, a failed device staging
  and a failed checkpoint save, all in one fit), one process-mode
  scenario (a sampler process SIGKILLed mid-build) and one rollback.
- ``python -m repro_torch.runtime.chaos``: every injection point alone
  and under tighter policies, the process faults ({proc_kill, proc_hang,
  slot_corrupt} x {thread, process}; the baseline is always thread mode,
  so process scenarios also certify thread/process parity), and the
  divergence recoveries (skip_view, rollback), which change the
  trajectory by design and are checked for their recovery semantics.

Every scenario runs on ``CompactTrainer``, on the card unless
``--device cpu``. The engine ``Trainer`` is not ported yet (ROADMAP
A.9): its scenarios are refused. Exit code 0 iff every scenario holds.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

from repro_torch.runtime.faults import FaultInjector, FaultPolicy

# quiet, fast policy for chaos runs: no real sleeping between retries
FAST = dict(backoff_base=0.0, backoff_cap=0.0, jitter=0.0)
ENGINE_TODO = ("the engine Trainer is not ported yet (ROADMAP A.9); the "
               "port's chaos scenarios run on CompactTrainer")


def _graph(n=160, seed=0):
    from repro_torch.graph.datasets import sbm_graph
    return sbm_graph(num_nodes=n, num_classes=4, feature_dim=8,
                     p_in=0.05, p_out=0.005, seed=seed).add_self_loops()


def _compact_trainer(g, fault_policy=None, injector=None, seed=0,
                     backend="csc", device=None):
    """The chaos runs' trainer: 2-layer GCN, hidden 16, Adam 1e-2."""
    from repro_torch.config import GNNConfig
    from repro_torch.core.trainer import CompactTrainer
    from repro_torch.models import make_gnn
    from repro_torch.optim import adam
    cfg = GNNConfig(model="gcn", num_layers=2, hidden_dim=16, num_classes=4,
                    feature_dim=8, aggregate_backend=backend)
    return CompactTrainer(make_gnn(cfg, seed=seed), g, adam(1e-2),
                          device=device, fault_policy=fault_policy,
                          injector=injector)


def _views(g, seed=0):
    from repro_torch.core.strategies import strategy_views
    return strategy_views(g, "mini", K=2, seed=seed, batch_nodes=24,
                          compact=True)


def _check_kind(trainer_kind: str) -> None:
    if trainer_kind != "compact":
        raise NotImplementedError(ENGINE_TODO)


def run_scenario(name: str, plan: dict, trainer_kind: str = "compact",
                 policy_kw: dict = None, steps: int = 8,
                 backend: str = "csc", mode: str = "thread",
                 hang_seconds: float = 0.5, device=None,
                 verbose=print) -> bool:
    """One chaos scenario: baseline vs injected run, bit-identical
    trajectory required (and the faults must actually fire). The
    baseline runs fault-free in thread mode, so a ``mode="process"``
    scenario also certifies thread/process parity."""
    _check_kind(trainer_kind)
    g = _graph()
    base = _compact_trainer(g, backend=backend, device=device)
    ref = base.fit(_views(g), steps=steps, prefetch_workers=2)["losses"]

    policy = FaultPolicy(**{**FAST, **(policy_kw or {})})
    inj = FaultInjector(plan, seed=0, hang_seconds=hang_seconds)
    tr = _compact_trainer(g, fault_policy=policy, injector=inj,
                          backend=backend, device=device)
    with tempfile.TemporaryDirectory() as d:
        got = tr.fit(_views(g), steps=steps, prefetch_workers=2,
                     prefetch_mode=mode, checkpoint_dir=d,
                     checkpoint_every=3)["losses"]
    ok = True
    if inj.total_fired() == 0:
        verbose(f"  [{name}] FAIL: no fault fired (plan {plan})")
        ok = False
    if got != ref:
        verbose(f"  [{name}] FAIL: trajectory diverged\n"
                f"    ref {ref}\n    got {got}")
        ok = False
    tr.assert_trace_contract()
    if ok:
        verbose(f"  [{name}] ok ({inj.total_fired()} faults injected, "
                f"{len(got)} steps bit-identical)")
    return ok


def run_divergence(name: str, action: str, trainer_kind: str = "compact",
                   steps: int = 8, backend: str = "csc", device=None,
                   verbose=print) -> bool:
    """Divergence recovery: inject a simulated non-finite loss at view 4
    and check that the policy's action recovered the run (the
    trajectory changes by design, so the check is semantic)."""
    _check_kind(trainer_kind)
    g = _graph()
    inj = FaultInjector({"diverge": {4}}, seed=0)
    tr = _compact_trainer(
        g, fault_policy=FaultPolicy(on_divergence=action, **FAST),
        injector=inj, backend=backend, device=device)
    with tempfile.TemporaryDirectory() as d:
        out = tr.fit(_views(g), steps=steps, prefetch_workers=2,
                     checkpoint_dir=d, checkpoint_every=2)
    ok = True
    diverges = [e for e in out["events"] if e.get("stage") == "diverge"]
    if len(diverges) != 1:
        verbose(f"  [{name}] FAIL: expected 1 divergence event, got "
                f"{len(diverges)}")
        ok = False
    if not all(np.isfinite(out["losses"])):
        verbose(f"  [{name}] FAIL: non-finite loss leaked into history")
        ok = False
    # the poison update was undone or rolled back, and the fit still ran
    # over the remaining views
    if out["steps"] < steps - 1:
        verbose(f"  [{name}] FAIL: fit stopped at step {out['steps']}")
        ok = False
    tr.assert_trace_contract()
    if ok:
        verbose(f"  [{name}] ok (1 divergence, action={action}, "
                f"{out['steps']} steps completed)")
    return ok


SMOKE_PLAN = {
    "worker_kill": {1},          # kill the worker building view 1
    "view_build": {2},           # fail view 2's build (retried)
    "device_put": {0},           # fail one staging copy (retried)
    "checkpoint_save": {0},      # fail the first save attempt (retried)
}

# every injection point alone, then paired with tighter policies
SWEEP_POINTS = ("view_build", "device_put", "step", "checkpoint_save",
                "worker_kill")
SWEEP_POLICIES = {
    "default": {},
    "retries1": {"max_retries": 1},
    "finite": {"check_finite": True},
}

# process-level faults have thread-mode analogs in StreamPrefetcher, so
# every plan runs under both prefetch modes. A process-mode proc_hang
# needs a child stall longer than the watchdog (the sleeping child sends
# no heartbeats; the parent must kill and respawn it, not wait it out)
PROC_SWEEP_POINTS = ("proc_kill", "proc_hang", "slot_corrupt")


def _proc_scenario_kw(point: str, mode: str) -> dict:
    kw = {"mode": mode}
    if mode == "process" and point == "proc_hang":
        kw["hang_seconds"] = 30.0
        kw["policy_kw"] = {"worker_heartbeat_s": 0.75}
    return kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="chaos harness for the fault-tolerant runtime")
    ap.add_argument("--smoke", action="store_true",
                    help="the fast subset: one combined scenario, one "
                         "process-mode kill and one rollback")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    # the reference backend is the CPU's plain path; the card runs csc
    backends = ("reference", "csc") if device.type == "cpu" else ("csc",)
    kw = dict(steps=args.steps, device=device)

    results = []
    print(f"chaos [{device}]: baseline-vs-injected trajectory invariance")
    if args.smoke:
        results.append(run_scenario("smoke/compact", SMOKE_PLAN, **kw))
        results.append(run_scenario("smoke/procpool", {"proc_kill": {1}},
                                    mode="process", **kw))
        results.append(run_divergence("smoke/rollback", "rollback", **kw))
    else:
        for point in SWEEP_POINTS:
            for pname, pkw in SWEEP_POLICIES.items():
                occ = {1} if point == "worker_kill" else {0, 2}
                results.append(run_scenario(f"{point}/{pname}",
                                            {point: occ}, policy_kw=pkw,
                                            **kw))
        for point in PROC_SWEEP_POINTS:
            for mode in ("thread", "process"):
                pkw = _proc_scenario_kw(point, mode)
                results.append(run_scenario(f"{point}/{mode}",
                                            {point: {1}}, **pkw, **kw))
        for backend in backends:
            results.append(run_scenario(f"combined/compact-{backend}",
                                        SMOKE_PLAN, backend=backend, **kw))
        for action in ("skip_view", "rollback"):
            results.append(run_divergence(f"diverge/{action}", action,
                                          **kw))
    passed = sum(results)
    print(f"chaos: {passed}/{len(results)} scenarios passed")
    return 0 if passed == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
