"""``python -m repro_torch.analysis``: the static-analysis gate of the port
(the counterpart of ``repro/analysis/cli.py``).

Records the model zoo's steps across aggregation backends and trainers
(:func:`~repro_torch.analysis.oplog.record_ops`), runs every applicable
registry rule over the op logs, reads the compiled kernels' registers
and shared memory on the card, lints the source tree, and prints a text
(and optionally JSON) report. ``--strict`` exits nonzero on any error
finding.

The smoke matrix (the reference's):

- combine-level forward and backward for all four combine modes on the
  csc backend: the exact Sum-stage contract (pregather, segment-scatter,
  backward-gather);
- one engine ``Trainer`` (P=1) train step and one infer per zoo model x
  backend (reference, csc): f64 drift, host transfers, the captured
  step's static inputs, pre-gather, and the model-level certificate
  (csc counts fewer edge-axis scatters than reference);
- ``CompactTrainer`` bucketed steps over compact mini and cluster views:
  the O(view) full-graph-tensor contract per touched bucket;
- the two served steps of a ``GNNServer`` (full K-hop and cache hit);
- the source lint over ``src/repro_torch``.

On the card (``--device cuda``, the default) the steps run the CUDA
kernels and ``cuda.resources`` reads every compiled kernel; the
``reference`` backend runs on the CPU only, so there it is not traced.
With ``--device cpu`` the plain versions run and ``cuda.resources`` is
not run: the report says so. ``--full`` widens the trainer sweep to every
strategy's view and both backends of the compact and served steps, and
records the sequence kernels (flash attention, wkv6) at the LM zoo's
head dims.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis.oplog import (Finding, OpContext,
                                        count_segment_scatters, record_ops,
                                        run_rules)
from repro_torch.analysis.resources import Budget, all_stats, check_stats
from repro_torch.analysis.srclint import lint_tree
from repro_torch.device import resolve_device

MODELS = ("gcn", "sage", "sage_max", "gat")
BACKENDS = ("reference", "csc")
COMBINE_MODES = ("sum", "mean", "max", "softmax")

# rule subsets per context kind, the reference's. Combine-level steps are
# the exact Sum-stage contract; model-level train steps gather and
# scatter the edge axis in NN-Gather, so there the scatter and gather
# rules stay off while pregather (exact) and the step-hygiene rules run.
# Compact steps add the O(view) contract.
COMBINE_RULES = ("ops.pregather", "ops.segment-scatter",
                 "ops.backward-gather", "ops.f64-promotion",
                 "cuda.resources")
TRAIN_RULES = ("ops.pregather", "ops.f64-promotion", "ops.host-transfer",
               "ops.static-inputs", "cuda.resources")
INFER_RULES = ("ops.f64-promotion", "ops.host-transfer", "cuda.resources")
COMPACT_RULES = ("ops.full-graph-tensor", "ops.f64-promotion",
                 "ops.host-transfer", "cuda.resources")


def _graph(n=220, seed=0):
    from repro_torch.graph.datasets import sbm_graph
    return sbm_graph(num_nodes=n, num_classes=4, feature_dim=8,
                     p_in=0.05, p_out=0.005, seed=seed).add_self_loops()


def _cfg(model: str, backend: str):
    from repro_torch.config import GNNConfig
    return GNNConfig(model=model, num_layers=2, hidden_dim=16,
                     num_classes=4, feature_dim=8, aggregate_backend=backend)


class Report:
    """Findings and counts of one analysis run. ``budget`` is the
    ``cuda.resources`` budget, None where it is not run (the CPU)."""

    def __init__(self, device: torch.device, budget: Optional[Budget]):
        self.device = device
        self.budget = budget
        self.findings: List[Finding] = []
        self.contexts = 0
        self.launches: List[dict] = []
        self.kernels: List[dict] = []
        self.certificates: List[dict] = []
        self.not_run: set = set()
        self.lint_files = 0

    def run(self, ctx: OpContext, ids) -> None:
        self.contexts += 1
        if ctx.budget is None and "cuda.resources" in ids:
            self.not_run.add("cuda.resources")
            ids = [i for i in ids if i != "cuda.resources"]
        self.findings.extend(run_rules(ctx, ids=ids))
        for e in ctx.log.kernels():
            self.launches.append({
                "kernel": e.name[len("kernel:"):], "route": e.route,
                "operands": [list(t.shape) for t in e.arg("operands")],
                "label": ctx.label})

    def context(self, log, label: str, **kw) -> OpContext:
        return OpContext(log, label=label, budget=self.budget, **kw)

    @property
    def backends(self) -> tuple:
        """The ``reference`` backend runs on the CPU only."""
        return BACKENDS if self.device.type == "cpu" else ("csc",)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def to_json(self) -> dict:
        return {
            "device": str(self.device),
            "contexts_traced": self.contexts,
            "lint_files": self.lint_files,
            "not_run": sorted(self.not_run),
            "findings": [f.to_json() for f in self.findings],
            "certificates": self.certificates,
            "launches": self.launches,
            "kernels": self.kernels,
        }


def check_combine_modes(report: Report) -> None:
    """Forward and backward of combine-level losses on the csc backend:
    the exact Sum-stage contract, all four combine modes."""
    from repro_torch.core.aggregate import combine
    from repro_torch.kernels.plan import build_csc_plan

    dev = report.device
    rng = np.random.default_rng(7)
    E, N, H, D = 400, 90, 2, 8
    ids = rng.integers(0, N // 2, E).astype(np.int32)
    value = torch.tensor(rng.normal(size=(E, H, D)), dtype=torch.float32,
                         device=dev)
    logit = torch.tensor(rng.normal(size=(E, H)), dtype=torch.float32,
                         device=dev)
    mask = torch.tensor(rng.random(E) > 0.3, dtype=torch.float32,
                        device=dev)
    dst = torch.from_numpy(ids).to(dev)
    plan = build_csc_plan(ids, N).to(dev)

    for mode in COMBINE_MODES:
        v = value.clone().requires_grad_(True)
        lg = logit.clone().requires_grad_(True)

        def value_and_grad(_mode=mode):
            out = combine(_mode, {"value": v, "logit": lg}, dst, N, mask,
                          backend="csc", plan=plan)
            loss = torch.sum(torch.sin(out) * out)
            loss.backward()
            return loss

        _, log = record_ops(value_and_grad)
        report.run(report.context(log, f"combine:{mode}", plan=plan),
                   ids=COMBINE_RULES)


def check_trainers(report: Report, full: bool = False) -> None:
    """One engine Trainer (P=1) per zoo model x backend: a train step and
    an infer; on the CPU also the model-level scatter certificate."""
    from repro_torch.core.clustering import label_propagation_clusters
    from repro_torch.core.engine import HybridParallelEngine
    from repro_torch.core.partition import build_partitions
    from repro_torch.core.strategies import strategy_views
    from repro_torch.core.trainer import Trainer
    from repro_torch.models import make_gnn
    from repro_torch.optim import adam

    g = _graph()
    clusters = label_propagation_clusters(g, max_cluster_size=60, seed=0)
    strategies = ("global", "mini", "cluster") if full else ("global",)
    sharded = build_partitions(g, 1)
    for model_name in MODELS:
        scatters = {}
        for backend in report.backends:
            engine = HybridParallelEngine(
                make_gnn(_cfg(model_name, backend), seed=0), sharded,
                device=report.device)
            trainer = Trainer(engine, adam(1e-2))
            plan = engine._device_data.dst_plan
            for strategy in strategies:
                view = next(iter(strategy_views(
                    g, strategy, K=2, seed=0, steps=1, batch_nodes=24,
                    clusters=clusters, clusters_per_batch=2)))
                log = trainer.traced_step_ops(view)
                if strategy == "global":
                    scatters[backend] = count_segment_scatters(log, plan)
                report.run(report.context(
                    log, f"train:{model_name}/{backend}/{strategy}",
                    plan=plan if backend == "csc" else None,
                    expect_static=trainer.expected_static(view)),
                    ids=TRAIN_RULES)
            view = next(iter(strategy_views(g, "global", K=2, steps=1)))
            report.run(report.context(trainer.traced_infer_ops(view),
                                      f"infer:{model_name}/{backend}"),
                       ids=INFER_RULES)
        if len(scatters) == len(BACKENDS):
            report.certificates.append(dict(model=model_name, **scatters))
            if scatters["csc"] >= scatters["reference"]:
                report.findings.append(Finding(
                    "ops.segment-scatter",
                    f"the csc step counts {scatters['csc']} edge-axis "
                    f"scatters, not fewer than reference's "
                    f"{scatters['reference']}", label=f"train:{model_name}"))


def _exempt(block, N: int, E: int) -> tuple:
    """A bucket pad that equals the full graph's N or E is not a
    full-graph tensor: exempt the collision."""
    pads = (block.num_nodes_padded, block.num_edges_padded)
    return tuple(d for d in pads if d in (N, E))


def check_compact_buckets(report: Report, full: bool = False) -> None:
    """CompactTrainer bucketed steps: the O(view) contract per touched
    bucket."""
    from repro_torch.core.clustering import label_propagation_clusters
    from repro_torch.core.strategies import strategy_views
    from repro_torch.core.trainer import CompactTrainer
    from repro_torch.models import make_gnn
    from repro_torch.optim import adam

    g = _graph()
    N, E = g.num_nodes, g.num_edges
    clusters = label_propagation_clusters(g, max_cluster_size=60, seed=0)
    for backend in (report.backends if full else ("csc",)):
        trainer = CompactTrainer(make_gnn(_cfg("gcn", backend), seed=0), g,
                                 adam(1e-2), device=report.device)
        view_sets = [
            ("mini", strategy_views(g, "mini", K=2, seed=0, steps=2,
                                    batch_nodes=24, neighbor_cap=4,
                                    compact=True)),
            ("cluster", strategy_views(g, "cluster", K=2, seed=0, steps=2,
                                       clusters=clusters,
                                       clusters_per_batch=2,
                                       compact=True)),
        ]
        for strategy, views in view_sets:
            for i, view in enumerate(views):
                log = trainer.traced_step_ops(view)
                report.run(report.context(
                    log, f"compact:{backend}/{strategy}[{i}]",
                    graph_shape=(N, E),
                    exempt_dims=_exempt(trainer.stager.stage(view), N, E)),
                    ids=COMPACT_RULES)


def check_serving(report: Report, full: bool = False) -> None:
    """GNNServer's two served steps, the full K-hop one and the cache
    hit's 1-hop one: the same O(view) contract as compact training."""
    from repro_torch.models import make_gnn
    from repro_torch.serving import GNNServer

    g = _graph()
    N, E = g.num_nodes, g.num_edges
    targets = np.arange(0, 24, 2)
    for backend in (report.backends if full else ("csc",)):
        server = GNNServer(make_gnn(_cfg("gcn", backend), seed=0), None, g,
                           device=report.device)
        for name, step, builder, stager in (
                ("full", server._full_step, server._builder,
                 server._stager),
                ("hit", server._hit_step, server._hit_builder,
                 server._hit_stager)):
            block = stager.stage(builder.khop_compact(targets))
            report.run(report.context(
                step.ops(block), f"serving:{backend}/{name}",
                graph_shape=(N, E), exempt_dims=_exempt(block, N, E)),
                ids=COMPACT_RULES)


def check_sequence_kernels(report: Report) -> None:
    """--full only: the LM zoo's kernels, flash attention (float32 and
    bf16) and wkv6 (bf16 in, float32 out, the model's call), at the zoo's
    head dims: f64 drift and, on the card, their resources at these
    launch shapes."""
    from repro_torch.kernels.ops import flash_attention_op, wkv6_op

    dev = report.device
    gen = torch.Generator().manual_seed(3)

    def mk(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 128)):
        q, k, v = (mk(1, 256, 4, D, dtype=dtype) for _ in range(3))
        with torch.no_grad():
            _, log = record_ops(flash_attention_op, q, k, v, causal=True)
        report.run(report.context(
            log, f"kernel:flash_attention/{str(dtype)[6:]}/D={D}"),
            ids=("ops.f64-promotion", "cuda.resources"))
    r, k, v = (mk(1, 64, 4, 64, dtype=torch.bfloat16) for _ in range(3))
    w = torch.sigmoid(mk(1, 64, 4, 64)) * 0.1 + 0.9
    u = mk(4, 64)
    with torch.no_grad():
        _, log = record_ops(wkv6_op, r, k, v, w, u,
                            out_dtype=torch.float32)
    report.run(report.context(log, "kernel:wkv6/bfloat16/K=64"),
               ids=("ops.f64-promotion", "cuda.resources"))


def check_libraries(report: Report) -> None:
    """On the card: ``cuda.resources`` over every compiled kernel of every
    source, its dynamic shared memory at every launch shape it takes."""
    stats = all_stats()
    report.kernels = [s.to_json() for s in stats]
    report.findings.extend(check_stats(stats, report.budget, "libraries"))


def check_srclint(report: Report, root: Optional[str] = None) -> None:
    if root is None:
        import repro_torch
        root = next(iter(repro_torch.__path__))
    root = Path(root)
    report.lint_files = len(list(root.rglob("*.py")))
    report.findings.extend(lint_tree(root))


def analyze(full: bool = False, lint_root: Optional[str] = None,
            device=None, out=print) -> Report:
    """Record and check the matrix; returns the :class:`Report`.
    ``device`` None is the card (it raises where there is none), as for
    every entry point of the port."""
    dev = resolve_device(device)
    report = Report(dev, Budget() if dev.type == "cuda" else None)
    out(f"repro_torch.analysis on {dev}: "
        f"{'full' if full else 'smoke'} matrix")
    check_combine_modes(report)
    out(f"  combine contracts: {len(COMBINE_MODES)} modes recorded")
    check_trainers(report, full=full)
    check_compact_buckets(report, full=full)
    check_serving(report, full=full)
    out(f"  trainer/compact/serving steps: {report.contexts} recorded "
        f"contexts ({', '.join(report.backends)} backend"
        f"{'s' if len(report.backends) > 1 else ''})")
    for c in report.certificates:
        out(f"  scatter certificate {c['model']}: csc {c['csc']} < "
            f"reference {c['reference']}")
    if full:
        check_sequence_kernels(report)
    check_srclint(report, root=lint_root)
    out(f"  srclint: {report.lint_files} files")
    out(f"  kernel calls recorded: {len(report.launches)}")
    if report.budget is not None:
        check_libraries(report)
        out(f"  cuda.resources: {len(report.kernels)} compiled kernels "
            "read")
    else:
        out("  cuda.resources: not run (--device cpu: the kernels' plain "
            "versions ran, there are no compiled kernels to read)")
    return report


def run_analysis(strict: bool = False, full: bool = False,
                 json_path: Optional[str] = None,
                 lint_root: Optional[str] = None, device=None,
                 out=print) -> int:
    """The gate: :func:`analyze`, the report, and the exit code."""
    report = analyze(full, lint_root, device, out)
    if json_path:
        Path(json_path).write_text(json.dumps(report.to_json(), indent=2))
        out(f"  json report -> {json_path}")
    errors = report.errors
    if not report.findings:
        out(f"OK: 0 findings over {report.contexts} recorded contexts")
    else:
        for f in report.findings:
            out(f.render())
        out(f"{len(report.findings)} findings ({len(errors)} errors) over "
            f"{report.contexts} contexts")
    return 1 if (strict and errors) else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis over recorded torch steps, the "
                    "compiled kernels' resources and the repro_torch "
                    "source tree")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on any error finding (the gate)")
    p.add_argument("--full", action="store_true",
                   help="widen to every strategy and the sequence kernels")
    p.add_argument("--json", metavar="PATH", default=None,
                   help="write the JSON report here")
    p.add_argument("--lint-root", default=None,
                   help="package dir to lint (default: repro_torch)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu: where the steps run")
    args = p.parse_args(argv)
    return run_analysis(strict=args.strict, full=args.full,
                        json_path=args.json, lint_root=args.lint_root,
                        device=args.device)


if __name__ == "__main__":
    sys.exit(main())
