"""The public facade: ``train()`` / ``infer()`` / ``serve()`` (the
counterpart of ``repro/api.py``)::

    import repro_torch.api as api

    result = api.train(api.TrainJob(dataset="cora", steps=200))  # the card
    logits = api.infer(result, nodes=[3, 7, 11])
    server = api.serve(result, api.ServeConfig(max_batch=16))

``train`` runs the bucketed :class:`~repro_torch.core.trainer.
CompactTrainer` on ``job.device`` — the card unless the job says
``device="cpu"``. The distributed engine (``engine_partitions > 0``,
ROADMAP A.9) and the fault-tolerant runtime and checkpoints (A.8) are
refused with an error.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.graph.csr import Graph


@dataclass
class TrainJob:
    """Everything one GNN training run needs, in one place.

    ``dataset`` is a registered dataset name (GCN gets self-loops) or an
    already-built :class:`Graph` (used as-is). Strategy knobs that don't
    apply to the chosen strategy are ignored. Mini and cluster need
    ``compact=True`` until the dense mask views are ported (ROADMAP A.7).
    """
    dataset: Union[str, Graph] = "cora"
    model: str = "gcn"                 # gcn | sage | sage_max | gat | gat_e
    strategy: str = "global"           # global | mini | cluster
    steps: int = 100
    num_layers: int = 2
    hidden: int = 64
    lr: float = 1e-2
    weight_decay: float = 5e-4
    seed: int = 0
    eval_every: int = 20
    # view construction
    compact: bool = False              # compact views (mini / cluster)
    batch_nodes: int = 0               # mini (0 = 10% of labeled nodes)
    clusters_per_batch: int = 0        # cluster (0 = num_clusters // 20)
    halo_hops: int = 0
    neighbor_cap: int = 0
    # not ported yet: the engine (A.9), the runtime and checkpoints (A.8)
    engine_partitions: int = 0
    prefetch_workers: Optional[int] = None
    prefetch_mode: str = "thread"
    fault_policy: Optional[Any] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False
    log_every: int = 1
    device: Optional[str] = None       # None = the card; "cpu" to ask


@dataclass
class ServeConfig:
    """Knobs of the online inference server
    (:class:`~repro_torch.serving.GNNServer`)."""
    max_batch: int = 32
    max_wait_ms: float = 2.0
    max_queue: Optional[int] = None    # bounded admission (None = 8*batch)
    cache: bool = True                 # historical-embedding cache
    staleness: int = 0                 # max version age for a cache hit
    buckets: Optional[Any] = None      # BucketSpec (None = graph ladder)
    slots: int = 2
    checkpoint_dir: Optional[str] = None   # refused until ROADMAP A.8


@dataclass
class TrainResult:
    """What ``train()`` hands back, and what ``infer()``/``serve()``
    consume. ``params`` is a ``state_dict`` snapshot; ``model`` is the
    trained model, on ``trainer.device``."""
    params: Any
    model: Any
    graph: Graph
    history: list
    final_acc: float
    wall_s: float
    gcn_norm: bool = True
    trainer: Optional[Any] = None


def _refuse_unported(job: TrainJob) -> None:
    if job.engine_partitions:
        raise NotImplementedError(
            "engine_partitions: the distributed engine is not ported yet "
            "(ROADMAP A.9)")
    if (job.fault_policy is not None or job.checkpoint_dir
            or job.checkpoint_every or job.resume
            or job.prefetch_mode != "thread"
            or (job.prefetch_workers or 0) > 1):
        raise NotImplementedError(
            "fault_policy / checkpoints / resume / prefetch pools: the "
            "runtime is not ported yet (ROADMAP A.8)")


def _build(job: TrainJob):
    """(graph, model, opt, views, eval_view, eval_mask) for a job."""
    from repro_torch.core.strategies import global_batch_view, strategy_views
    from repro_torch.launch.serve_gnn import config_for, resolve_graph
    from repro_torch.models import make_gnn
    from repro_torch.optim import adam

    g = (job.dataset if isinstance(job.dataset, Graph)
         else resolve_graph(job.dataset, job.model, seed=job.seed))
    cfg = config_for(g, job.model, job.num_layers, job.hidden)
    model = make_gnn(cfg, seed=job.seed)
    opt = adam(job.lr, weight_decay=job.weight_decay)

    labeled = int((g.train_mask if g.train_mask is not None
                   else np.ones(g.num_nodes, bool)).sum())
    clusters = None
    clusters_per_batch = 0
    if job.strategy == "cluster":
        from repro_torch.core.clustering import label_propagation_clusters
        clusters = label_propagation_clusters(
            g, max_cluster_size=max(64, g.num_nodes // 50), seed=job.seed)
        clusters_per_batch = (job.clusters_per_batch
                              or max(1, (int(clusters.max()) + 1) // 20))
    views = strategy_views(
        g, job.strategy, job.num_layers, seed=job.seed,
        batch_nodes=job.batch_nodes or max(32, labeled // 10),
        clusters=clusters, clusters_per_batch=clusters_per_batch,
        halo_hops=job.halo_hops, neighbor_cap=job.neighbor_cap,
        compact=job.compact and job.strategy in ("mini", "cluster"))
    eval_view = global_batch_view(g, job.num_layers)
    test_mask = (g.test_mask if g.test_mask is not None else g.train_mask)
    eval_mask = (test_mask if test_mask is None
                 else test_mask.astype(np.float32))
    return g, model, opt, views, eval_view, eval_mask


def make_trainer(job: TrainJob):
    """``(trainer, views, eval_view, eval_mask, graph, model)`` for the
    job, without running it; ``train()`` is this plus ``fit``."""
    from repro_torch.core.trainer import CompactTrainer
    _refuse_unported(job)
    g, model, opt, views, eval_view, eval_mask = _build(job)
    trainer = CompactTrainer(model, g, opt, gcn_norm=job.model == "gcn",
                             device=job.device)
    return trainer, views, eval_view, eval_mask, g, model


def train(job: TrainJob, log=print) -> TrainResult:
    """Run the job end to end: build graph, model and views, fit, check
    the trainer's contract, evaluate. Deterministic in ``job.seed``, bit
    for bit, on the CPU and on the card: every scatter of the backward is
    a plan-order segment sum, with no atomics."""
    trainer, views, eval_view, eval_mask, g, model = make_trainer(job)
    t0 = time.perf_counter()
    out = trainer.fit(views, steps=job.steps, eval_every=job.eval_every,
                      eval_view=eval_view, eval_mask=eval_mask,
                      log_every=job.log_every, log=log)
    wall = time.perf_counter() - t0
    trainer.assert_trace_contract()
    history = [{"step": e["step"], "loss": e["loss"],
                "test_acc": e["eval_acc"]} for e in out["evals"]]
    if history and history[-1]["step"] == trainer.step_num:
        final_acc = history[-1]["test_acc"]
    else:
        final_acc = trainer.evaluate(eval_view, eval_mask)
        loss = out["losses"][-1] if out["losses"] else float("nan")
        history.append({"step": trainer.step_num, "loss": loss,
                        "test_acc": final_acc})
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return TrainResult(params=params, model=model, graph=g,
                       history=history, final_acc=final_acc, wall_s=wall,
                       gcn_norm=job.model == "gcn", trainer=trainer)


def infer(result: TrainResult,
          nodes: Optional[Sequence[int]] = None) -> np.ndarray:
    """One-shot full-graph inference on the model's device: ``(N, C)``
    logits, or the requested nodes' rows. For request traffic use
    :func:`serve`."""
    from repro_torch.core.mpgnn import forward_block
    from repro_torch.core.strategies import global_batch_view
    model, g = result.model, result.graph
    device = next(model.parameters()).device
    block = global_batch_view(g, model.K).as_block(
        gcn_norm=result.gcn_norm,
        csc_plan=model.aggregate_backend == "csc").to(device)
    with torch.no_grad():
        logits = forward_block(model, block)[:g.num_nodes].cpu().numpy()
    if nodes is None:
        return logits
    return logits[np.asarray(nodes, np.int64)]


def serve(result: TrainResult, config: Optional[ServeConfig] = None):
    """An online :class:`~repro_torch.serving.GNNServer` over the trained
    model, on the model's device."""
    from repro_torch.serving import GNNServer
    config = config or ServeConfig()
    if config.checkpoint_dir:
        raise NotImplementedError("checkpoint_dir: the port has no "
                                  "checkpoint format yet (ROADMAP A.8)")
    device = next(result.model.parameters()).device
    return GNNServer(result.model, result.params, result.graph,
                     buckets=config.buckets, cache=config.cache,
                     staleness=config.staleness,
                     max_batch=config.max_batch,
                     max_wait_ms=config.max_wait_ms,
                     max_queue=config.max_queue,
                     gcn_norm=result.gcn_norm, slots=config.slots,
                     device=device)


__all__ = ["TrainJob", "ServeConfig", "TrainResult", "train", "infer",
           "serve", "make_trainer"]
