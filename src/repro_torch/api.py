"""The public facade: ``train()`` / ``infer()`` / ``serve()`` (the
counterpart of ``repro/api.py``)::

    import repro_torch.api as api

    result = api.train(api.TrainJob(dataset="cora", steps=200))  # the card
    logits = api.infer(result, nodes=[3, 7, 11])
    server = api.serve(result, api.ServeConfig(max_batch=16))

``train`` runs the bucketed :class:`~repro_torch.core.trainer.
CompactTrainer` on ``job.device`` — the card unless the job says
``device="cpu"`` — under the job's prefetch pool, fault policy and
checkpoints; with ``engine_partitions > 0`` it runs the engine
:class:`~repro_torch.core.trainer.Trainer` over that many partitions of
the graph instead, all in this process on the job's device
(:class:`~repro_torch.core.comm.LocalComm`).
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
    apply to the chosen strategy are ignored. Mini and cluster train on
    dense mask views over the whole graph, or on compact sampled
    subgraphs with ``compact=True``.
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
    engine_partitions: int = 0         # >0: the distributed engine
    partition_method: str = "1d_src"   # 1d_src | 1d_dst | vertex_cut
    prefetch_workers: Optional[int] = None
    prefetch_mode: str = "thread"      # thread | process (sampler procs)
    # fault tolerance and checkpoints (repro_torch.runtime)
    fault_policy: Optional[Any] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    keep_checkpoints: Optional[int] = None   # None = the policy's
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
    checkpoint_dir: Optional[str] = None   # serve params from a checkpoint


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
    g, model, opt, views, eval_view, eval_mask = _build(job)
    if job.engine_partitions:
        from repro_torch.core.engine import HybridParallelEngine
        from repro_torch.core.partition import build_partitions
        from repro_torch.core.trainer import Trainer
        sg = build_partitions(g, job.engine_partitions,
                              method=job.partition_method,
                              gcn_norm=job.model == "gcn")
        trainer = Trainer(HybridParallelEngine(model, sg, device=job.device),
                          opt, fault_policy=job.fault_policy)
    else:
        from repro_torch.core.trainer import CompactTrainer
        trainer = CompactTrainer(model, g, opt, gcn_norm=job.model == "gcn",
                                 device=job.device,
                                 fault_policy=job.fault_policy)
    return trainer, views, eval_view, eval_mask, g, model


def train(job: TrainJob, log=print) -> TrainResult:
    """Run the job end to end: build graph, model and views, fit, check
    the trainer's contract, evaluate. Deterministic in ``job.seed``, bit
    for bit, on the CPU and on the card, for any prefetch pool: every
    scatter of the backward is a plan-order segment sum, with no atomics.
    A :class:`~repro_torch.runtime.TrainingInterrupted` (raised by
    ``fit`` between steps after a signal handler's request) saves a
    checkpoint into ``job.checkpoint_dir`` on its way out."""
    from repro_torch.runtime.faults import TrainingInterrupted
    trainer, views, eval_view, eval_mask, g, model = make_trainer(job)
    t0 = time.perf_counter()
    try:
        out = trainer.fit(views, steps=job.steps, eval_every=job.eval_every,
                          eval_view=eval_view, eval_mask=eval_mask,
                          prefetch_workers=job.prefetch_workers,
                          prefetch_mode=job.prefetch_mode,
                          checkpoint_every=job.checkpoint_every,
                          checkpoint_dir=job.checkpoint_dir,
                          keep_checkpoints=job.keep_checkpoints,
                          resume=job.resume,
                          log_every=job.log_every, log=log)
    except TrainingInterrupted:
        # fit's finally already retired the prefetch pool; keep the
        # progress so that resume picks the run back up
        if job.checkpoint_dir:
            trainer.save(job.checkpoint_dir, job.keep_checkpoints)
            log(f"interrupted at step {trainer.step_num} — checkpoint "
                f"saved to {job.checkpoint_dir}")
        raise
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
    model, on the model's device. ``config.checkpoint_dir`` serves the
    params of its newest valid checkpoint (written by either package)
    instead of the in-memory ones."""
    from repro_torch.serving import GNNServer
    config = config or ServeConfig()
    params = result.params
    if config.checkpoint_dir:
        params = checkpoint_params(config.checkpoint_dir)
    device = next(result.model.parameters()).device
    return GNNServer(result.model, params, result.graph,
                     buckets=config.buckets, cache=config.cache,
                     staleness=config.staleness,
                     max_batch=config.max_batch,
                     max_wait_ms=config.max_wait_ms,
                     max_queue=config.max_queue,
                     gcn_norm=result.gcn_norm, slots=config.slots,
                     device=device)


def checkpoint_params(directory: str):
    """The ``state_dict`` of the newest valid checkpoint in
    ``directory``."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.weights import params_from_jax
    return params_from_jax(load_checkpoint(directory)["params"])


__all__ = ["TrainJob", "ServeConfig", "TrainResult", "train", "infer",
           "serve", "make_trainer", "checkpoint_params"]
