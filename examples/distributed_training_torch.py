"""End to end on the PyTorch port: distributed GNN training the
way the paper runs it, as ``examples/distributed_training.py`` does — a
worker group (8 partitions by default; 1,024 workers in the paper)
jointly computes every batch of an edge-attributed power-law
"Alipay-like" graph with the in-house GAT-E model, under all three
training strategies.

The loop is the engine :class:`~repro_torch.core.trainer.Trainer`: one
train step serves global-, mini- and cluster-batch alike while builder
threads (or sampler processes) build, shard and stage upcoming views —
deterministically, since view i depends only on (seed, i). Every
partition runs in this process on one device
(:class:`~repro_torch.core.comm.LocalComm`), or, with ``--ranks R``,
``workers // R`` of them in each of R processes, one a card (NCCL;
gloo with ``--device cpu``; :mod:`repro_torch.launch.ranks`), rank 0
printing; on the card the step is captured once, and
``assert_compiled_once()`` certifies that no strategy switch captured it
again.

    PYTHONPATH=src python examples/distributed_training_torch.py
    PYTHONPATH=src python examples/distributed_training_torch.py \
        --device cpu --steps 6 --nodes 800 --workers 4
    PYTHONPATH=src python examples/distributed_training_torch.py \
        --ranks 4       # P=8 over four cards, two partitions each
"""
import argparse
import time

import torch

from repro_torch.config import GNNConfig
from repro_torch.core.clustering import label_propagation_clusters
from repro_torch.core.comm import ProcessGroupComm, check_ranks
from repro_torch.core.engine import HybridParallelEngine
from repro_torch.core.partition import build_partitions, partition_stats
from repro_torch.core.strategies import global_batch_view, strategy_views
from repro_torch.core.trainer import Trainer
from repro_torch.graph import make_dataset
from repro_torch.launch.train import add_runtime_flags, fault_policy_from
from repro_torch.models import make_gnn
from repro_torch.optim import adam


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=8000)
    ap.add_argument("--workers", type=int, default=8,
                    help="partitions, all in this process on one device "
                    "unless --ranks spreads them")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes, one a card (gloo processes with "
                    "--device cpu), each holding workers // ranks "
                    "partitions")
    ap.add_argument("--partition", default="1d_src",
                    choices=["1d_src", "1d_dst", "vertex_cut"])
    ap.add_argument("--backend", default="csc",
                    choices=["reference", "csc"],
                    help="Sum-stage aggregation backend (reference: plain "
                    "segment ops, CPU only)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the host-side view prefetch pipeline")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    add_runtime_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train over the three strategies; return the per-strategy losses,
    the final parameters (on the CPU) and the trainer (rank 0's losses
    and parameters, and no trainer, over several ranks)."""
    args = parse_args(argv)
    if args.ranks == 1:
        return run(args)
    from repro_torch.launch.ranks import launch
    check_ranks(args.workers, args.ranks)
    return launch(_rank, args.ranks, args=(argv,), device=args.device)[0]


def _rank(rank: int, argv) -> dict:
    """One of ``--ranks`` processes: :func:`run` on its partitions."""
    args = parse_args(argv)
    out = run(args, ProcessGroupComm(P=args.workers))
    return {"losses": out["losses"], "params": out["params"],
            "trainer": None}


def run(args, comm=None) -> dict:
    """:func:`main`'s fit, over ``comm`` (every partition in this
    process when None); only rank 0 prints."""
    say = print if comm is None or comm.rank == 0 else (lambda *a: None)
    g = make_dataset("alipay_like", num_nodes=args.nodes, seed=0)
    say(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"{g.edge_features.shape[1]} edge attrs, "
          f"max degree {g.in_degree().max()}")

    cfg = GNNConfig(model="gat_e", num_layers=2, hidden_dim=32,
                    num_classes=2, feature_dim=g.node_features.shape[1],
                    edge_feature_dim=g.edge_features.shape[1], num_heads=4,
                    aggregate_backend=args.backend)
    model = make_gnn(cfg, seed=0)

    sg = build_partitions(g, args.workers, method=args.partition,
                          gcn_norm=False)
    say("partition stats:", partition_stats(sg))
    engine = HybridParallelEngine(model, sg, comm=comm, device=args.device)
    trainer = Trainer(engine, adam(5e-3),
                      fault_policy=fault_policy_from(args))

    clusters = label_propagation_clusters(
        g, max_cluster_size=max(200, g.num_nodes // 20), seed=0)
    eval_view = global_batch_view(g, 2)

    steps_per = max(1, args.steps // 3)
    every = args.checkpoint_every or (steps_per if args.checkpoint_dir
                                      else 0)
    losses = {}
    for i, name in enumerate(("global", "mini", "cluster")):
        views = strategy_views(
            g, name, 2, seed=0, batch_nodes=g.num_nodes // 50,
            clusters=clusters,
            clusters_per_batch=max(1, (int(clusters.max()) + 1) // 20))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        t0 = time.perf_counter()
        out = trainer.fit(views, steps=steps_per,
                          prefetch=not args.no_prefetch,
                          prefetch_workers=args.prefetch_workers,
                          prefetch_mode=args.prefetch_mode,
                          checkpoint_every=every,
                          checkpoint_dir=args.checkpoint_dir,
                          keep_checkpoints=args.keep_checkpoints or None,
                          # the first strategy picks a run back up
                          resume=args.resume and i == 0)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        wall = time.perf_counter() - t0
        # distributed inference through the same engine (paper §4.3)
        acc = trainer.evaluate(eval_view)
        losses[name] = out["losses"]
        say(f"[{name:8s}] {steps_per} steps, {wall:.1f}s "
              f"({wall / steps_per * 1e3:.0f} ms/step), "
              f"loss {out['losses'][-1]:.4f}, test acc {acc:.4f}")
    trainer.assert_compiled_once()
    say("done: one engine, three strategies, one train step "
          f"(captured {trainer.trace_counts['train_step']}x over "
          f"{trainer.step_num} steps, {trainer.device}).")
    return {"losses": losses, "trainer": trainer,
            "params": {k: p.detach().cpu().clone()
                       for k, p in trainer.params.items()}}


if __name__ == "__main__":
    main()
