"""The paper's flexible-training-strategy feature on the PyTorch port:
train the same GCN with global-, mini- and cluster-batch and compare
accuracy, step cost and memory proxies (Tables 2-4 in miniature), as
``examples/strategy_comparison.py`` does.

All five rows (global, mini, cluster on dense mask views; mini and
cluster on compact sampled subgraphs) run through one engine
:class:`~repro_torch.core.trainer.Trainer` over four partitions, all in
this process on one device (:class:`~repro_torch.core.comm.LocalComm`).
``trainer.reset()`` between rows keeps the captured step, so on the card
the whole comparison captures the train step exactly once
(``assert_compiled_once``).

    PYTHONPATH=src python examples/strategy_comparison_torch.py
    PYTHONPATH=src python examples/strategy_comparison_torch.py \
        --device cpu --steps 5
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.config import GNNConfig
from repro_torch.core.clustering import label_propagation_clusters, modularity
from repro_torch.core.engine import HybridParallelEngine
from repro_torch.core.partition import build_partitions
from repro_torch.core.strategies import global_batch_view, strategy_views
from repro_torch.core.trainer import Trainer
from repro_torch.graph import make_dataset
from repro_torch.models import make_gnn
from repro_torch.optim import adam

ROWS = (("global", False), ("mini", False), ("cluster", False),
        ("mini", True), ("cluster", True))


def _view_host_bytes(v) -> int:
    """Per-view host footprint: compact views own O(view) id arrays, a
    dense view owns (K, N)/(K, E) masks, the global view owns one (N,)."""
    if hasattr(v, "nbytes"):            # CompactView
        return v.nbytes()
    na = v.node_active.nbytes if v.node_active is not None else 0
    ea = v.edge_active.nbytes if v.edge_active is not None else 0
    return na + ea + v.loss_mask.nbytes


def _sync(trainer) -> None:
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)


def run(trainer, g, clusters, strategy: str, steps: int,
        compact: bool = False) -> dict:
    """One row: a fresh start of the trainer, ``steps`` steps of the
    strategy's views, test accuracy and the memory proxies. Also returns
    the losses and the final parameters (on the CPU)."""
    trainer.reset()
    views = strategy_views(g, strategy, 2, seed=0, batch_nodes=64,
                           clusters=clusters, clusters_per_batch=4,
                           compact=compact)
    _sync(trainer)
    t0 = time.perf_counter()
    out = trainer.fit(views, steps=steps)     # builder threads ahead
    _sync(trainer)
    wall = time.perf_counter() - t0
    acc = trainer.evaluate(global_batch_view(g, 2),
                           mask=g.test_mask.astype(np.float32))
    # view i is a pure function of (seed, i), so the exact views the run
    # consumed can be replayed off the timed path to measure the peak
    # active-set size (Table 4's memory proxy) and per-view host bytes
    builder = views.make_builder()
    replayed = [views.build(i, builder) for i in range(views.cursor)]
    peak = max((v.active_counts()["active_nodes"] for v in replayed),
               default=g.num_nodes)
    view_kb = max((_view_host_bytes(v) / 1024 for v in replayed),
                  default=_view_host_bytes(global_batch_view(g, 2)) / 1024)
    return {"strategy": strategy + ("+compact" if compact else ""),
            "acc": acc, "ms_per_step": wall / steps * 1e3,
            "peak_active_nodes": peak, "view_kb": view_kb,
            "losses": out["losses"],
            "params": {k: p.detach().cpu().clone()
                       for k, p in trainer.params.items()}}


def main(device=None, steps: int = 120, nodes: int = 3000) -> dict:
    """Print the table; return the rows, the trainer, the graph and its
    clusters."""
    g = make_dataset("reddit_like", num_nodes=nodes, seed=0).add_self_loops()
    cfg = GNNConfig(model="gcn", num_layers=2, hidden_dim=64, num_classes=8,
                    feature_dim=g.node_features.shape[1])
    model = make_gnn(cfg, seed=0)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges")

    clusters = label_propagation_clusters(g, max_cluster_size=300, iters=4,
                                          seed=0)
    print(f"  [cluster] {clusters.max() + 1} communities, "
          f"modularity {modularity(g, clusters):.3f}")

    P = 4
    engine = HybridParallelEngine(model, build_partitions(g, P),
                                  device=device)
    trainer = Trainer(engine, adam(1e-2))
    # warm-up: pay the (single) capture outside the timed windows so the
    # first strategy's ms/step isn't charged for it
    trainer.fit(strategy_views(g, "global", 2), steps=2)

    print(f"{'strategy':16s} {'test_acc':>8s} {'ms/step':>8s} "
          f"{'peak_active':>11s} {'view_kb':>8s}")
    rows = []
    for strategy, compact in ROWS:
        r = run(trainer, g, clusters, strategy, steps=steps, compact=compact)
        rows.append(r)
        print(f"{r['strategy']:16s} {r['acc']:8.4f} "
              f"{r['ms_per_step']:8.1f} {r['peak_active_nodes']:11d} "
              f"{r['view_kb']:8.1f}")
    trainer.assert_compiled_once()
    n = trainer.trace_counts["train_step"]
    print(f"one train step served every strategy, dense AND compact "
          f"({n} capture{'' if n == 1 else 's'} of it, P={P}, "
          f"{trainer.device}).")
    return {"rows": rows, "trainer": trainer, "graph": g,
            "clusters": clusters}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--steps", type=int, default=120,
                    help="steps per strategy row")
    ap.add_argument("--nodes", type=int, default=3000)
    args = ap.parse_args()
    main(args.device, args.steps, args.nodes)
