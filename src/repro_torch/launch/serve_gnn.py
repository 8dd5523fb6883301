"""Online GNN serving entrypoint + load-test harness (the counterpart of
``repro/launch/serve_gnn.py``).

Builds the graph and a model, stands up a
:class:`~repro_torch.serving.GNNServer` on the card (``--device cpu``
runs the kernels' plain versions on the CPU), replays a seeded request
trace from concurrent client threads and prints the latency/QPS/cache
report. The model's weights are seeded random ones by default
(``--steps 0``); ``--steps N`` trains them through
:func:`repro_torch.api.train` first, and ``--checkpoint-dir`` serves the
params of that directory's newest valid checkpoint (of either package).

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn \
        --dataset alipay_like --model gat_e --hidden 32 --requests 512
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np

from repro_torch.config import GNNConfig
from repro_torch.graph import Graph, make_dataset
from repro_torch.models import make_gnn
from repro_torch.serving import GNNServer
from repro_torch.utils import get_logger

log = get_logger("serve_gnn")


def request_trace(g, n_requests: int, seed: int = 0,
                  hot_frac: float = 0.1, hot_mass: float = 0.8):
    """A seeded, skewed node-id trace: ``hot_frac`` of the nodes receive
    ``hot_mass`` of the requests; the rest spread uniformly. The same
    draws as the reference's, so both packages replay one trace."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    n_hot = max(1, int(n * hot_frac))
    hot = rng.choice(n, size=n_hot, replace=False)
    p = np.full(n, (1.0 - hot_mass) / max(1, n - n_hot))
    p[hot] = hot_mass / n_hot
    p /= p.sum()
    return rng.choice(n, size=n_requests, p=p)


def run_clients(server, trace: np.ndarray, clients: int,
                timeout: float = 60.0):
    """Replay ``trace`` through ``clients`` threads against the armed
    server's batching queue (round-robin slices, each issued in order).
    Returns (logits aligned to ``trace``, wall seconds)."""
    out = np.empty((len(trace), server.model.num_classes), np.float32)
    errors: list = []

    def client(cid: int):
        try:
            for i in range(cid, len(trace), clients):
                out[i] = server.request(int(trace[i]), timeout=timeout)
        except Exception as e:      # surface, don't hang the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return out, wall


def print_report(server, wall: float, n_requests: int,
                 label: str = "") -> None:
    """The latency/QPS/cache report; ``label`` (the device and its power
    limit) prefixes every line that carries a measurement."""
    s = server.server_stats()
    lat, stage = s["latency_ms"], s["stage_s"]
    pre = f"[{label}] " if label else ""
    print(f"{pre}served {s['requests']} requests in {s['batches']} batches "
          f"(mean batch {s['mean_batch']:.1f}) in {wall:.3f}s "
          f"-> {n_requests / wall:.1f} QPS")
    print(f"{pre}latency ms: p50={lat['p50']:.3f} p99={lat['p99']:.3f} "
          f"mean={lat['mean']:.3f}")
    print(f"{pre}stage s: queue_wait={stage['queue_wait']:.3f} "
          f"view_build={stage['view_build']:.3f} "
          f"device_step={stage['device_step']:.3f} "
          f"gather={stage['gather']:.4f}")
    cache = s["cache"]
    if cache.get("enabled", True):
        print(f"{pre}cache: hit_rate={cache['hit_rate']:.3f} "
              f"hits={cache['hits']} misses={cache['misses']} "
              f"entries={cache['entries']} staleness={cache['staleness']}")
    else:
        print(f"{pre}cache: disabled")
    b = s["buckets"]
    print(f"{pre}buckets: full={sum(b['full'].values())} calls over "
          f"{len(b['full'])} buckets, hit={sum(b['hit'].values())} calls "
          f"over {len(b['hit'])} buckets")


def resolve_graph(dataset: str, model: str, seed: int = 0, **kw) -> Graph:
    """The named dataset; GCN's spectral norm assumes self-loops, as the
    reference's ``api._resolve_graph`` adds them."""
    g = make_dataset(dataset, seed=seed, **kw)
    return g.add_self_loops() if model == "gcn" else g


def config_for(g: Graph, model: str, num_layers: int,
               hidden: int) -> GNNConfig:
    """The model's config on ``g``: classes, feature and edge widths come
    from the graph; the attention models get 4 heads, as in the
    reference facade (``api.py:141``)."""
    edge_dim = (g.edge_features.shape[1]
                if g.edge_features is not None else 0)
    if model == "gat_e" and edge_dim == 0:
        raise ValueError("gat_e needs an edge-attributed dataset "
                         "(alipay_like)")
    return GNNConfig(model=model, num_layers=num_layers, hidden_dim=hidden,
                     num_classes=int(g.labels.max()) + 1,
                     feature_dim=g.node_features.shape[1],
                     edge_feature_dim=edge_dim,
                     num_heads=4 if model in ("gat", "gat_e") else 1)


def make_model(g: Graph, model: str, num_layers: int, hidden: int,
               seed: int = 0):
    """A model for ``g`` (:func:`config_for`) with seeded random weights."""
    return make_gnn(config_for(g, model, num_layers, hidden), seed=seed)


def build_server(g: Graph, model: str, num_layers: int, hidden: int,
                 seed: int = 0, device=None, params=None,
                 **server_kw) -> GNNServer:
    """A server over ``g`` for :func:`make_model`'s model, with ``params``
    (a ``state_dict``) loaded when given."""
    return GNNServer(make_model(g, model, num_layers, hidden, seed), params,
                     g, gcn_norm=model == "gcn", device=device, **server_kw)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve a GNN with seeded weights and load-test it")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--model", default="gcn",
                    choices=["gcn", "sage", "sage_max", "gat", "gat_e"])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--steps", type=int, default=0,
                    help="training steps (api.train, global strategy) "
                         "before serving; the default 0 serves the seeded "
                         "random weights, as chip_smoke.py's serving "
                         "phases do")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="serve the params of this directory's newest "
                         "valid checkpoint instead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the historical-embedding cache "
                         "(every request takes the K-hop path)")
    ap.add_argument("--staleness", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import repro_torch.api as api
    if args.steps > 0:
        log.info("training %s/%s for %d steps ...", args.model,
                 args.dataset, args.steps)
        result = api.train(api.TrainJob(
            dataset=args.dataset, model=args.model, num_layers=args.layers,
            hidden=args.hidden, steps=args.steps, seed=args.seed,
            eval_every=max(1, args.steps - 1), device=args.device))
        log.info("trained: final_acc=%.4f (%.1fs)", result.final_acc,
                 result.wall_s)
        print(f"[{result.trainer.device}] trained {args.steps} steps: "
              f"final test acc {result.final_acc:.4f}")
        g = result.graph
        server = api.serve(result, api.ServeConfig(
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            cache=not args.no_cache, staleness=args.staleness,
            checkpoint_dir=args.checkpoint_dir))
    else:
        g = resolve_graph(args.dataset, args.model, seed=args.seed)
        params = (api.checkpoint_params(args.checkpoint_dir)
                  if args.checkpoint_dir else None)
        server = build_server(g, args.model, args.layers, args.hidden,
                              seed=args.seed, device=args.device,
                              params=params, cache=not args.no_cache,
                              staleness=args.staleness,
                              max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms)
    server.start()
    try:
        trace = request_trace(g, args.requests, seed=args.seed)
        _, wall = run_clients(server, trace, args.clients)
    finally:
        server.stop()
    print_report(server, wall, args.requests, label=str(server.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
