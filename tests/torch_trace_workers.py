"""Rank functions for ``test_torch_trace.py``: each runs in one process of
a gloo group that :func:`repro_torch.launch.ranks.launch` starts (or in
the test's own process, over ``LocalComm``), and imports only the port.
Kept apart from the test module so that a spawned process does not
import JAX; it holds no test."""
# (graph, nodes) a model trains on: GAT-E on an alipay_like graph, GCN on
# a reddit_like graph with self-loops
CASES = {"gat_e": ("alipay_like", 300), "gcn": ("reddit_like", 200)}
P = 2


def engine_job(model: str, ranks: int):
    """The facade's engine job at P=2: two layers, hidden 16, global
    views, on the CPU."""
    import repro_torch.api as api
    from repro_torch.graph import make_dataset
    name, n = CASES[model]
    g = make_dataset(name, seed=0, num_nodes=n)
    return api.TrainJob(
        dataset=g.add_self_loops() if model == "gcn" else g, model=model,
        hidden=16, num_layers=2, engine_partitions=P, ranks=ranks,
        eval_every=0, device="cpu")


def one_step(rank: int, model: str, ranks: int = P) -> dict:
    """One eager engine step through ``fit``: the ``comm.*`` counters it
    added, and what the payload is reckoned from: the plan's ``s_pad``, each layer's (width, heads) and the
    parameter count."""
    import repro_torch.api as api
    from repro_torch.utils import trace
    trainer, views, *_ = api.make_trainer(engine_job(model, ranks))
    counts = dict(trace.counts)
    trainer.fit(views, steps=1, prefetch=False)
    return {
        "sent": {k: v - counts.get(k, 0) for k, v in trace.counts.items()
                 if k.startswith("comm.")},
        "s_pad": trainer.plan.s_pad,
        "layers": [(layer.out_dim, layer.heads)
                   for layer in trainer.model.layers],
        "params": sum(p.numel() for p in trainer.params.values())}
