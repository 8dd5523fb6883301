"""Worker processes for the port's engine over ``torch.distributed`` (gloo
on the CPU): one partition per process, through
:class:`repro_torch.core.comm.ProcessGroupComm`. Kept apart from the test
module so that each spawned process imports only the port."""
import os

import numpy as np
import torch


def engine_case(P: int):
    """The case both communicators run: GAT-E (softmax: the halo's max and
    sum reduces) at small widths on a 300-node alipay_like graph, its
    model from seed 0, and a mini-batch view."""
    from repro_torch.config import GNNConfig
    from repro_torch.core.partition import build_partitions
    from repro_torch.core.strategies import global_batch_view, strategy_views
    from repro_torch.graph import make_dataset
    from repro_torch.models import make_gnn
    g = make_dataset("alipay_like", seed=0, num_nodes=300)
    cfg = GNNConfig(model="gat_e", num_layers=2, hidden_dim=16,
                    num_classes=int(g.labels.max()) + 1,
                    feature_dim=g.node_features.shape[1], num_heads=4,
                    edge_feature_dim=g.edge_features.shape[1])
    views = [global_batch_view(g, 2),
             strategy_views(g, "mini", 2, seed=1, batch_nodes=24).build(0)]
    return make_gnn(cfg, seed=0), build_partitions(g, P, gcn_norm=False), views


def run_case(engine, views, steps: int):
    """Per view: the loss and gradients; then ``steps`` Adam steps over
    the global view. Returns a dict of numpy arrays."""
    from repro_torch.core.strategies import shard_view
    from repro_torch.optim import adam
    out = {}
    lg = engine.make_loss_and_grad()
    for i, view in enumerate(views):
        loss, grads = lg(engine.stage_view(shard_view(engine.plan, view)))
        out[f"{i}/loss"] = loss.detach().numpy().copy()
        for k, v in grads.items():
            out[f"{i}/grad/{k}"] = v.detach().numpy().copy()
    opt = adam(1e-2)
    state = opt.init(engine.params)
    step = engine.make_train_step(opt)
    arrays = shard_view(engine.plan, views[0])
    out["losses"] = np.asarray([float(step(state, arrays))
                                for _ in range(steps)])
    return out


def gloo_worker(rank: int, world: int, init_file: str, out_dir: str,
                steps: int) -> None:
    """One partition of the gloo group: run :func:`run_case` and write
    ``rank<r>.npz``."""
    import torch.distributed as dist
    from repro_torch.core.comm import ProcessGroupComm
    from repro_torch.core.engine import HybridParallelEngine
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        model, sg, views = engine_case(world)
        engine = HybridParallelEngine(model, sg, comm=ProcessGroupComm(),
                                      device="cpu")
        out = run_case(engine, views, steps)
        infer = engine.make_infer()
        from repro_torch.core.strategies import shard_view
        out["logits"] = infer(shard_view(sg.plan, views[0])).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
