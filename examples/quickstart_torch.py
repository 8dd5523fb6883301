"""Quickstart on the PyTorch port: train a GCN with GraphTheta-style
global batch, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
        --backend reference          # plain segment ops, CPU only

The ``csc`` Sum stage runs the port's CUDA kernels on the card and their
plain versions on the CPU. The loop is the JAX quickstart's
(``examples/quickstart.py``): 100 Adam steps of ``loss_block`` on cora,
then the test accuracy, then the facade: ``api.train`` -> ``api.serve``,
certified one capture per bucket.
"""
import argparse

import numpy as np
import torch

from repro_torch.config import GNNConfig
from repro_torch.core.mpgnn import accuracy_block, loss_block
from repro_torch.core.strategies import global_batch_view
from repro_torch.device import resolve_device
from repro_torch.graph import make_dataset
from repro_torch.models import make_gnn
from repro_torch.optim import adam


def main(backend: str = "csc", device=None, steps: int = 100,
         params=None, facade: bool = True) -> dict:
    """Train, evaluate and (``facade``) serve. ``params`` (a
    ``state_dict``) replaces the seeded initial weights, e.g. the JAX
    quickstart's through :func:`repro_torch.weights.params_from_jax`.
    Returns the per-step losses and the accuracies."""
    dev = resolve_device(device)
    g = make_dataset("cora", seed=0).add_self_loops()
    cfg = GNNConfig(model="gcn", num_layers=2, hidden_dim=32, num_classes=7,
                    feature_dim=g.node_features.shape[1],
                    aggregate_backend=backend)
    model = make_gnn(cfg, seed=0)
    if params is not None:
        model.load_state_dict(params)
    model.to(dev)
    opt = adam(1e-2, weight_decay=5e-4)
    named = dict(model.named_parameters())
    state = opt.init(named)
    block = global_batch_view(g, cfg.num_layers).as_block(
        csc_plan=backend == "csc").to(dev)

    losses = []
    for i in range(steps):
        model.zero_grad(set_to_none=True)
        loss = loss_block(model, block)
        loss.backward()
        opt.update({k: p.grad for k, p in named.items()}, state, named)
        losses.append(loss.detach())
        if i % 20 == 0:
            print(f"step {i:3d}  loss {float(losses[-1]):.4f}")
    with torch.no_grad():
        mask = torch.from_numpy(g.test_mask.astype(np.float32)).to(dev)
        acc = float(accuracy_block(model, block, mask=mask))
    print(f"test accuracy: {acc:.4f}")
    out = {"losses": [float(x) for x in torch.stack(losses).cpu()],
           "test_acc": acc}
    if not facade:
        return out

    # ... or the facade: one typed job, the right trainer picked for
    # you (its step captured once per bucket on the card), then chain
    # straight into offline inference and online serving
    import repro_torch.api as api

    result = api.train(api.TrainJob(dataset="cora", steps=steps, hidden=32,
                                    eval_every=steps, device=device))
    print(f"facade test accuracy: {result.final_acc:.4f}")
    server = api.serve(result, api.ServeConfig(max_batch=8))
    preds = server.submit([0, 1, 2, 3]).argmax(-1)
    print(f"online predictions for nodes 0..3: {preds}")
    server.assert_compiled_per_bucket()
    out.update(facade_acc=result.final_acc, preds=preds, server=server)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="csc",
                    choices=["reference", "csc"],
                    help="Sum-stage aggregation backend (reference: plain "
                    "segment ops, CPU only)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    main(args.backend, args.device, args.steps)
