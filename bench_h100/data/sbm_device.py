"""A stochastic block model made on the device from the seed, in a few
large torch calls: class labels, a binomial edge count for every pair
of blocks, uniform endpoints inside the blocks, self-pairs dropped, both
directions kept once each, and class-prototype features with noise.
The same seed gives the same graph on the same device and torch.
Every node's expected degree is the same: the graph has no hubs."""
from __future__ import annotations

import numpy as np
import torch


def sbm_graph_device(num_nodes: int, num_classes: int, feature_dim: int,
                     p_in: float, p_out: float, feature_noise: float = 1.0,
                     seed: int = 0, device="cuda") -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    N, C = int(num_nodes), int(num_classes)
    labels = torch.randint(0, C, (N,), generator=gen, device=dev)
    order = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=C)
    starts = torch.cumsum(counts, 0) - counts
    a, b = torch.triu_indices(C, C, device=dev)
    pairs = counts[a].double() * counts[b].double()
    prob = torch.where(a == b, torch.full_like(pairs, p_in),
                       torch.full_like(pairs, p_out))
    n_edges = torch.binomial(pairs, prob, generator=gen).long()
    pair = torch.repeat_interleave(torch.arange(len(a), device=dev),
                                   n_edges)
    T = pair.numel()
    ua = torch.rand(T, generator=gen, device=dev, dtype=torch.float64)
    ub = torch.rand(T, generator=gen, device=dev, dtype=torch.float64)
    ia = (ua * counts[a[pair]]).long().clamp_max(counts[a[pair]] - 1)
    ib = (ub * counts[b[pair]]).long().clamp_max(counts[b[pair]] - 1)
    s = order[starts[a[pair]] + ia]
    d = order[starts[b[pair]] + ib]
    del ua, ub, ia, ib, pair
    keep = s != d
    s, d = s[keep], d[keep]
    key = torch.unique(torch.cat([s * N + d, d * N + s]))
    src = (key // N).to(torch.int32)
    dst = (key % N).to(torch.int32)
    protos = torch.randn(C, feature_dim, generator=gen, device=dev)
    x = protos[labels] + feature_noise * torch.randn(
        N, feature_dim, generator=gen, device=dev)
    perm = torch.randperm(N, generator=gen, device=dev).cpu().numpy()
    tr = np.zeros(N, bool)
    va = np.zeros(N, bool)
    te = np.zeros(N, bool)
    n_tr, n_va = int(N * 0.6), int(N * 0.2)
    tr[perm[:n_tr]] = True
    va[perm[n_tr:n_tr + n_va]] = True
    te[perm[n_tr + n_va:]] = True
    return {"src": src.cpu().numpy(), "dst": dst.cpu().numpy(),
            "num_nodes": N, "x": x.float().cpu().numpy(),
            "y": labels.to(torch.int32).cpu().numpy(), "edge_attr": None,
            "train_mask": tr, "val_mask": va, "test_mask": te}


def make(cfg: dict, params: dict, seed: int, device) -> dict:
    """The configuration's graph: its nodes, classes and feature width,
    with ``p_in``, ``p_out`` and ``feature_noise`` from the traffic."""
    return sbm_graph_device(
        num_nodes=cfg["num_nodes"], num_classes=cfg["num_classes"],
        feature_dim=cfg["feature_dim"], seed=seed, device=device, **params)
