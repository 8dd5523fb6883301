"""A power-law, edge-attributed graph made on the device from the seed, in
a few large torch calls: the model of the program's stand-in for the
Alipay graph (``repro_torch.graph.datasets.powerlaw_graph``: preferential
attachment, ``avg_degree // 2`` edges from each new node, both
directions kept once each, edge attributes with one raised relation
column, binary labels planted from a 2-hop risk signal), drawn by the
linear-time method of Batagelj and Brandes (Phys. Rev. E 71, 036113,
2005). Edge ``k`` of new node ``v`` copies a uniform slot of the list of
every endpoint of the edges before ``v``'s, which is a draw proportional
to degree; a slot that is itself a copied target is resolved by pointer
jumping. Unlike the program's loop, a node that draws one target twice
keeps one edge and the list keeps both draws. The same seed gives the
same graph on the same device and torch."""
from __future__ import annotations

import numpy as np
import torch


def _targets(N: int, m: int, gen, dev) -> tuple:
    """(src, dst) of the ``m * (N - m)`` drawn edges, new node to the
    earlier node it attached to."""
    K = m * (N - m)
    k = torch.arange(K, device=dev)
    v = m + torch.div(k, m, rounding_mode="floor")
    # slot 2j of the list holds edge j's new node, slot 2j + 1 its target
    span = 2 * m * (v - m)
    u = torch.rand(K, generator=gen, device=dev, dtype=torch.float64)
    r = (u * span).long().clamp_max(span - 1)
    first = v == m                    # node m attaches to 0 .. m - 1
    odd = (r % 2 == 1) & ~first
    half = torch.div(r, 2, rounding_mode="floor")
    dst = torch.where(first, k,
                      torch.where(odd, torch.full_like(k, -1),
                                  m + torch.div(half, m,
                                                rounding_mode="floor")))
    ptr = torch.where(odd, half, k)
    while True:
        todo = (dst < 0).nonzero().squeeze(1)
        if todo.numel() == 0:
            break
        p = ptr[todo]
        dst[todo] = dst[p]
        ptr[todo] = ptr[p]
    return v, dst


def powerlaw_graph_device(num_nodes: int, avg_degree: int, feature_dim: int,
                          edge_feature_dim: int, num_classes: int = 2,
                          seed: int = 0, device="cuda") -> dict:
    if num_classes != 2:
        raise ValueError("the power-law graph plants binary labels")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    N, m = int(num_nodes), max(1, int(avg_degree) // 2)
    a, b = _targets(N, m, gen, dev)
    key = torch.unique(torch.cat([a * N + b, b * N + a]))
    del a, b
    src, dst = torch.div(key, N, rounding_mode="floor"), key % N
    del key
    M = src.numel()
    ef = torch.randn(M, edge_feature_dim, generator=gen, device=dev)
    rel = torch.randint(0, max(1, edge_feature_dim // 2), (M,),
                        generator=gen, device=dev)
    ef[torch.arange(M, device=dev), rel] += 2.0
    del rel
    seeds = torch.randperm(N, generator=gen, device=dev)[:max(2, N // 100)]
    x = torch.randn(N, feature_dim, generator=gen, device=dev)
    perm = torch.randperm(N, generator=gen, device=dev).cpu().numpy()
    src_h = src.to(torch.int32).cpu().numpy()
    dst_h = dst.to(torch.int32).cpu().numpy()
    # the risk signal on the host in float64: a sequential sum, the same
    # bits every run
    strength = torch.sigmoid(ef[:, 0].double()).cpu().numpy()
    risk = np.zeros(N)
    risk[seeds.cpu().numpy()] = 1.0
    for _ in range(2):
        spread = np.bincount(dst_h, weights=risk[src_h] * strength,
                             minlength=N)
        risk = np.clip(risk + 0.5 * spread, 0, 4)
    labels = (risk > np.quantile(risk, 0.85)).astype(np.int32)
    x[:, 0] += torch.as_tensor(risk * 0.5, dtype=torch.float32, device=dev)
    tr = np.zeros(N, bool)
    tr[perm[:N // 2]] = True
    return {"src": src_h, "dst": dst_h, "num_nodes": N,
            "x": x.cpu().numpy(), "y": labels,
            "edge_attr": ef.cpu().numpy(), "train_mask": tr,
            "val_mask": np.zeros(N, bool), "test_mask": ~tr}


def make(cfg: dict, params: dict, seed: int, device) -> dict:
    """The configuration's graph: its nodes, node and edge feature widths
    and classes, with ``avg_degree`` from the traffic."""
    return powerlaw_graph_device(
        num_nodes=cfg["num_nodes"], feature_dim=cfg["feature_dim"],
        edge_feature_dim=cfg["edge_feature_dim"],
        num_classes=cfg["num_classes"], seed=seed, device=device, **params)
