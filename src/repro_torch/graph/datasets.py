"""Synthetic graph generators standing in for the paper's datasets.

A numpy copy of ``repro/graph/datasets.py``: for the same name, seed and
keyword arguments every array is bit-identical to the reference's.

- citation networks (Cora/Citeseer/Pubmed) -> ``citation_graph``;
- Reddit/Amazon -> ``sbm_graph`` with planted communities;
- Alipay -> ``powerlaw_graph``: preferential attachment, skewed degrees,
  edge features and binary risk labels.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import Graph


def _bidirect(src, dst):
    s = np.concatenate([src, dst]).astype(np.int32)
    d = np.concatenate([dst, src]).astype(np.int32)
    # dedupe
    key = s.astype(np.int64) * (max(int(s.max()), int(d.max())) + 1) + d
    _, idx = np.unique(key, return_index=True)
    return s[idx], d[idx], idx


def _masks(n, rng, train=0.6, val=0.2):
    order = rng.permutation(n)
    tr = np.zeros(n, bool)
    va = np.zeros(n, bool)
    te = np.zeros(n, bool)
    n_tr, n_va = int(n * train), int(n * val)
    tr[order[:n_tr]] = True
    va[order[n_tr:n_tr + n_va]] = True
    te[order[n_tr + n_va:]] = True
    return tr, va, te


def sbm_graph(num_nodes=1000, num_classes=4, feature_dim=64,
              p_in=0.02, p_out=0.002, feature_noise=1.0, seed=0,
              name="sbm") -> Graph:
    """Stochastic block model with class-prototype features."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes).astype(np.int32)
    srcs, dsts = [], []
    for a in range(num_classes):
        ia = np.where(labels == a)[0]
        for b in range(a, num_classes):
            ib = np.where(labels == b)[0]
            p = p_in if a == b else p_out
            n_pairs = len(ia) * len(ib)
            n_edges = rng.binomial(n_pairs, p)
            if n_edges == 0:
                continue
            s = ia[rng.integers(0, len(ia), n_edges)]
            d = ib[rng.integers(0, len(ib), n_edges)]
            keep = s != d
            srcs.append(s[keep])
            dsts.append(d[keep])
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    src, dst, _ = _bidirect(src, dst)
    protos = rng.normal(size=(num_classes, feature_dim)).astype(np.float32)
    feats = (protos[labels]
             + feature_noise * rng.normal(
                 size=(num_nodes, feature_dim)).astype(np.float32))
    tr, va, te = _masks(num_nodes, rng)
    return Graph(src, dst, num_nodes, feats.astype(np.float32), labels,
                 train_mask=tr, val_mask=va, test_mask=te, name=name)


def citation_graph(which: str = "cora", seed: int = 0) -> Graph:
    """Scaled synthetic stand-ins for the three citation networks."""
    spec = {
        # nodes, classes, feat_dim, p_in, p_out
        "cora": (1354, 7, 128, 0.008, 0.0004),
        "citeseer": (1650, 6, 128, 0.005, 0.0004),
        "pubmed": (2500, 3, 100, 0.004, 0.0004),
    }[which]
    n, c, f, p_in, p_out = spec
    # a fixed per-name offset (str hashes are salted per process)
    g = sbm_graph(n, c, f, p_in, p_out, feature_noise=1.5,
                  seed=seed + sum(which.encode()) % 1000, name=which)
    # bag-of-words flavour: sparsify + binarize features
    rng = np.random.default_rng(seed + 7)
    keep = rng.random(g.node_features.shape) < 0.3
    g.node_features = (np.where(g.node_features > 0.5, 1.0, 0.0)
                       * keep).astype(np.float32)
    tr, va, te = _masks(n, rng, train=0.15, val=0.25)
    g.train_mask, g.val_mask, g.test_mask = tr, va, te
    return g


def powerlaw_graph(num_nodes=20000, avg_degree=6, feature_dim=32,
                   edge_feature_dim=8, num_classes=2, seed=0,
                   name="alipay_like") -> Graph:
    """Preferential-attachment graph with skewed degrees + edge attributes;
    labels planted from a 2-hop risk signal (the Alipay task's shape)."""
    rng = np.random.default_rng(seed)
    m = max(1, avg_degree // 2)
    # Barabási–Albert via repeated-endpoint trick (degree-proportional)
    targets = list(range(m))
    repeated = []
    src_l, dst_l = [], []
    for v in range(m, num_nodes):
        if repeated:
            idx = rng.integers(0, len(repeated), m)
            chosen = {repeated[i] for i in idx}
        else:
            chosen = set(targets[:m])
        for t in chosen:
            src_l.append(v)
            dst_l.append(t)
            repeated.extend((v, t))
    src = np.array(src_l, np.int64)
    dst = np.array(dst_l, np.int64)
    src, dst, keep_idx = _bidirect(src, dst)
    M = len(src)
    # edge attributes: relation-type one-hot-ish + strength
    ef = rng.normal(size=(M, edge_feature_dim)).astype(np.float32)
    rel = rng.integers(0, edge_feature_dim // 2, M)
    ef[np.arange(M), rel] += 2.0
    # plant labels: seeds are "risky"; risk spreads along strong edges
    risk = np.zeros(num_nodes, np.float32)
    seeds = rng.choice(num_nodes, max(2, num_nodes // 100), replace=False)
    risk[seeds] = 1.0
    strength = 1.0 / (1.0 + np.exp(-ef[:, 0]))
    for _ in range(2):
        spread = np.zeros(num_nodes, np.float32)
        np.add.at(spread, dst, risk[src] * strength)
        risk = np.clip(risk + 0.5 * spread, 0, 4)
    labels = (risk > np.quantile(risk, 0.85)).astype(np.int32)
    feats = rng.normal(size=(num_nodes, feature_dim)).astype(np.float32)
    feats[:, 0] += risk * 0.5          # weak node-level signal
    tr, va, te = _masks(num_nodes, rng, train=0.5, val=0.0)
    return Graph(src, dst, num_nodes, feats, labels, edge_features=ef,
                 train_mask=tr, val_mask=va, test_mask=te, name=name)


DATASETS = ("cora", "citeseer", "pubmed", "reddit_like", "amazon_like",
            "alipay_like")


def make_dataset(name: str, seed: int = 0, **kw) -> Graph:
    if name in ("cora", "citeseer", "pubmed"):
        return citation_graph(name, seed)
    if name == "reddit_like":
        return sbm_graph(kw.pop("num_nodes", 4000), kw.pop("num_classes", 8),
                         kw.pop("feature_dim", 64), p_in=0.02, p_out=0.001,
                         seed=seed, name="reddit_like", **kw)
    if name == "amazon_like":
        return sbm_graph(kw.pop("num_nodes", 6000), kw.pop("num_classes", 10),
                         kw.pop("feature_dim", 64), p_in=0.012, p_out=0.0006,
                         seed=seed, name="amazon_like", **kw)
    if name == "alipay_like":
        return powerlaw_graph(seed=seed, **kw)
    raise ValueError(f"unknown dataset {name!r}")
