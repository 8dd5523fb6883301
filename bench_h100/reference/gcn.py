"""Plain GCN: a node transform, then each node's sum over its incoming
edges and a self-loop, each message scaled by 1 / sqrt(d_src d_dst) (d a
node's in-degree plus one); ReLU between layers."""
from __future__ import annotations

import torch
import torch.nn.functional as F

EDGE_CHUNK = 1 << 22       # edges a block of the message passing holds


def layer_shapes(cfg: dict, fan_in: int) -> dict:
    return {"w": (fan_in, cfg["hidden_dim"]), "b": (cfg["hidden_dim"],)}


def gcn_norm(src: torch.Tensor, dst: torch.Tensor, N: int) -> torch.Tensor:
    """1 / sqrt(d_src d_dst), d a node's in-degree plus one, worked out in
    float64."""
    deg = torch.bincount(dst.long(), minlength=N).double() + 1.0
    return (1.0 / torch.sqrt(deg[src.long()] * deg[dst.long()])).float()


def edge_inputs(cfg: dict, g: dict, src, dst, device) -> dict:
    """The graph's edges plus a self-loop at every node, and the norm
    over them."""
    N = int(g["num_nodes"])
    loops = torch.arange(N, device=device)
    src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    return {"src": src, "dst": dst, "norm": gcn_norm(src, dst, N)}


def layer(p: dict, pre: str, h, g: dict, act: bool):
    src, dst, norm = g["src"], g["dst"], g["norm"]
    n = h @ p[pre + "w"]
    M = torch.zeros(h.shape[0], n.shape[1], device=h.device)
    for a in range(0, src.numel(), EDGE_CHUNK):
        b = min(src.numel(), a + EDGE_CHUNK)
        M = M.index_add(0, dst[a:b],
                        n.index_select(0, src[a:b]) * norm[a:b, None])
    out = M + p[pre + "b"]
    return F.relu(out) if act else out
