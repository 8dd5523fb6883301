"""A test model that declares its whole yardstick in its own file: an
input encoder, one residual layer that aggregates edge messages by a
softmax with a learned temperature and normalises its update with a
LayerNorm, a decoder to T tasks and a masked mean binary cross-entropy.
No cell runs it; the tests load it by name to show that a model's file
alone carries a deep, normalised, multi-label GNN."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def param_shapes(cfg: dict) -> dict:
    F_, D = cfg["feature_dim"], cfg["hidden_dim"]
    De, T = cfg["edge_feature_dim"], cfg["num_tasks"]
    return {"encoder.w": (F_, D), "encoder.b": (D,),
            "layers.0.edge.w": (De, D), "layers.0.edge.b": (D,),
            "layers.0.t": (),
            "layers.0.mlp.w": (D, D), "layers.0.mlp.b": (D,),
            "layers.0.norm.gain": (D,), "layers.0.norm.bias": (D,),
            "decoder.w": (D, T), "decoder.b": (T,)}


def initial(name: str, shape: tuple):
    """A LayerNorm's gain and the temperature start at 1, the other
    vectors at 0, the matrices normal."""
    if name.endswith((".gain", ".t")):
        return 1.0
    return "normal" if len(shape) >= 2 else 0.0


def edge_inputs(cfg: dict, g: dict, src, dst, device) -> dict:
    return {"src": src, "dst": dst,
            "edge_attr": torch.as_tensor(g["edge_attr"]).to(
                device=device, dtype=torch.float32)}


def logits(cfg: dict, p: dict, g: dict) -> torch.Tensor:
    src, dst, ea = g["src"], g["dst"], g["edge_attr"]
    h = g["x"] @ p["encoder.w"] + p["encoder.b"]
    N, D = h.shape
    m = F.relu(h.index_select(0, src) + ea @ p["layers.0.edge.w"]
               + p["layers.0.edge.b"]) + 1e-7
    s = p["layers.0.t"] * m
    # softmax over each node's incoming edges, channel by channel
    top = torch.full((N, D), float("-inf"), device=h.device).scatter_reduce(
        0, dst[:, None].expand(-1, D), s.detach(), "amax")
    ex = torch.exp(s - top.index_select(0, dst))
    den = torch.zeros(N, D, device=h.device).index_add(0, dst, ex)
    M = torch.zeros(N, D, device=h.device).index_add(
        0, dst, ex * m) / den.clamp_min(1e-30)
    u = (h + M) @ p["layers.0.mlp.w"] + p["layers.0.mlp.b"]
    u = F.layer_norm(u, (D,), p["layers.0.norm.gain"],
                     p["layers.0.norm.bias"])
    h = h + F.relu(u)
    return h @ p["decoder.w"] + p["decoder.b"]


def loss(cfg: dict, logits: torch.Tensor, g: dict) -> torch.Tensor:
    """The mean over tasks of each node's binary cross-entropy, masked
    and averaged over nodes."""
    nll = F.binary_cross_entropy_with_logits(
        logits, g["y"], reduction="none").mean(1)
    m = g["mask"]
    return (nll * m).sum() / m.sum().clamp_min(1.0)
