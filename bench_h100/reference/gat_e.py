"""Plain GAT-E (the paper's edge-attributed attention): a node transform,
attention logits from both endpoints' halves and the edge's attributes,
a softmax over each node's incoming edges, and a weighted sum of the
source's row plus the edge's value; ELU between layers."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_shapes(cfg: dict, fan_in: int) -> dict:
    D, H, De = cfg["hidden_dim"], cfg["num_heads"], cfg["edge_feature_dim"]
    return {"w": (fan_in, D), "b": (D,), "a_src": (H, D // H),
            "a_dst": (H, D // H), "w_e_att": (De, H), "w_e_val": (De, D)}


def edge_inputs(cfg: dict, g: dict, src, dst, device) -> dict:
    return {"src": src, "dst": dst,
            "edge_attr": torch.as_tensor(g["edge_attr"]).to(
                device=device, dtype=torch.float32)}


def layer(p: dict, pre: str, h, g: dict, act: bool):
    src, dst, ea = g["src"], g["dst"], g["edge_attr"]
    N = h.shape[0]
    H, hd = p[pre + "a_src"].shape
    n = (h @ p[pre + "w"]).reshape(N, H, hd)
    a_s = (n * p[pre + "a_src"]).sum(-1)
    a_d = (n * p[pre + "a_dst"]).sum(-1)
    logit = F.leaky_relu(a_s.index_select(0, src) + a_d.index_select(0, dst)
                         + ea @ p[pre + "w_e_att"], 0.2)
    value = n.index_select(0, src) + (ea @ p[pre + "w_e_val"]).reshape(
        -1, H, hd)
    # softmax over each node's incoming edges; the row max only steadies
    # the exponentials and takes no gradient
    top = torch.full((N, H), float("-inf"), device=h.device).scatter_reduce(
        0, dst[:, None].expand(-1, H), logit.detach(), "amax")
    ex = torch.exp(logit - top.index_select(0, dst))
    den = torch.zeros(N, H, device=h.device).index_add(0, dst, ex)
    num = torch.zeros(N, H, hd, device=h.device).index_add(
        0, dst, ex[..., None] * value)
    out = (num / den.clamp_min(1e-30)[..., None]).reshape(N, H * hd) \
        + p[pre + "b"]
    return F.elu(out) if act else out
