"""Dense building blocks, initialised from an explicit ``torch.Generator``,
and the classification loss.

Weights keep the reference's ``(in, out)`` layout (``y = x @ w + b``), so
parameters carried over from the JAX package load as they are.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn


def _fan_in_init(gen: torch.Generator, shape, scale: float = 1.0
                 ) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)) with fan_in = shape[0]."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / math.sqrt(fan_in)
    return torch.randn(tuple(shape), generator=gen,
                       dtype=torch.float32) * std


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True, scale: float = 1.0
               ) -> Dict[str, torch.Tensor]:
    p = {"w": _fan_in_init(gen, (in_dim, out_dim), scale)}
    if use_bias:
        p["b"] = torch.zeros(out_dim, dtype=torch.float32)
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


class Dense(nn.Module):
    """``x @ w + b`` with parameters named as the reference's dense dict."""

    def __init__(self, gen: torch.Generator, in_dim: int, out_dim: int,
                 use_bias: bool = True):
        super().__init__()
        for k, v in dense_init(gen, in_dim, out_dim, use_bias).items():
            self.register_parameter(k, nn.Parameter(v))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(self._parameters, x)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean cross-entropy over the (optionally masked) examples, in
    float32; ``labels`` are class ids. The masked mean divides by the mask
    sum clamped at 1, so an empty mask gives 0."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
