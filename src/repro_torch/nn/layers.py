"""Dense building blocks, initialised from an explicit ``torch.Generator``
(on the generator's device), the LM zoo's norms, embedding and SwiGLU,
the classification losses, dropout, and Whisper's LayerNorm and GELU
MLP.

Weights keep the reference's ``(in, out)`` layout (``y = x @ w + b``), so
parameters carried over from the JAX package load as they are. The LM
blocks keep the reference's functional form: ``*_init`` returns a dict
of tensors, :class:`ParamTree` holds such a dict as an ``nn.Module``,
and ``*_apply(p, x)`` reads it by key.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _fan_in_init(gen: torch.Generator, shape, scale: float = 1.0,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)) with fan_in = shape[0], drawn in
    float32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return w.to(dtype)


def glorot(shape, dtype: torch.dtype = torch.float32,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot-uniform in ``+-sqrt(6 / (fan_in + fan_out))`` with
    ``fan_in, fan_out = shape[0], shape[-1]``, drawn in float32 on the
    generator's device from ``generator`` (the reference's JAX key) and
    cast to ``dtype``."""
    fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    device = generator.device if generator is not None else None
    w = torch.rand(tuple(shape), generator=generator, device=device,
                   dtype=torch.float32)
    return (w * (2 * limit) - limit).to(dtype)


# -- products over fixed row tiles ---------------------------------------------

_tiles = threading.local()


@contextlib.contextmanager
def fixed_row_tiles(rows: int):
    """Within the block, on this thread, :func:`matmul` computes every
    product over tiles of exactly ``rows`` rows (the last one padded with
    zeros). cuBLAS picks its GEMM kernel, and so its order of summation,
    by the product's shape; with one fixed row count a row's result no
    longer depends on how many rows came with it. The GNN server uses it
    so that a cache hit (top layer on a small block) equals a full
    recompute (top layer inside a larger one) bit for bit."""
    prev = getattr(_tiles, "rows", 0)
    _tiles.rows = int(rows)
    try:
        yield
    finally:
        _tiles.rows = prev


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``x``, over fixed row tiles inside
    :func:`fixed_row_tiles`."""
    t = getattr(_tiles, "rows", 0)
    if not t or x.dim() != 2:
        return x @ w
    n = x.shape[0]
    pad = (-n) % t
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    return torch.cat([x[i:i + t] @ w for i in range(0, n + pad, t)])[:n]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True, scale: float = 1.0,
               dtype: torch.dtype = torch.float32
               ) -> Dict[str, torch.Tensor]:
    p = {"w": _fan_in_init(gen, (in_dim, out_dim), scale, dtype)}
    if use_bias:
        p["b"] = torch.zeros(out_dim, dtype=dtype, device=gen.device)
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
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


def binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean binary cross-entropy on logits in float32, in the stable
    form ``max(x, 0) - x * y + log1p(exp(-|x|))``; the masked mean
    divides by the mask sum clamped at 1."""
    logits = logits.float()
    labels = labels.float()
    nll = (torch.clamp_min(logits, 0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 -
    rate`` and scaled by ``1 / (1 - rate)``, the rest zero; ``x`` itself
    when ``deterministic`` or ``rate`` is 0. The mask is drawn from
    ``generator`` (on ``x``'s device), which takes the place of the
    reference's JAX key: the same generator state gives the same mask,
    though not JAX's bits."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


# -- the LM zoo's building blocks ----------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: tensors become
    parameters, dicts child trees, so the ``state_dict`` keys are the
    reference's pytree paths joined with ``.``. ``p["name"]`` and
    ``"name" in p`` read it as the functional code reads a dict."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def rmsnorm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, rounded to x's dtype once."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, dim: int,
                   dtype=torch.float32):
    return {"table": (torch.randn((vocab, dim), generator=gen,
                                  device=gen.device, dtype=torch.float32)
                      * 0.02).to(dtype)}


def embedding_apply(p, ids: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``ids``."""
    return p["table"][ids]


def unembed_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Logits through the (possibly tied) embedding table."""
    return x @ p["table"].T.to(x.dtype)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    return {
        "wi_gate": _fan_in_init(gen, (d_model, d_ff), dtype=dtype),
        "wi_up": _fan_in_init(gen, (d_model, d_ff), dtype=dtype),
        "wo": _fan_in_init(gen, (d_ff, d_model), dtype=dtype),
    }


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["wi_gate"])
    u = x @ p["wi_up"]
    return (g * u) @ p["wo"]


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32):
    return {"wi": dense_init(gen, d_model, d_ff, dtype=dtype),
            "wo": dense_init(gen, d_ff, d_model, dtype=dtype)}


def gelu_mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP. ``jax.nn.gelu`` defaults to the tanh approximation,
    which the reference calls; the exact erf form parts from it by up to
    4.7e-4 an element."""
    return dense_apply(p["wo"], F.gelu(dense_apply(p["wi"], x),
                                       approximate="tanh"))
