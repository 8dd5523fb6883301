"""Mixture-of-Experts FFN: the router and dense dispatch (the counterpart
of ``repro/arch/moe.py``).

``moe_ffn_dense``, the reference's default ``moe_impl``: every expert
runs on every token and the outputs are weighted by the renormalized
top-k router gates. It spends ``num_experts / top_k`` times the expert
FLOPs of sparse routing, by the reference's design. The reference has no
kernel here; the products are plain matrix products.

``moe_ffn_ep`` (expert parallelism: routed tokens move between cards by
``all_to_all``) needs more than one card and waits for ROADMAP A.13.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import _fan_in_init


def moe_init(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype) -> dict:
    """The router, float32 whatever ``dtype`` is (as the reference's), and
    the experts' SwiGLU weights ``(E, d_in, d_out)``. ``_fan_in_init``
    takes fan_in from ``shape[0]``, which for the expert stacks is E: the
    reference draws them so, and the port copies it."""
    return {
        "router": _fan_in_init(gen, (d_model, num_experts),
                               dtype=torch.float32),
        "wi_gate": _fan_in_init(gen, (num_experts, d_model, d_ff),
                                dtype=dtype),
        "wi_up": _fan_in_init(gen, (num_experts, d_model, d_ff),
                              dtype=dtype),
        "wo": _fan_in_init(gen, (num_experts, d_ff, d_model), dtype=dtype),
    }


def top_k_mask(probs: torch.Tensor, k: int) -> torch.Tensor:
    """1.0 on the ``k`` largest entries of the last axis, 0.0 elsewhere,
    in ``probs``' dtype: the experts ``jax.lax.top_k`` picks, which on a
    tie takes the lower index first (``torch.topk`` does not promise
    it). An entry is picked when fewer than ``k`` entries rank above it:
    the larger ones, and the equal ones at lower indices."""
    E = probs.shape[-1]
    a = probs[..., :, None]                     # entry e
    b = probs[..., None, :]                     # against entry j
    lower = torch.ones((E, E), dtype=torch.bool,
                       device=probs.device).tril(-1)   # [e, j]: j < e
    above = (b > a) | ((b == a) & lower)
    return (above.sum(-1) < k).to(probs.dtype)


def router_gates(p, x: torch.Tensor, moe_cfg):
    """Renormalized top-k gates (B, S, E) in float32 and the Switch-style
    load-balance aux loss (a 0-d float32 tensor)."""
    logits = x.float() @ p["router"]                        # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    mask = top_k_mask(probs, moe_cfg.top_k)                 # (B, S, E) 0/1
    gated = probs * mask
    gated = gated / torch.clamp_min(gated.sum(-1, keepdim=True), 1e-9)
    frac = mask.mean(dim=(0, 1))                            # routed share
    prob = probs.mean(dim=(0, 1))
    aux = probs.shape[-1] * torch.sum(frac * prob)
    return gated, aux


def moe_ffn_dense(p, x: torch.Tensor, moe_cfg):
    """All experts on all tokens, gate-weighted combine; returns (out in
    x's dtype, aux). The reference's einsums ``bsd,edf->ebsf`` and
    ``ebsf,efd->ebsd`` are written as batched products over the expert
    axis, which read each expert's weights in place (``torch.einsum``
    would copy them into another layout first, on every call)."""
    gates, aux = router_gates(p, x, moe_cfg)                # (B, S, E)
    B, S, D = x.shape
    xt = x.reshape(1, B * S, D)
    # silu(h_g) * h_u with at most three (E, BS, F) tensors alive at once
    h = F.silu(torch.matmul(xt, p["wi_gate"]))              # (E, BS, F)
    h = h * torch.matmul(xt, p["wi_up"])
    y = torch.matmul(h, p["wo"]).reshape(-1, B, S, D)       # (E, B, S, D)
    out = torch.einsum("ebsd,bse->bsd", y, gates.to(y.dtype))
    return out.to(x.dtype), aux


def moe_ffn_ep(p, x: torch.Tensor, moe_cfg):
    """Expert-parallel dispatch (``repro/arch/moe.py:moe_ffn_ep``): not
    ported; it moves routed tokens between cards by ``all_to_all``."""
    raise NotImplementedError("moe_impl='ep' (expert parallelism over "
                              "all_to_all across cards) is not ported "
                              "yet (ROADMAP A.13)")
