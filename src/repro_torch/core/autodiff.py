"""Explicit NN-TGAR backward schedule (paper §3.3, App. A.2/A.3; the
counterpart of ``repro/core/autodiff.py``).

GraphTheta implements auto-differentiation by pairing every stage with a
backward version and executing K+2 reverse passes of NN-TGAR: the gradient
of a node flows to its in-neighbors along reversed edges ("if a node
aggregates information from its neighbor along every out-edge in the
forward, it aggregates gradient along every in-edge in the backward").

This module runs that schedule stage by stage in the paper's order
instead of one ``backward()`` over the whole model. Each stage runs on
detached inputs that require a gradient, so its graph ends at them, and
its vector-Jacobian product is one ``torch.autograd.grad`` over that
graph. (``torch.func.vjp`` would be the closer analogue of ``jax.vjp``,
but it refuses ``autograd.Function``s written in the ``forward(ctx,
...)`` style, which the Sum-stage kernels are.) The training path uses
``backward()``; this is the reference semantics, and the tests hold it
to autograd's gradients.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.core import aggregate as agg
from repro_torch.core.mpgnn import MPGNNModel
from repro_torch.core.tgar import tree_take
from repro_torch.nn.layers import softmax_cross_entropy


def _leaf(t: torch.Tensor, grad: bool = True) -> torch.Tensor:
    return t.detach().requires_grad_(grad)


def _leaves(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: _leaf(v) for k, v in tree.items()}


def _vjp(outputs, cotangents, inputs: Sequence[torch.Tensor]) -> List:
    """``d inputs`` of one stage: the cotangents pulled back through the
    stage's graph, for the outputs that have one (None where an input
    does not reach the outputs). Consumes the graph."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents)
             if c is not None and o.requires_grad]
    if not pairs:
        return [None] * len(inputs)
    outs, cots = zip(*pairs)
    return list(torch.autograd.grad(outs, inputs, cots, allow_unused=True))


def _stage_masks(block, k):
    em = block.edge_mask
    if block.edge_active is not None:
        em = em * block.edge_active[k]
    na = None
    if block.node_active is not None:
        na = block.node_active[k]
    return em, na


def explicit_loss_and_grad(model: MPGNNModel, block):
    """Forward (keeping each stage's graph) + the explicit reverse
    schedule. Returns ``(loss, grads)``: the loss as a 0-d tensor and a
    dict of gradients keyed as ``model.named_parameters()``, equal to what
    ``loss_block(model, block).backward()`` leaves in ``.grad``."""
    n_pad = block.num_nodes_padded
    params = dict(model.named_parameters())
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    names = {id(p): k for k, p in params.items()}

    def reduce(module, d_params) -> None:
        """NN-Reduce: a stage's parameter gradients into the total."""
        for p, d in zip(module.parameters(), d_params):
            if d is not None:
                grads[names[id(p)]] += d

    # ---------------- forward: K passes of NN-TGA, keep stage graphs --------
    h = block.x
    stages = []
    for k, layer in enumerate(model.layers):
        em, na = _stage_masks(block, k)
        # layer 0's input is the features: no gradient to take there
        h_in = _leaf(h, grad=k > 0)
        n = layer.transform(h_in)                                 # NN-T
        n_in = _leaves(n)
        msg = layer.gather(tree_take(n_in, block.src, block.src_plan),
                           tree_take(n_in, block.dst, block.csc_plan),
                           block.edge_attr, block.edge_weight, em)  # NN-G
        msg_in = _leaves(msg)
        M = agg.combine(layer.combine, msg_in, block.dst, n_pad, em,
                        backend=model.aggregate_backend,
                        plan=block.csc_plan)                      # Sum
        M_in = _leaf(M)
        h_next = layer.node_apply(h_in, M_in)                     # NN-A
        if na is not None:
            h_next = h_next * na[:, None]
        h_next = h_next * block.node_mask[:, None]
        stages.append((layer, h_in, n, n_in, msg, msg_in, M, M_in, h_next))
        h = h_next

    # ---------------- decoder + loss: two NN-T stages ------------------------
    h_dec = _leaf(h)
    logits = model.decode(h_dec)
    logits_in = _leaf(logits)
    loss = softmax_cross_entropy(logits_in, block.y, block.loss_mask)

    # ---------------- backward: reverse schedule ------------------------------
    # loss NN-T backward
    (d_logits,) = _vjp([loss], [torch.ones_like(loss)], [logits_in])
    # decoder NN-T backward (+ its parameter grads -> NN-Reduce)
    dec_params = list(model.decoder.parameters())
    *d_dec, d_h = _vjp([logits], [d_logits], dec_params + [h_dec])
    reduce(model.decoder, d_dec)

    for layer, h_in, n, n_in, msg, msg_in, M, M_in, h_next in reversed(
            stages):
        lp = list(layer.parameters())
        grad_h = [h_in] if h_in.requires_grad else []
        # NN-T stage of the backward pass = derivative of Apy_k (Fig. 3b)
        d = _vjp([h_next], [d_h], lp + grad_h + [M_in])
        reduce(layer, d[:len(lp)])
        d_h_in_a = d[len(lp)] if grad_h else None
        d_M = d[-1]
        # NN-G stage = derivative of Acc_k & Prop_k: gradient flows along
        # reversed edges to source/destination nodes
        keys = list(msg_in)
        d_msg = _vjp([M], [d_M], [msg_in[k] for k in keys])
        nkeys = list(n_in)
        d = _vjp([msg[k] for k in keys], d_msg,
                 lp + [n_in[k] for k in nkeys])
        reduce(layer, d[:len(lp)])
        d_n = d[len(lp):]
        # NN-A stage = derivative of Proj_k, back to node embeddings
        d = _vjp([n[k] for k in nkeys], d_n, lp + grad_h)
        reduce(layer, d[:len(lp)])
        d_h_prev = d[len(lp)] if grad_h else None
        # the gradient of the layer's input sums over both of its uses
        parts = [x for x in (d_h_in_a, d_h_prev) if x is not None]
        d_h = sum(parts[1:], parts[0]) if parts else None
    return loss.detach(), grads
