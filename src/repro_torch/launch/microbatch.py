"""Gradient-accumulation microbatching (the counterpart of
``repro/launch/microbatch.py``).

Splitting a global batch into micro-batches bounds activation memory by
the micro-batch size while keeping the optimizer math identical: the
mean of the per-micro gradients is the full batch's gradient for a mean
loss. The reference scans (or unrolls) over the micro-batches inside one
jitted function; here each micro-batch runs its forward and backward in
turn and the float32 sums stay on the device.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

# batch-dim index per input key (mrope positions carry a leading stream dim)
_BATCH_AXIS = {"mrope_positions": 1}


def split_batch(batch: Mapping[str, torch.Tensor], n_micro: int) -> dict:
    """Reshape every input to (n_micro, B/n_micro, ...) on its batch dim
    (axis 1 for ``mrope_positions``, 0 otherwise)."""
    out = {}
    for k, v in batch.items():
        ax = _BATCH_AXIS.get(k, 0)
        b = v.shape[ax]
        if b % n_micro != 0:
            raise ValueError(f"batch axis of {k} ({tuple(v.shape)}) must be "
                             f"a multiple of n_micro={n_micro}")
        v = v.reshape(v.shape[:ax] + (n_micro, b // n_micro)
                      + v.shape[ax + 1:])
        if ax:
            v = torch.movedim(v, ax, 0)
        out[k] = v
    return out


def microbatched_value_and_grad(loss_fn: Callable[[dict], torch.Tensor],
                                n_micro: int):
    """Returns ``fn(params, batch) -> (mean loss, mean grads)``:
    ``loss_fn(batch)`` is a scalar loss computed from the tensors of
    ``params`` (a dict of ``state_dict`` names to parameters, e.g.
    ``dict(model.named_parameters())``), and the gradients come back as
    a dict of the same names. With ``n_micro > 1`` the batch is split by
    :func:`split_batch`, each micro-batch's gradients are summed in
    float32, and the sums are scaled by ``1 / n_micro`` and cast to each
    parameter's dtype, as the reference does. A parameter that a loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it."""
    def grads_of(loss, params):
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        return {k: (torch.zeros_like(p) if g is None else g)
                for (k, p), g in zip(params.items(), got)}

    def fn(params: Mapping[str, torch.Tensor], batch: dict):
        if n_micro <= 1:
            loss = loss_fn(batch)
            return loss.detach(), grads_of(loss, params)
        mb = split_batch(batch, n_micro)
        acc_l = None
        acc_g: Dict[str, torch.Tensor] = {
            k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
        for i in range(n_micro):
            loss = loss_fn({k: v[i] for k, v in mb.items()})
            for k, g in grads_of(loss, params).items():
                acc_g[k] += g.float()
            loss = loss.detach().float()
            acc_l = loss if acc_l is None else acc_l + loss
        scale = 1.0 / n_micro
        return acc_l * scale, {k: (g * scale).to(params[k].dtype)
                               for k, g in acc_g.items()}

    return fn
