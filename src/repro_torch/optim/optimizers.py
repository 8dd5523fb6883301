"""Hand-written optimizers (the paper ships SGD, Adam and AdamW — §4), the
counterpart of ``repro/optim/optimizers.py``.

Functional interface over a model's named parameters::

    opt = adam(lr=1e-3)
    params = dict(model.named_parameters())
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

``params``, ``grads`` and the moments are dicts keyed by ``state_dict``
names. Unlike the reference, whose arrays are immutable, ``update``
writes the new parameters and moments in place under ``torch.no_grad()``
(no second copy of the model on the card) and returns the same dicts.
The arithmetic follows the reference step for step, in float32: the
schedule is read at the step before the increment, L2 decay joins the
gradient for ``adam`` while ``adamw`` adds the decoupled ``wd * p`` to
the update, the bias corrections use a float32 step, and the update is
``(m / bc1) / (sqrt(v / bc2) + eps)``. ``torch.optim.Adam`` folds the
corrections into the step size instead, which rounds differently.

The per-step scalars (the schedule's rate and Adam's bias corrections)
are computed on the host in float32 (``Optimizer.scalars``) and reach
the arithmetic as a small float32 tensor on the parameters' device
(``Optimizer.apply``), never as Python numbers baked into a kernel's
arguments: a CUDA graph captured over ``apply`` reads the tensor, which
the trainer rewrites before each replay (:func:`write_scalars`), so
eager steps and replays compute the same thing. ``state["step"]`` stays
a host int.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_global_norm

Schedule = Callable[[int], float]
_f32 = np.float32


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(_f32(lr))


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1
                    ) -> Schedule:
    def f(step):
        t = np.clip(_f32(step) / _f32(max(total_steps, 1)), _f32(0), _f32(1))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * t))
        return float(_f32(lr) * (_f32(final_frac)
                                 + _f32(1 - final_frac) * cos))
    return f


def warmup_cosine_schedule(lr: float, warmup: int, total_steps: int,
                           final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        if step < warmup:
            return float(_f32(lr) * np.minimum(
                _f32(step) / _f32(max(warmup, 1)), _f32(1)))
        return cos(step - warmup)
    return f


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-12)), norm)``."""
    norm = tree_global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def write_scalars(dst: torch.Tensor, values) -> None:
    """Write host float32 ``values`` into the float32 tensor ``dst``; on
    the card through pinned memory, without waiting for the device."""
    src = torch.tensor(values, dtype=torch.float32,
                       pin_memory=dst.is_cuda)
    dst.copy_(src, non_blocking=dst.is_cuda)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Mapping[str, torch.Tensor]], Dict[str, Any]]
    # (grads, state, params) -> (params, state), updated in place
    update: Callable[..., Any]
    name: str = "opt"
    # (state) -> this step's host scalars, float32 values
    scalars: Optional[Callable[[Mapping], tuple]] = None
    # (grads, state, params, scal) -> None: the update in place, reading
    # the scalars from ``scal``, a float32 tensor on the params' device;
    # state["step"] is left to the caller
    apply: Optional[Callable[..., None]] = None


def _optimizer(init, scalars, apply, name: str) -> Optimizer:
    """An Optimizer whose ``update`` writes ``scalars(state)`` into a
    tensor on the parameters' device and runs ``apply`` over it."""
    def update(grads, state, params):
        dev = next(iter(params.values())).device
        vals = scalars(state)
        scal = torch.empty(len(vals), dtype=torch.float32, device=dev)
        write_scalars(scal, vals)
        apply(grads, state, params, scal)
        state["step"] += 1
        return params, state
    return Optimizer(init, update, name, scalars, apply)


def _to_sched(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


def _zeros(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def sgd(lr=1e-2, momentum: float = 0.0, weight_decay: float = 0.0,
        grad_clip: float = 0.0) -> Optimizer:
    sched = _to_sched(lr)

    def init(params):
        state = {"step": 0}
        if momentum:
            state["mu"] = _zeros(params)
        return state

    def scalars(state):
        return (sched(state["step"]),)

    @torch.no_grad()
    def apply(grads, state, params, scal):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t = scal[0]
        if weight_decay:
            grads = {k: g + weight_decay * params[k]
                     for k, g in grads.items()}
        for k, p in params.items():
            if momentum:
                mu = state["mu"][k]
                mu.mul_(momentum).add_(grads[k])
                p.sub_(lr_t * mu)
            else:
                p.sub_(lr_t * grads[k])

    return _optimizer(init, scalars, apply, "sgd")


def _adam_like(lr, b1, b2, eps, weight_decay, decoupled, grad_clip, name):
    sched = _to_sched(lr)

    def init(params):
        return {"step": 0, "m": _zeros(params), "v": _zeros(params)}

    def scalars(state):
        stepf = _f32(state["step"] + 1)
        return (sched(state["step"]),
                float(_f32(1) - _f32(b1) ** stepf),
                float(_f32(1) - _f32(b2) ** stepf))

    @torch.no_grad()
    def apply(grads, state, params, scal):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr_t, bc1, bc2 = scal[0], scal[1], scal[2]
        if weight_decay and not decoupled:   # classic L2 (paper's Adam)
            grads = {k: g + weight_decay * params[k]
                     for k, g in grads.items()}
        for k, p in params.items():
            g = grads[k]
            m = state["m"][k].mul_(b1).add_((1 - b1) * g)
            v = state["v"][k].mul_(b2).add_((1 - b2) * torch.square(g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and decoupled:   # AdamW
                u = u + weight_decay * p
            p.sub_(lr_t * u)

    return _optimizer(init, scalars, apply, name)


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
         grad_clip: float = 0.0) -> Optimizer:
    return _adam_like(lr, b1, b2, eps, weight_decay, False, grad_clip, "adam")


def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          grad_clip: float = 0.0) -> Optimizer:
    return _adam_like(lr, b1, b2, eps, weight_decay, True, grad_clip, "adamw")


def make_optimizer(name: str, lr, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(lr, momentum=0.9, weight_decay=weight_decay,
                   grad_clip=grad_clip)
    if name == "adam":
        return adam(lr, weight_decay=weight_decay, grad_clip=grad_clip)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay or 0.01,
                     grad_clip=grad_clip)
    raise ValueError(f"unknown optimizer {name!r}")
