"""Plain training steps of a GNN: the model's layers
(``reference/<model>.py``, plain ``index_select`` and ``index_add_``),
the masked mean cross-entropy, autograd for the gradients and a plain
Adam with L2 weight decay.

Everything runs in float32 on the given device; ``tf32=True`` lets
float32 matrix products run in TF32 (the control that has to fail the
comparison). Parameters are named as the models' ``state_dict``s name
them."""
from __future__ import annotations

import math

import torch

from bench_h100.spec import piece


def model(cfg: dict):
    """The configuration's model, ``reference/<model>.py``: its
    ``layer_shapes(cfg, fan_in)``, ``layer(p, pre, h, g, act)`` and
    ``edge_inputs(cfg, g, src, dst, device)``."""
    return piece("reference", cfg["model"])


def param_shapes(cfg: dict) -> dict:
    """name -> shape of every trained tensor of the configuration's
    model: per layer ``k`` the layer's own, then the decoder."""
    K, D = cfg["num_layers"], cfg["hidden_dim"]
    dims = [cfg["feature_dim"]] + [D] * K
    out = {}
    for k in range(K):
        for name, shape in model(cfg).layer_shapes(cfg, dims[k]).items():
            out[f"layers.{k}.{name}"] = shape
    out["decoder.w"] = (D, cfg["num_classes"])
    out["decoder.b"] = (cfg["num_classes"],)
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """The initial parameters from the seed, in one draw on the device:
    each matrix normal with standard deviation 1/sqrt(its first axis),
    each bias zero."""
    shapes = param_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for n, part in zip(names, flat.split(sizes)):
        shape = shapes[n]
        if len(shape) == 1:
            out[n] = torch.zeros(shape, device=device)
        else:
            out[n] = (part.reshape(shape) / math.sqrt(shape[0])).contiguous()
    return out


def loss(cfg: dict, p: dict, g: dict) -> torch.Tensor:
    """The masked mean cross-entropy of the model on the graph ``g``
    (tensors on one device: ``x``, ``src``, ``dst``, ``y``, ``mask``,
    and what the model's ``edge_inputs`` adds)."""
    h, K = g["x"], cfg["num_layers"]
    layer = model(cfg).layer
    for k in range(K):
        h = layer(p, f"layers.{k}.", h, g, k != K - 1)
    logits = h @ p["decoder.w"] + p["decoder.b"]
    nll = torch.logsumexp(logits, -1) - logits.gather(
        1, g["y"][:, None]).squeeze(1)
    m = g["mask"]
    return (nll * m).sum() / m.sum().clamp_min(1.0)


class Adam:
    """Adam with L2 decay added to the gradient; bias corrections in
    float32."""

    def __init__(self, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (
            lr, weight_decay, b1, b2, eps)
        self.t = 0
        self.m, self.v = {}, {}

    @torch.no_grad()
    def step(self, p: dict, grads: dict) -> dict:
        """Updates ``p`` in place; returns the gradients as the update
        took them (with the decay term)."""
        self.t += 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** self.t
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** self.t
        taken = {}
        for k in p:
            g = grads[k] + self.wd * p[k]
            taken[k] = g
            m = self.m.get(k, torch.zeros_like(g)) * self.b1 \
                + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * self.b2 \
                + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            u = (m / bc1.item()) / (torch.sqrt(v / bc2.item()) + self.eps)
            p[k] -= self.lr * u
        return taken


def train_steps(cfg: dict, params0: dict, graphs, device,
                tf32: bool = False) -> dict:
    """Three (or ``len(graphs)``) steps of training from ``params0`` (host
    tensors), step ``i`` on ``graphs[i]`` (host arrays, see
    :func:`to_device`). Returns ``losses``, ``grad1`` (the first
    gradients as Adam took them) and ``change`` (each parameter's change
    over the steps), on the host."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        p = {k: v.to(device, copy=True).requires_grad_(True)
             for k, v in params0.items()}
        opt = Adam(cfg["lr"], cfg["weight_decay"])
        losses, grad1 = [], None
        for g in graphs:
            gd = to_device(cfg, g, device)
            for t in p.values():
                t.grad = None
            value = loss(cfg, p, gd)
            value.backward()
            del gd
            taken = opt.step(p, {k: t.grad for k, t in p.items()})
            losses.append(float(value.detach()))
            if grad1 is None:
                grad1 = {k: t.cpu() for k, t in taken.items()}
        change = {k: (p[k].detach() - params0[k].to(device)).cpu()
                  for k in p}
        return {"losses": losses, "grad1": grad1, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def to_device(cfg: dict, g: dict, device) -> dict:
    """A step's graph on the device: the node rows, the loss mask, and
    the edges with what the model adds to them (``edge_inputs``)."""
    def t(a, dtype=None):
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    src, dst = t(g["src"], torch.long), t(g["dst"], torch.long)
    out = {"x": t(g["x"], torch.float32), "y": t(g["y"], torch.long),
           "mask": t(g["loss_mask"], torch.float32)}
    out.update(model(cfg).edge_inputs(cfg, g, src, dst, device))
    return out
