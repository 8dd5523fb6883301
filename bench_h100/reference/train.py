"""Plain training steps of a GNN: the model's forward pass
(``reference/<model>.py``, plain ``index_select`` and ``index_add_``),
its loss, autograd for the gradients and a plain Adam with L2 weight
decay.

A model's file declares what it needs; what it leaves out is the
default here. Always: ``edge_inputs(cfg, g, src, dst, device)``. Its
parameters: ``param_shapes(cfg)``, or by default a stack of
``num_layers`` layers of ``layer_shapes(cfg, fan_in)`` and a decoder to
``num_classes``. Each tensor's start: ``initial(name, shape)``. Its
forward pass: ``logits(cfg, p, g)``, or by default the stack of
``layer(p, pre, h, g, act)`` and the decoder. Its loss: ``loss(cfg,
logits, g)``, or by default the masked mean softmax cross-entropy.

Everything runs in float32 on the given device; ``tf32=True`` lets
float32 matrix products run in TF32 (the control that has to fail the
comparison). Parameters are named as the models' ``state_dict``s name
them."""
from __future__ import annotations

import math

import torch

from bench_h100.spec import piece


def model(cfg: dict):
    """The configuration's model, ``reference/<model>.py``."""
    return piece("reference", cfg["model"])


def _own(cfg: dict, name: str, default):
    """The model's own ``name``, or the default."""
    return getattr(model(cfg), name, default)


def param_shapes(cfg: dict) -> dict:
    """name -> shape of every trained tensor of the configuration's
    model: the model's ``param_shapes``, or :func:`stack_shapes`."""
    return dict(_own(cfg, "param_shapes", stack_shapes)(cfg))


def stack_shapes(cfg: dict) -> dict:
    """Per layer ``k`` the layer's own tensors, then the decoder."""
    K, D = cfg["num_layers"], cfg["hidden_dim"]
    dims = [cfg["feature_dim"]] + [D] * K
    out = {}
    for k in range(K):
        for name, shape in model(cfg).layer_shapes(cfg, dims[k]).items():
            out[f"layers.{k}.{name}"] = shape
    out["decoder.w"] = (D, cfg["num_classes"])
    out["decoder.b"] = (cfg["num_classes"],)
    return out


def initial(name: str, shape: tuple):
    """A tensor's start: ``"normal"`` (the seeded normal over the square
    root of its first axis) for a matrix, else the constant 0.0."""
    return "normal" if len(shape) >= 2 else 0.0


def make_params(cfg: dict, seed: int, device) -> dict:
    """The initial parameters from the seed, in one draw on the device
    over the sorted names: each tensor that the model's ``initial``
    makes ``"normal"`` takes its slice over sqrt(its first axis); a
    constant one drops its slice, so the others' bits stay the same."""
    shapes = param_shapes(cfg)
    start = _own(cfg, "initial", initial)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for n, part in zip(names, flat.split(sizes)):
        shape = tuple(shapes[n])
        how = start(n, shape)
        if how == "normal":
            out[n] = (part.reshape(shape) / math.sqrt(shape[0])).contiguous()
        else:
            out[n] = torch.full(shape, float(how), device=device)
    return out


def stack_logits(cfg: dict, p: dict, g: dict) -> torch.Tensor:
    """The stack of the model's layers, then the decoder."""
    h, K = g["x"], cfg["num_layers"]
    layer = model(cfg).layer
    for k in range(K):
        h = layer(p, f"layers.{k}.", h, g, k != K - 1)
    return h @ p["decoder.w"] + p["decoder.b"]


def softmax_loss(cfg: dict, logits: torch.Tensor, g: dict) -> torch.Tensor:
    """The masked mean softmax cross-entropy over ``long`` labels."""
    nll = torch.logsumexp(logits, -1) - logits.gather(
        1, g["y"][:, None]).squeeze(1)
    m = g["mask"]
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def loss(cfg: dict, p: dict, g: dict) -> torch.Tensor:
    """The model's loss on the graph ``g`` (tensors on one device: ``x``,
    ``src``, ``dst``, ``y``, ``mask``, and what the model's
    ``edge_inputs`` adds): its ``logits``, then its ``loss``."""
    logits = _own(cfg, "logits", stack_logits)(cfg, p, g)
    return _own(cfg, "loss", softmax_loss)(cfg, logits, g)


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
    """A step's graph on the device: the node rows, the labels (a class
    a node as ``long``, or a row of task targets as float32), the loss
    mask, and the edges with what the model adds to them
    (``edge_inputs``)."""
    def t(a, dtype=None):
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    src, dst = t(g["src"], torch.long), t(g["dst"], torch.long)
    y = t(g["y"])
    out = {"x": t(g["x"], torch.float32),
           "y": y.long() if y.dim() == 1 else y.float(),
           "mask": t(g["loss_mask"], torch.float32)}
    out.update(model(cfg).edge_inputs(cfg, g, src, dst, device))
    return out
