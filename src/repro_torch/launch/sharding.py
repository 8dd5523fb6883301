"""Auto-FSDP sharding rules (the counterpart of
``repro/launch/sharding.py``): map every parameter, optimizer-state,
cache and input leaf to a spec on the production mesh.

GraphTheta's hybrid-parallel principle (one batch computed by the whole
worker group) maps here to: weights and optimizer state sharded over
``data`` and ``model``, activations batch-sharded over the data axes
(and ``pod``) and sequence-sharded over ``model`` between blocks
(:mod:`repro_torch.arch.hints`).

A spec is a tuple with one entry per dim: a mesh axis name, a tuple of
names (the data axes ``("pod", "data")`` together), or None. The rules
are the reference's, applied to the port's names and layouts: a model's
leaves are its ``state_dict`` names, and the port unrolls the
reference's stacked blocks (:func:`repro_torch.weights.
lm_params_from_jax`), so a leaf under ``blocks.``/``encoder.`` is the
reference's stacked leaf without its leading stack dim, and its spec is
the reference's without that dim's entry. The generic rule is greedy:
``model`` to the largest divisible dim, then the data axes to the
largest remaining divisible dim; an FFN's ``wi_gate``/``wi_up``/``wo``
of three or more dims in the reference's layout gets ``model`` on its
first dim first (the expert dim; a stacked dense SwiGLU's ``d_model``
dim, as the reference's rule reads it); biases and norm scales stay
whole. A cache leaf (the port's caches are one dict a layer) follows
its name's rule: ``k``/``v`` (B, S, H, hd) and ``c_kv``/``k_rope`` (B,
S, r) batch over the data axes and sequence over ``model``;
``state`` (B, H, ...) heads over ``model``; ``conv`` and ``last`` their
last dim; ``pos`` whole. Non-divisible dims are left whole, which is
what makes one set of rules fit every architecture. ``dp=()`` is the
serving layout: weights over ``model`` only.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

Spec = Tuple


def _dp_size(mesh, dp) -> int:
    return math.prod(mesh.shape[a] for a in dp)


def _dp_name(dp):
    return dp if len(dp) > 1 else dp[0]


def _div(n: int, axes_size: int) -> bool:
    return axes_size > 1 and n % axes_size == 0 and n >= axes_size


def _greedy_spec(shape, mesh, expert_dim: Optional[int], dp=("data",)
                 ) -> Spec:
    """``model`` to the largest divisible dim (``expert_dim`` first when
    ``model`` divides it), then the data axes to the largest remaining
    divisible one; ties go to the earlier dim."""
    model_n = mesh.shape["model"]
    data_n = _dp_size(mesh, dp) if dp else 1
    spec = [None] * len(shape)
    dims = list(range(len(shape)))
    used_model = False
    if expert_dim is not None and expert_dim < len(shape) \
            and shape[expert_dim] % model_n == 0:
        spec[expert_dim] = "model"
        used_model = True
        dims.remove(expert_dim)
    for want, n in (("model", model_n), ("data", data_n)):
        if (want == "model" and used_model) or n <= 1:
            continue
        cands = sorted((d for d in dims if shape[d] % n == 0
                        and shape[d] >= n), key=lambda d: -shape[d])
        if cands:
            d = cands[0]
            spec[d] = "model" if want == "model" else _dp_name(dp)
            dims.remove(d)
    return tuple(spec)


_EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def _in_stack(parts) -> bool:
    return parts[0] in ("blocks", "encoder") or (
        len(parts) > 1 and parts[1] in ("blocks", "encoder"))


def _param_spec(name: str, shape, mesh, dp=("data",)) -> Spec:
    """The spec of one parameter (or optimizer-state) leaf, by its
    ``state_dict`` name and shape."""
    shape = tuple(shape)
    if len(shape) == 0:
        return ()
    parts = name.split(".")
    in_stack = _in_stack(parts)
    ref_rank = len(shape) + (1 if in_stack else 0)   # the reference's
    if len(shape) == 1:                              # biases and scales
        return (None,)
    expert_dim = None
    if "ffn" in parts and parts[-1] in _EXPERT_LEAVES and ref_rank >= 3:
        expert_dim = 0
    return _greedy_spec(shape, mesh, expert_dim, dp)


def param_specs(params: Mapping, mesh, dp=("data",)) -> dict:
    """``{name: spec}`` for a mapping of ``state_dict`` names to tensors
    (anything with ``.shape``): parameters, or the optimizer's moments,
    which mirror them."""
    return {k: _param_spec(k, v.shape, mesh, dp) for k, v in params.items()}


def _cache_leaf_spec(leaf: str, s, mesh, dp) -> Spec:
    spec = [None] * len(s)
    if leaf not in ("k", "v", "c_kv", "k_rope", "state", "conv", "last"):
        return tuple(spec)                          # pos, and any other
    if _div(s[0], _dp_size(mesh, dp)):
        spec[0] = _dp_name(dp)
    model_n = mesh.shape["model"]
    if leaf in ("conv", "last"):                    # (B, ..., C): C
        if _div(s[-1], model_n):
            spec[-1] = "model"
    elif len(s) > 1 and _div(s[1], model_n):        # (B, S | H, ...)
        spec[1] = "model"
    return tuple(spec)


def cache_specs(caches, mesh, dp=("data",)):
    """The caches' specs, shaped as the caches: a list of one (nested)
    dict a layer, each leaf a spec by its name."""
    def walk(node, leaf=""):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _cache_leaf_spec(leaf, tuple(node.shape), mesh, dp)
    return walk(caches)


def batch_specs(batch: Mapping, mesh, dp=("data",)) -> dict:
    """tokens/labels (B, S) -> (dp, None); embeds and encoder frames (B,
    S, D) -> (dp, None, None); mrope (3, B, S) -> (None, dp, None); the
    batch dim whole where the data axes do not divide it."""
    out = {}
    for k, v in batch.items():
        shape = tuple(v.shape)
        spec = [None] * len(shape)
        bdim = 1 if k == "mrope_positions" else 0
        if _div(shape[bdim], _dp_size(mesh, dp)):
            spec[bdim] = _dp_name(dp)
        out[k] = tuple(spec)
    return out


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in order."""
    out = []
    for axis in spec:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                out.append(a)
    return tuple(out)


def shard_count(spec: Spec, mesh) -> int:
    """How many shards a spec cuts its leaf into."""
    return math.prod(mesh.shape[a] for a in spec_axes(spec))


__all__ = ["param_specs", "cache_specs", "batch_specs",
           "shard_count", "spec_axes"]
