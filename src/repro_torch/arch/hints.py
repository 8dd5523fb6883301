"""Activation-sharding hints, active only when the dry-run arms a mesh
(the counterpart of ``repro/arch/hints.py``).

Models call ``shard_hint(x, "batch", "seq", None)`` with logical axis
names; the planner maps logical names to mesh axes (GraphTheta-style:
one batch computed by the whole worker group). The port runs one device
a process and shards no activation, so a hint changes nothing: it
returns ``x`` as it is, armed or not. Armed (:func:`use_hints`), it
checks the rank, resolves the spec the reference would hand
``with_sharding_constraint`` (a dim the mesh axes do not divide stays
whole) and records it in the list that ``use_hints`` yields, from which
the dry-run reads how the activations are sharded.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

_RULES: Optional[dict] = None   # logical name -> mesh axis (or tuple)
_MESH = None
_SITES: Optional[list] = None


@contextlib.contextmanager
def use_hints(mesh, rules: dict):
    """Arm the hints with ``rules`` (logical name -> mesh axis, a tuple of
    axes, or None) over ``mesh`` (anything with ``shape[axis]``); yields
    the list that every hint inside appends ``(logical, shape, spec)``
    to."""
    global _RULES, _MESH, _SITES
    prev = (_RULES, _MESH, _SITES)
    sites: list = []
    _RULES, _MESH, _SITES = rules, mesh, sites
    try:
        yield sites
    finally:
        _RULES, _MESH, _SITES = prev


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def resolve(shape, logical, rules: dict, mesh) -> tuple:
    """The spec ``rules`` over ``mesh`` give an array of ``shape`` whose
    dims are named ``logical``."""
    spec = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name is not None else None
        if axis is None:
            spec.append(None)
            continue
        size = _axis_size(mesh, axis)
        spec.append(axis if (size > 1 and dim % size == 0) else None)
    return tuple(spec)


def shard_hint(x, *logical):
    """``x``, unchanged; armed, ``ValueError`` when ``logical`` does not
    name every dim of ``x``, and the resolved spec recorded."""
    if _RULES is None or _MESH is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"logical axes {logical} do not match array "
                         f"rank {x.dim()} (shape {tuple(x.shape)})")
    shape = tuple(x.shape)
    _SITES.append((tuple(logical), shape,
                   resolve(shape, logical, _RULES, _MESH)))
    return x


__all__ = ["use_hints", "shard_hint", "resolve"]
