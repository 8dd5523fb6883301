"""Communicators: the worker group as the distributed engine sees it (in
place of the reference's ``lax.all_to_all`` and ``psum`` inside
``shard_map``, ``repro/core/engine.py:54``).

A process holds ``count`` consecutive partitions of the group's ``P``,
from ``start``, side by side on its arrays' leading axis ``L``. The
engine's shard-local code is written once against three calls:

- ``all_to_all(buf)``: ``buf`` (L, P, S, D), row ``[l, q]`` what the
  process's partition ``start + l`` sends partition ``q``; returns (L,
  P, S, D), row ``[l, p]`` what partition ``p`` sent partition ``start +
  l``. Differentiable: its backward is the same exchange of the
  cotangent.
- ``all_reduce(x)``: ``x`` (L, ...) one value per partition the process
  holds; returns the sum over all ``P`` partitions (no gradient).
- ``all_reduce_grads(grads)``: sums each gradient over the processes,
  in place: the paper's NN-Reduce, a **sum** of the gradients of local
  objectives that are already divided by the global target count (the
  reference's ``psum``; not DDP's average).

:class:`LocalComm` holds all ``P`` partitions in one process, on one
device: the exchange is a transpose of the stacked send buffers, the
reductions sums in rank order, and everything is capturable into a CUDA
graph. It is what runs on the card (one H100 cannot take two NCCL ranks,
so no network time is measured). :class:`ProcessGroupComm` runs one
partition per process over ``torch.distributed`` (gloo on the CPU in the
tests; NCCL where each rank has its own card).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


class Comm:
    """The interface; see the module docstring."""

    P: int = 1
    start: int = 0
    count: int = 1
    # whether a step through it can be captured into a CUDA graph
    capturable: bool = False

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) -> (P, ...): every partition's rows, in rank order."""
        raise NotImplementedError


class LocalComm(Comm):
    """All ``P`` partitions in this process."""

    capturable = True

    def __init__(self, P: int):
        self.P = self.count = int(P)
        self.start = 0

    def all_to_all(self, buf):
        # row [p, q] is what p sends q; q receives row [q, p]
        return buf.transpose(0, 1).contiguous()

    def all_reduce(self, x):
        out = x[0]
        for part in x[1:]:            # rank order, as one sum per rank
            out = out + part
        return out.detach()

    def all_reduce_grads(self, grads):
        pass                          # the backward already summed them

    def all_gather(self, x):
        return x


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal splits of the leading axis, whose
    backward is the same exchange of the cotangent: (P, S, D) ->
    (P, S, D)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class ProcessGroupComm(Comm):
    """One partition per process of an initialised ``torch.distributed``
    group: partition ``rank`` of ``world_size``."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.P = dist.get_world_size(group)
        self.start = dist.get_rank(group)
        self.count = 1

    def all_to_all(self, buf):
        return _AllToAll.apply(buf[0], self.group)[None]

    def all_reduce(self, x):
        import torch.distributed as dist
        out = x[0].detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_reduce_grads(self, grads):
        import torch.distributed as dist
        for g in grads.values():
            dist.all_reduce(g, group=self.group)

    def all_gather(self, x):
        import torch.distributed as dist
        parts = [torch.empty_like(x[0]) for _ in range(self.P)]
        dist.all_gather(parts, x[0].contiguous(), group=self.group)
        return torch.stack(parts)


def default_comm(P: int, comm: Optional[Comm] = None) -> Comm:
    """``comm``, checked against ``P``; a :class:`LocalComm` when None."""
    if comm is None:
        return LocalComm(P)
    if comm.P != P:
        raise ValueError(f"the communicator's group has {comm.P} "
                         f"partitions, the plan {P}")
    return comm


__all__ = ["Comm", "LocalComm", "ProcessGroupComm", "default_comm"]
