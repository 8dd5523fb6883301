"""Communicators: the worker group as the distributed engine sees it (in
place of the reference's ``lax.all_to_all`` and ``psum`` inside
``shard_map``, ``repro/core/engine.py:54``).

A process holds ``count`` consecutive partitions of the group's ``P``,
from ``start``, side by side on its arrays' leading axis ``L``. The
engine's shard-local code is written once against these calls:

- ``all_to_all(buf)``: ``buf`` (L, P, S, D), row ``[l, q]`` what the
  process's partition ``start + l`` sends partition ``q``; returns (L,
  P, S, D), row ``[l, p]`` what partition ``p`` sent partition ``start +
  l``. Differentiable: its backward is the same exchange of the
  cotangent.
- ``all_reduce(x)``: ``x`` (n, ...), rows the process holds (one per
  partition); returns the sum of every process's rows, in rank order
  (no gradient).
- ``all_reduce_grads(grads)``: sums each gradient over the processes,
  in place: the paper's NN-Reduce, a **sum** of the gradients of local
  objectives that are already divided by the global target count (the
  reference's ``psum``; not DDP's average).
- ``all_gather(x)``: (L, ...) -> (P, ...), every partition's rows.
- ``barrier()`` and ``rank``: where one process writes for the group
  (a checkpoint) and the others wait for it.

:class:`LocalComm` holds all ``P`` partitions in one process, on one
device: the exchange is a transpose of the stacked send buffers, the
reductions sums in rank order, and everything is capturable into a CUDA
graph. :class:`ProcessGroupComm` spreads them over the ``W`` processes of
an initialised ``torch.distributed`` group, ``P // W`` consecutive
partitions each: gloo on the CPU, NCCL with one card per process (the
launcher :mod:`repro_torch.launch.ranks` starts them). Its exchange is
one ``all_to_all_single``; its reductions gather every process's rows
and sum them in rank order, so every process holds the same bits, those
``LocalComm`` gives, run after run, whatever order the network would
reduce in. Over NCCL a step through it is capturable as well: the eager
warm-up before a capture connects the peers.

Each counts what it sends (:func:`repro_torch.utils.trace.count`, into a
capture's tally while a step is captured): ``comm.all_to_all.bytes``,
the exchange's payload less the part a partition addresses to itself,
forward and backward; ``comm.all_gather.bytes``, ``(W - 1)`` times the
rows gathered, for the reductions and ``all_gather``. A process counts
what it sends to the other processes; ``LocalComm`` counts what its
``P`` partitions would send each other as ``P`` processes, so over a
group of one partition a process the processes' counts sum to its
count.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.utils import trace

A2A_BYTES = "comm.all_to_all.bytes"
GATHER_BYTES = "comm.all_gather.bytes"


class Comm:
    """The interface; see the module docstring."""

    P: int = 1
    start: int = 0
    count: int = 1
    rank: int = 0                 # the process's place in its group
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

    def barrier(self) -> None:
        """Wait until every process of the group gets here."""


def _rank_order_sum(rows: torch.Tensor) -> torch.Tensor:
    out = rows[0]
    for part in rows[1:]:            # rank order, as one sum per rank
        out = out + part
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _sent(x: torch.Tensor, parts: int) -> int:
    """Bytes of ``x`` (``parts`` equal blocks on its leading axis, block
    ``r`` addressed to part ``r``) that leave the part that holds it."""
    return _nbytes(x) * (parts - 1) // parts


class LocalComm(Comm):
    """All ``P`` partitions in this process."""

    capturable = True

    def __init__(self, P: int):
        self.P = self.count = int(P)
        self.start = 0

    def all_to_all(self, buf):
        # row [p, q] is what p sends q; q receives row [q, p]
        trace.count(A2A_BYTES, _sent(buf, self.P))
        out = buf.transpose(0, 1).contiguous()
        if out.requires_grad:         # the backward's exchange
            out.register_hook(
                lambda g: trace.count(A2A_BYTES, _sent(g, self.P)))
        return out

    def all_reduce(self, x):
        trace.count(GATHER_BYTES, (self.P - 1) * _nbytes(x))
        return _rank_order_sum(x).detach()

    def all_reduce_grads(self, grads):
        # the backward already summed them; P processes would gather
        trace.count(GATHER_BYTES, self.P * (self.P - 1) * sum(
            _nbytes(g) for g in grads.values()))

    def all_gather(self, x):
        trace.count(GATHER_BYTES, (self.P - 1) * _nbytes(x))
        return x


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal splits of the leading axis, whose
    backward is the same exchange of the cotangent: (W, ...) ->
    (W, ...), block ``r`` sent to process ``r`` and the block received
    from it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()       # so that empty_like lays out rows as x does
    out = torch.empty_like(x)
    trace.count(A2A_BYTES, _sent(x, x.shape[0]))
    dist.all_to_all_single(out, x, group=group)
    return out


class ProcessGroupComm(Comm):
    """``P`` partitions over the processes of an initialised
    ``torch.distributed`` group (``group``, default the world): process
    ``rank`` of ``W`` holds partitions ``rank * P // W`` onwards, ``P //
    W`` of them. ``P`` defaults to ``W``; a ``P`` that ``W`` does not
    divide is refused."""

    def __init__(self, group=None, P: Optional[int] = None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.P = self.world if P is None else int(P)
        check_ranks(self.P, self.world)
        self.count = self.P // self.world
        self.start = self.rank * self.count
        self.capturable = dist.get_backend(group) == "nccl"

    def all_to_all(self, buf):
        L, P = buf.shape[:2]
        rest = tuple(buf.shape[2:])
        # block r: this process's rows for process r's L partitions
        send = buf.reshape((L, self.world, L) + rest).transpose(0, 1)
        got = _AllToAll.apply(send.contiguous(), self.group)
        # got[r, l', l]: what partition r * L + l' sent partition start + l
        return got.permute((2, 0, 1) + tuple(range(3, got.dim()))
                           ).reshape((L, P) + rest)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n, ...) -> (W * n, ...): every process's rows in rank order."""
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        trace.count(GATHER_BYTES, (self.world - 1) * _nbytes(x))
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def all_reduce(self, x):
        return _rank_order_sum(self._gather(x.detach()))

    def all_reduce_grads(self, grads):
        flat = [g.reshape(-1) for g in grads.values()]
        if not flat:
            return
        total = _rank_order_sum(
            self._gather(torch.cat(flat)[None]))     # one collective
        with torch.no_grad():
            for g, part in zip(grads.values(),
                               total.split([f.numel() for f in flat])):
                g.copy_(part.view_as(g))

    def all_gather(self, x):
        return self._gather(x)

    def barrier(self):
        import torch.distributed as dist
        dist.barrier(group=self.group)


def check_ranks(P: int, ranks: int) -> None:
    """Refuse ``P`` partitions over ``ranks`` processes unless each holds
    the same number (the counterpart of the reference's "need P
    devices")."""
    if ranks < 1 or P < 1 or P % ranks != 0:
        raise ValueError(f"{P} partitions do not split evenly over "
                         f"{ranks} ranks: each rank holds P // ranks "
                         "consecutive partitions")


def default_comm(P: int, comm: Optional[Comm] = None) -> Comm:
    """``comm``, checked against ``P``; a :class:`LocalComm` when None."""
    if comm is None:
        return LocalComm(P)
    if comm.P != P:
        raise ValueError(f"the communicator's group has {comm.P} "
                         f"partitions, the plan {P}")
    return comm


__all__ = ["Comm", "LocalComm", "ProcessGroupComm", "check_ranks",
           "default_comm"]
