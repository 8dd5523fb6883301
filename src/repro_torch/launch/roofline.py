"""Roofline terms of a planned step (the counterpart of
``repro/launch/roofline.py``), from a fake-tensor trace of the port's own
step (:mod:`repro_torch.launch.faketrace`) and the H100's rates
(:mod:`repro_torch.launch.mesh`):

  compute    = traced FLOPs (per card) / 989 TFLOP/s
  memory     = traced bytes (per card) / 3.35 TB/s
  collective = NVLink bytes / 450 GB/s + network bytes / 50 GB/s

The trace runs the whole global batch as one program, so a card's share
of its FLOPs and bytes is the total over the cards (an even split; the
reference reads the partitioned HLO instead). The collective bytes come
from the plan, not from HLO (:func:`collective_bytes`): every parameter
sharded over a mesh axis is all-gathered once in the forward and once
more in a backward that recomputes (remat), axis by axis, the network's
axes (``pod``, ``data``) first and ``model`` last: over an axis of size
``n`` a card receives ``(n - 1) / n`` of the bytes it holds once that
axis is gathered, which is the leaf's bytes over the shards of the axes
gathered after it (over every axis together, ``(N - 1) / N`` of the
leaf for N shards, as one ring would); in training its gradient is
reduce-scattered over the same axes (the same bytes) and all-reduced
over every other axis of the mesh (``2 (n - 1) / n`` of the card's
shard), ``pod`` among them where the parameter is not sharded over it;
expert parallelism's all-to-alls are what a recording communicator saw
the port's ``moe_ffn_ep`` send (:class:`RecordingComm`). Bytes over
``model`` ride one host's NVLink, bytes over ``data`` and ``pod`` the
network. The collectives that sequence-sharded activations would need
around attention are not counted.

The reference's ``parse_collective_bytes``, ``extract_costs`` and
``combine_calibrated`` read XLA's artifacts (HLO text, cost analysis, a
scan's per-group cost) and have no counterpart: there is no HLO, and
the trace runs every layer.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Mapping, Optional

import torch

from repro_torch.core.comm import Comm, LocalComm
from repro_torch.launch.mesh import HBM_BW, NET_BW, NVLINK_BW, \
    PEAK_FLOPS_BF16
from repro_torch.launch.sharding import shard_count, spec_axes


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    traced_flops_per_device: float
    traced_bytes_per_device: float
    collective_bytes_per_device: float
    nvlink_bytes_per_device: float
    network_bytes_per_device: float
    t_compute_s: float
    t_memory_s: float
    t_nvlink_s: float
    t_network_s: float
    t_collective_s: float
    dominant: str
    model_flops_per_device: float
    useful_flops_ratio: float
    memory_per_device_bytes: float
    collective_breakdown: Optional[dict] = None

    def as_dict(self):
        return asdict(self)

    @property
    def bound_s(self) -> float:
        """The roofline's bound on the step: its largest term."""
        return max(self.t_compute_s, self.t_memory_s, self.t_collective_s)


def model_flops(cfg, shape, chips: int) -> float:
    """Analytic MODEL_FLOPS for the step, per device.

    train: 6·N_active·tokens; prefill: 2·N_active·tokens;
    decode: 2·N_active·batch (one token per sequence).
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n * shape.global_batch * shape.seq_len
    else:
        total = 2.0 * n * shape.global_batch
    return total / chips


def _link(axis: str) -> str:
    return "nvlink" if axis == "model" else "network"


def collective_bytes(params: Mapping[str, torch.Tensor],
                     specs: Mapping[str, tuple], mesh, train: bool,
                     remat: bool, all_to_all: float = 0.0) -> dict:
    """A card's collective bytes a step under the plan (see the module's
    docstring): by kind ("all-gather", "reduce-scatter", "all-reduce",
    "all-to-all"), by link ("nvlink", "network") and in all
    ("total"). ``all_to_all``: a card's expert-parallel bytes over
    ``model``."""
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0,
           "all-to-all": float(all_to_all), "nvlink": float(all_to_all),
           "network": 0.0}
    gathers = 2 if (train and remat) else 1
    order = [a for a in mesh.axis_names if a != "model"] + ["model"]
    for name, p in params.items():
        nbytes = p.numel() * p.element_size()
        spec = specs[name]
        axes = spec_axes(spec)
        shard = nbytes / shard_count(spec, mesh)
        for i, axis in enumerate(order):
            n = mesh.shape[axis]
            if n <= 1:
                continue
            if axis in axes:
                later = math.prod(mesh.shape[a] for a in order[i + 1:]
                                  if a in axes)
                moved = (n - 1) / n * nbytes / later
                out["all-gather"] += gathers * moved
                out[_link(axis)] += gathers * moved
                if train:
                    out["reduce-scatter"] += moved
                    out[_link(axis)] += moved
            elif train:
                moved = 2 * (n - 1) / n * shard
                out["all-reduce"] += moved
                out[_link(axis)] += moved
    out["total"] = out["nvlink"] + out["network"]
    return out


def derive_terms(arch: str, shape, mesh_name: str, chips: int,
                 cost: dict, memory_bytes: float, cfg) -> RooflineTerms:
    """``cost``: ``flops`` and ``bytes`` a card, and ``coll``, a card's
    :func:`collective_bytes`; ``memory_bytes``: what a card holds at
    the step's peak."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes", 0.0))
    coll = dict(cost.get("coll") or {})
    nvlink = float(coll.get("nvlink", 0.0))
    network = float(coll.get("network", 0.0))
    t_c = flops / PEAK_FLOPS_BF16
    t_m = bytes_accessed / HBM_BW
    t_nv, t_net = nvlink / NVLINK_BW, network / NET_BW
    t_x = t_nv + t_net
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
                   key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape, chips)
    return RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        traced_flops_per_device=flops, traced_bytes_per_device=bytes_accessed,
        collective_bytes_per_device=nvlink + network,
        nvlink_bytes_per_device=nvlink, network_bytes_per_device=network,
        t_compute_s=t_c, t_memory_s=t_m, t_nvlink_s=t_nv, t_network_s=t_net,
        t_collective_s=t_x, dominant=dominant, model_flops_per_device=mf,
        useful_flops_ratio=(mf / flops) if flops else 0.0,
        memory_per_device_bytes=float(memory_bytes),
        collective_breakdown={k: v for k, v in coll.items()
                              if k not in ("nvlink", "network")},
    )


class _RecordedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, comm):
        ctx.comm = comm
        comm.sent += buf.numel() * buf.element_size()
        return comm.inner.all_to_all(buf)

    @staticmethod
    def backward(ctx, g):
        ctx.comm.sent += g.numel() * g.element_size()
        return ctx.comm.inner.all_to_all(g), None


class RecordingComm(Comm):
    """A communicator that counts the bytes of every exchange, forward
    and backward, around ``inner`` (a :class:`LocalComm` by default):
    ``sent`` is the sum of the buffers handed to ``all_to_all``."""

    capturable = False

    def __init__(self, P: int, inner: Optional[Comm] = None):
        self.inner = inner or LocalComm(P)
        self.P, self.start, self.count = (self.inner.P, self.inner.start,
                                          self.inner.count)
        self.sent = 0

    def all_to_all(self, buf):
        return _RecordedAllToAll.apply(buf, self)

    def all_reduce(self, x):
        return self.inner.all_reduce(x)

    def all_reduce_grads(self, grads):
        self.inner.all_reduce_grads(grads)

    def all_gather(self, x):
        return self.inner.all_gather(x)


__all__ = ["RooflineTerms", "model_flops", "collective_bytes",
           "derive_terms", "RecordingComm"]
