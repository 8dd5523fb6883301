"""The expert-parallel mesh (the counterpart of the ``mesh`` argument that
``repro/launch/mesh.py:make_host_mesh`` builds for the reference's
``build_model(cfg, moe_impl="ep", mesh=...)``).

The reference's mesh is a ``jax.sharding.Mesh`` of devices with the axes
``("data", "model")`` (its ``data_axes`` is ``("data",)`` without a
``pod`` axis, as here); ``moe_ffn_ep`` splits the batch over ``data`` and
the sequence over ``model``, and moves routed tokens between the
``model`` ranks of each data row by ``all_to_all``. Here the mesh is its
two sizes and the communicator that carries that exchange
(:mod:`repro_torch.core.comm`): :class:`LocalComm` (the default) holds
every ``data x model`` rank in one process on the caller's device, and
its exchange is a transpose of stacked buffers; a
:class:`ProcessGroupComm` spreads the model ranks over the processes of
a ``torch.distributed`` group, one a card under the launcher
(:mod:`repro_torch.launch.ranks`), each process holding every data row
of its model ranks.

The production mesh that the dry-run plans for
(:func:`make_production_mesh`) is shape-only: axis names and sizes, no
device and no process group (:class:`ShapeMesh`), as the reference's
tests' ``FakeMesh``. Its hosts are H100 hosts of 8 cards: ``model``
spans one host's NVLink, ``data`` (and ``pod``) the network. The H100's
rates below are what :mod:`repro_torch.launch.roofline` divides by.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


from repro_torch.core.comm import Comm, LocalComm, ProcessGroupComm


@dataclass(frozen=True)
class ExpertMesh:
    """``data`` x ``model`` ranks; ``comm`` carries the exchange between
    the ``model`` ranks (``comm.P == model``) and defaults to
    ``LocalComm(model)``."""

    data: int
    model: int
    comm: Optional[Comm] = field(default=None, compare=False)

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh sizes must be positive, got data "
                             f"{self.data}, model {self.model}")
        if self.comm is None:
            object.__setattr__(self, "comm", LocalComm(self.model))
        if self.comm.P != self.model:
            raise ValueError(f"the communicator's group has {self.comm.P} "
                             f"ranks, the model axis {self.model}")


def make_host_mesh(model_parallel: int = 1) -> ExpertMesh:
    """The reference's host mesh, one rank per device: ``count //
    model_parallel`` data rows of ``model_parallel`` model ranks. A
    process outside a ``torch.distributed`` group is one device (its
    card, or the CPU), so its mesh is (1, 1) in this process; inside the
    launcher's group of ``W`` processes, one a card, the mesh's model
    ranks are the processes (a :class:`ProcessGroupComm`), which
    ``model_parallel`` must then equal: the port splits the data axis
    inside a process only."""
    import torch.distributed as dist
    n = (dist.get_world_size() if dist.is_available()
         and dist.is_initialized() else 1)
    if n % model_parallel != 0:
        raise ValueError(f"device count {n} must be a multiple of "
                         f"model_parallel {model_parallel}")
    if n == 1:
        return ExpertMesh(1, 1)
    if model_parallel != n:
        raise ValueError(f"{n} ranks as {n // model_parallel} data rows of "
                         f"{model_parallel} model ranks: the port's mesh "
                         "holds every data row in each process, so "
                         "model_parallel must be the rank count")
    return ExpertMesh(1, n, ProcessGroupComm())


@dataclass(frozen=True)
class ShapeMesh:
    """A mesh as shapes only: ``shape[axis]`` its size, ``axis_names`` in
    order. Touches no device: the dry-run plans a mesh of cards that need
    not exist."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or "model" not in \
                self.axis_names or any(n < 1 for n in self.sizes):
            raise ValueError(f"a mesh needs a 'model' axis and positive "
                             f"sizes, got {self.axis_names} "
                             f"{self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """32 hosts of 8 H100s = 256 cards, ``("data", "model")`` = (32, 8);
    two pods of them = 512 cards, ``("pod", "data", "model")`` = (2, 32,
    8). The reference's 256 and 512 chips, split by the host."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 32, 8))
    return ShapeMesh(("data", "model"), (32, 8))


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' joins 'data' when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# One NVIDIA H100 SXM (the roofline's denominators).
PEAK_FLOPS_BF16 = 989e12   # FLOP/s, bf16 dense tensor cores (NVIDIA H100
#                            data sheet, SXM, without sparsity)
HBM_BW = 3.35e12           # bytes/s of HBM3 (the same data sheet)
NVLINK_BW = 450e9          # bytes/s each way per card: NVLink 4, 900 GB/s
#                            both ways, all to all within a host
NET_BW = 50e9              # bytes/s per card: one 400 Gb/s NIC a card, the
#                            DGX H100 layout (8 ConnectX-7 for 8 cards)


__all__ = ["ExpertMesh", "make_host_mesh", "ShapeMesh",
           "make_production_mesh", "data_axes", "PEAK_FLOPS_BF16",
           "HBM_BW", "NVLINK_BW", "NET_BW"]
