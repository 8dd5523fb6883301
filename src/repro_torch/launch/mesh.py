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
:class:`ProcessGroupComm` holds one model rank per process over
``torch.distributed``.

The production mesh, the TPU v5e constants, ``dryrun.py``,
``roofline.py`` and ``sharding.py`` stay unported (README).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.core.comm import Comm, LocalComm


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
    """The reference's host mesh: the local devices (the cards, or 1 on a
    host without one) as ``count // model_parallel`` data rows of
    ``model_parallel`` model ranks."""
    n = torch.cuda.device_count() or 1
    if n % model_parallel != 0:
        raise ValueError(f"device count {n} must be a multiple of "
                         f"model_parallel {model_parallel}")
    return ExpertMesh(n // model_parallel, model_parallel)


__all__ = ["ExpertMesh", "make_host_mesh"]
