"""GraphTheta on PyTorch and CUDA: the port of :mod:`repro` to the H100.

The JAX package ``repro`` stays the reference; this package grows beside
it slice by slice and imports nothing from it (its tests import both and
hold one against the other). The first slice serves GAT-E and GCN through
:class:`repro_torch.serving.GNNServer`, with the Sum stage on two CUDA
kernels written for Hopper (:mod:`repro_torch.kernels`).

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
