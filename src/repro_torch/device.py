"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. ``None`` means ``"cuda"``; asking for CUDA where no card
    exists raises instead of drifting onto the CPU. Inside a rank of a
    ``torch.distributed`` group (:mod:`repro_torch.launch.ranks`), a bare
    ``"cuda"`` is the rank's own card, ``cuda:<rank>``, which the
    launcher made the current device.

    Also turns TF32 off for float32 matrix products and convolutions, so
    that float32 on the card matches the reference's float32 math."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU with the kernels' plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None and _in_process_group():
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def _in_process_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()
