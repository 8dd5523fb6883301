"""One process per rank: the port's counterpart of the reference's one
shard per device (its engine refuses to run with fewer than P devices,
``repro/core/engine.py:179-184``, and its expert-parallel MoE runs each
model rank on its own device under ``shard_map``).

:func:`launch` runs ``fn(rank, *args)`` in ``ranks`` processes
(``torch.multiprocessing.spawn``) and returns each rank's result::

    from repro_torch.launch.ranks import launch
    losses = launch(fit_one_rank, 4, args=(job,), device="cuda")

On ``device="cuda"`` process ``r`` owns card ``r`` (the current device,
which :func:`~repro_torch.device.resolve_device` resolves ``"cuda"``
to), and the group is NCCL's; the host must have ``ranks`` cards, or
the call raises before it starts anything. The parent builds the CUDA
kernels once, before it spawns, so that no two ranks run ``nvcc`` into
the same build directory. On ``device="cpu"`` the group is gloo's,
each process taking an equal share of the host's cores. The group meets
through a file in a fresh temporary directory, with a timeout of
``TIMEOUT_S`` seconds on every collective instead of NCCL's default ten
minutes or more. The launcher sets no NCCL environment variable: the
port's reductions gather and sum in rank order
(:mod:`repro_torch.core.comm`), so no reduction order needs pinning.

A rank that raises ends the run: the others are terminated and the
parent raises with that rank's traceback. ``fn`` must be importable by
name from the spawned processes (a module-level function), and its
result picklable.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, List

TIMEOUT_S = 300


def launch(fn: Callable, ranks: int, args: tuple = (),
           device="cuda") -> List[Any]:
    """``[fn(r, *args) for r in range(ranks)]``, each in its own process
    of a ``torch.distributed`` group (see the module docstring)."""
    import torch
    import torch.multiprocessing as mp
    kind = torch.device(device).type
    if ranks < 1:
        raise ValueError(f"ranks must be positive, got {ranks}")
    if kind == "cuda":
        from repro_torch.device import resolve_device
        resolve_device("cuda")
        have = torch.cuda.device_count()
        if have < ranks:
            raise RuntimeError(
                f"{ranks} ranks need {ranks} cards, one each; this host "
                f"has {have}. Pass device='cpu' to run them over gloo on "
                "the CPU")
        from repro_torch.kernels import build
        build.build_all()
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device}: expected cuda or "
                         "cpu")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        mp.spawn(_rank_main, args=(fn, ranks, kind, tmp, args),
                 nprocs=ranks, join=True)
        out = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, fn: Callable, world: int, kind: str, tmp: str,
               args: tuple) -> None:
    """One spawned rank: join the group, run ``fn``, leave its result in
    ``tmp``."""
    import torch
    import torch.distributed as dist
    kw = {}
    if kind == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
        kw["device_id"] = torch.device("cuda", rank)
    else:
        backend = "gloo"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'init')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    try:
        result = fn(rank, *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


__all__ = ["launch", "TIMEOUT_S"]
