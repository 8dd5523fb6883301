"""Worker processes for the port's expert-parallel MoE over
``torch.distributed`` (gloo on the CPU), one model rank per process
through :class:`repro_torch.core.comm.ProcessGroupComm`. Kept apart from
``test_torch_moe_ep.py`` so that each spawned process imports only the
port; it holds no test."""
import os

import numpy as np
import torch

# (data, model, experts, top_k, capacity_factor) per world size: a 1 x P
# mesh with drops, a 2 x P mesh (each process holds both data rows of its
# column) and, at 4, two dead experts padded in
GLOO_CASES = {2: [(1, 2, 4, 2, 1.25), (2, 2, 8, 2, 1.0)],
              4: [(1, 4, 8, 2, 1.0), (2, 4, 2, 1, 1.25)]}


def ep_case(E: int, seed: int, B: int = 4, S: int = 8, D: int = 32,
            F: int = 48) -> dict:
    """Seeded float32 MoE weights (the reference's layout), x and a
    cotangent r, as numpy. x's tokens share one direction, so that
    routing is skewed and the capacity drops pairs."""
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32),
        "wi_gate": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(
            np.float32),
        "wi_up": (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(
            np.float32),
        "wo": (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32),
        "x": (rng.normal(size=(B, S, D))
              + 2.0 * rng.normal(size=(D,))).astype(np.float32),
        "r": rng.normal(size=(B, S, D)).astype(np.float32)}


WEIGHTS = ("router", "wi_gate", "wi_up", "wo")


def ep_step(case: dict, mesh, lo: int, hi: int) -> dict:
    """``moe_ffn_ep`` on x's sequence columns ``lo:hi`` (this process's
    block) and the gradients of ``sum(out * r) + aux`` with respect to
    that block of x and to the weights: numpy arrays."""
    from repro_torch.arch.moe import moe_ffn_ep
    from repro_torch.config import MoEConfig
    p = {k: torch.from_numpy(case[k].copy()).requires_grad_(True)
         for k in WEIGHTS}
    x = torch.from_numpy(case["x"][:, lo:hi].copy()).requires_grad_(True)
    cfg = MoEConfig(num_experts=case["router"].shape[1],
                    top_k=int(case["top_k"]),
                    capacity_factor=float(case["capacity_factor"]))
    out, aux = moe_ffn_ep(p, x, cfg, mesh, dp_axis="data")
    (torch.sum(out * torch.from_numpy(case["r"][:, lo:hi].copy()))
     + aux).backward()
    grads = {k: p[k].grad for k in WEIGHTS}
    mesh.comm.all_reduce_grads(grads)
    res = {"out": out.detach().numpy(), "aux": aux.detach().numpy(),
           "grad/x": x.grad.numpy()}
    res.update({f"grad/{k}": v.numpy() for k, v in grads.items()})
    return res


def gloo_ep_worker(rank: int, world: int, init_file: str,
                   out_dir: str) -> None:
    """Model rank ``rank`` of ``world``: every case of
    ``GLOO_CASES[world]`` on its sequence block, written to
    ``rank<r>.npz``."""
    import torch.distributed as dist
    from repro_torch.core.comm import ProcessGroupComm
    from repro_torch.launch.mesh import ExpertMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = {}
        for i, (Dp, M, E, top_k, cf) in enumerate(GLOO_CASES[world]):
            case = dict(ep_case(E, seed=40 + i), top_k=top_k,
                        capacity_factor=cf)
            s = case["x"].shape[1] // M
            got = ep_step(case, ExpertMesh(Dp, M, ProcessGroupComm()),
                          rank * s, (rank + 1) * s)
            out.update({f"{i}/{k}": v for k, v in got.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
