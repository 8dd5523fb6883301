"""The program's side of a run, in one process (one rank of a multi-card
cell): the inputs from the seed, ``repro_torch.api.make_trainer``, the
first steps that the comparison reads, the warm-up, the measured window
through the trainer's ``fit``, in a traced run the profile and the
per-layer readers, and at the end the JAX modules the process holds."""
from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np

from bench_h100 import faults, spec as specs, trace
from bench_h100.data import make_graph
from bench_h100.reference.train import make_params, param_shapes

CHECK_STEPS = 3          # the steps the reference follows
TRACE_SECONDS = 3.0      # the longest profiled window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Modules in this process whose top-level name is JAX's, Flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def port_graph(cfg: dict, g: dict):
    """The program's Graph of the input arrays, with a self-loop at every
    node where the configuration's ``self_loops`` says so (as the
    program's facade gives its named datasets)."""
    from repro_torch.graph.csr import Graph
    out = Graph(g["src"], g["dst"], g["num_nodes"], g["x"], g["y"],
                edge_features=g["edge_attr"], train_mask=g["train_mask"],
                val_mask=g["val_mask"], test_mask=g["test_mask"],
                name="bench")
    return out.add_self_loops() if cfg.get("self_loops") else out


def train_job(cfg: dict, mix: dict, graph, seed: int, device):
    from repro_torch.api import TrainJob
    return TrainJob(
        dataset=graph, model=cfg["model"], strategy=mix["strategy"],
        num_layers=cfg["num_layers"], hidden=cfg["hidden_dim"],
        lr=cfg["lr"], weight_decay=cfg["weight_decay"], seed=seed,
        eval_every=0, log_every=0, compact=mix.get("compact", False),
        clusters_per_batch=mix.get("clusters_per_batch", 0),
        halo_hops=mix.get("halo_hops", 0),
        engine_partitions=mix.get("engine_partitions", 0),
        ranks=mix.get("ranks", 1),
        partition_method=mix.get("partition_method", "1d_src"),
        prefetch_mode="thread", device=str(device))


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def _release(dev) -> None:
    """Hands the freed program state's device memory back."""
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def _captures(trainer) -> int:
    return (sum(trainer.captures.values()) if hasattr(trainer, "captures")
            else trainer.trace_counts["train_step"])


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(np.linalg.norm(t.detach().double().cpu().numpy()))
            for k, t in tensors.items()}


def _broadcast_steps(n: int, dev) -> int:
    import torch
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return n
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def run(rank: int, spec: dict) -> dict:
    """One process's run; ``spec`` holds ``cfg``, ``mix``, ``seed``,
    ``seconds``, ``trace``, ``device``, ``fault`` and ``per_layer`` (the
    names of the per-layer metrics to read)."""
    import torch
    from repro_torch import api
    from repro_torch.device import resolve_device
    cfg, mix, seed = spec["cfg"], spec["mix"], int(spec["seed"])
    dev = resolve_device(spec["device"])
    fault = spec.get("fault")
    faults.process_fault(fault, rank, int(mix.get("ranks", 1)))
    spans = {"setup.start_s": time.time() - spec.get("t0", time.time())}
    fit_kw = {"prefetch_mode": "thread"}

    t = time.perf_counter()
    g = make_graph(cfg, mix, seed, dev)
    params0 = make_params(cfg, seed, dev)
    spans["setup.inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    graph = port_graph(cfg, faults.graph_fault(fault, g))
    trainer, views, *_ = api.make_trainer(
        train_job(cfg, mix, graph, seed, dev))
    spans["setup.trainer_build_s"] = time.perf_counter() - t
    want = param_shapes(cfg)
    have = {k: tuple(p.shape) for k, p in trainer.params.items()}
    if have != want:
        raise RuntimeError(f"the program's parameters {have} are not the "
                           f"configuration's {want}")
    trainer.reset(params0)
    faults.trainer_fault(fault, trainer)

    # the first steps, through the window's own call and feed
    t = time.perf_counter()
    losses = trainer.fit(views, steps=1, **fit_kw)["losses"]
    b1 = cfg["adam_b1"]
    grad1 = _leaf_norms({k: m / (1 - b1)
                         for k, m in trainer.opt_state["m"].items()})
    losses += trainer.fit(views, steps=CHECK_STEPS - 1, **fit_kw)["losses"]
    with torch.no_grad():
        change = _leaf_norms({k: p - params0[k]
                              for k, p in trainer.params.items()})
    first = {"losses": [float(x) for x in losses[:CHECK_STEPS]],
             "grad1": grad1, "change": change}
    spans["setup.first_steps_s"] = time.perf_counter() - t
    if spec.get("check_only"):
        del trainer, views, graph, params0
        _release(dev)
        return {"check": first}

    # warm-up: what the strategy stages and captures, then the rate that
    # sizes the window
    t = time.perf_counter()
    rest = specs.piece("strategies", mix["strategy"]).warmup_steps(
        mix, CHECK_STEPS)
    if rest > 0:
        trainer.fit(views, steps=rest, **fit_kw)
    _sync(dev)
    t_rate = time.perf_counter()
    trainer.fit(views, steps=int(mix["rate_steps"]), **fit_kw)
    _sync(dev)
    rate = int(mix["rate_steps"]) / (time.perf_counter() - t_rate)
    spans["setup.warmup_s"] = time.perf_counter() - t
    win = (min(spec["seconds"], TRACE_SECONDS) if spec["trace"]
           else spec["seconds"])
    steps = _broadcast_steps(max(int(mix["min_steps"]),
                                 math.ceil(rate * win)), dev)

    # the window: every step dispatched in it, until the device drained
    captures = _captures(trainer)
    prof = trace.profiler(dev.type == "cuda") if spec["trace"] else None
    if prof is not None:
        prof.__enter__()
    try:
        _barrier()
        _sync(dev)
        start_wall = time.time()
        t = time.perf_counter()
        out = trainer.fit(views, steps=steps, **fit_kw)
        _sync(dev)
        window_s = time.perf_counter() - t
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    res = {"check": first,
           "steps": steps, "window_s": window_s, "start_wall": start_wall,
           "failed": int(sum(not math.isfinite(x) for x in out["losses"])),
           "captures_in_window": _captures(trainer) - captures,
           "memory_peak_bytes": int(mem),
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "spans": spans}
    if prof is not None:
        red = trace.reduce(prof)
        del prof
        res["busy_s"] = red["busy_s"]
        res["breakdown"] = {"device_ops": red["largest"],
                            "idle_gaps": red["idle_gaps"]}
        if rank == 0:
            ctx = SimpleNamespace(
                cfg=cfg, mix=mix, seed=seed, device=dev, graph=graph,
                trainer=trainer,
                chips=int(mix.get("ranks", 1)),
                num_nodes=graph.num_nodes, num_edges=graph.num_edges,
                steps=steps, window_s=window_s, busy_s=red["busy_s"],
                device_ops=red["device_ops"], spans=spans)
            res["per_layer"] = {}
            for name in spec["per_layer"]:
                value = specs.reader(name)(ctx)
                if value is not None:
                    res["per_layer"][name] = float(value)
    if rank == 0:
        res["inputs"] = (g, {k: v.cpu() for k, v in params0.items()})
    del trainer, views, graph, params0
    _release(dev)
    res["forbidden"] = loaded_forbidden()
    return res
