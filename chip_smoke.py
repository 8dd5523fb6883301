#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py                 # every phase; needs one card
    python3 chip_smoke.py --only kernels  # phases 1-3: build and check

Phases (each raises on failure, so the script exits non-zero):

1. device — the card's name, count and power limit (nvidia-smi);
2. build — nvcc builds the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` and prints the ``-Xptxas -v`` report;
3. kernels vs plain — each kernel, forward and backward, against its
   plain PyTorch version on the card, at the serving and training paths'
   bucket shapes and at the edge cases (empty, masked and all-masked
   rows, pad edges that clip to the last row, no edges, no rows, a width
   that is not a multiple of 4, 4 heads of 16, a cotangent that is not
   contiguous);
4. serve GAT-E (alipay_like, 20,000 nodes, published widths) on the card
   through ``repro_torch.launch.serve_gnn``: 512 requests, 4 clients,
   cache on; every response held against the same port run on the CPU,
   a cache hit held against a full recompute, the kernel's launch count
   read;
5. serve GCN (reddit_like + self-loops, hidden 128), the same way;
6. kernel times at layer 0 of a full-graph step (GAT-E on a
   1,000,000-node alipay_like graph, GCN on reddit_like), forward and
   backward: each kernel held against its plain version there, then
   kernel, plain version and library call timed with CUDA events, beside
   the bound from bytes moved;
7. train GAT-E (alipay_like, 20,000 nodes, the config's widths and lr)
   on the card through ``repro_torch.api.make_trainer`` and ``fit``, 30
   steps under each of global, mini (compact) and cluster (compact, halo
   1), and the same jobs on the CPU from the same seed: step-1 gradients
   and every step's loss held against the CPU's, the global loss must
   fall, the backward kernel must launch; then the same 20 global steps
   run twice on the card, reporting whether they agree bit for bit;
8. train GCN (reddit_like + self-loops, hidden 128), the same way.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores
RTOL = ATOL = 1e-5                 # kernel vs plain: sums in another order
SERVE_TOL = 1e-4                   # card vs CPU responses
GRAD_TOL = 1e-4                    # card vs CPU step-1 gradients, relative
LOSS_TOL = 1e-3                    # card vs CPU losses, * max(1, |loss|)
TRAIN_STEPS = 30
DEVICE = "cuda"
KERNEL_NODES = 1_000_000           # alipay_like nodes for the GAT-E timing
KERNELS = {
    "segment_sum": {
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum.py:164"},
    "edge_softmax": {
        "source": "src/repro_torch/kernels/csrc/edge_softmax.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:98"},
    "segment_sum_bwd": {
        "source": "src/repro_torch/kernels/csrc/segment_sum_bwd.cu",
        "replaces": "src/repro/kernels/backward.py:84"},
    "edge_softmax_bwd": {
        "source": "src/repro_torch/kernels/csrc/edge_softmax_bwd.cu",
        "replaces": "src/repro/kernels/backward.py:220"},
}


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def _case(rng, n, e, h, d, *, mask=0.0, all_masked=0, e_pad=0, n_pad=0):
    """Inputs shaped as a served block: (plan, logits, values) on the card.
    ``mask`` masks that share of edges, ``all_masked`` every edge of the
    first rows; ``e_pad``/``n_pad`` make a bucket with pad edges."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_bucket_csc_plan
    from repro_torch.kernels.ref import NEG
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    logits = (rng.normal(size=(max(e, e_pad), h)) * 3).astype(np.float32)
    values = rng.normal(size=(max(e, e_pad), h, d)).astype(np.float32)
    masked = (rng.random(e) < mask) | (ids < all_masked)
    logits[:e][masked] = NEG
    values[:e][masked] = 0.0
    plan = build_bucket_csc_plan(ids, max(n, n_pad), max(e, e_pad))
    dev = torch.device(DEVICE)
    return (plan.to(dev), torch.from_numpy(logits).to(dev),
            torch.from_numpy(values).to(dev))


def _cotangent(rng, shape, contiguous: bool):
    """A seeded cotangent on the card; ``contiguous=False`` lays the same
    values out transposed, as autograd may hand them over."""
    import torch
    n, h, d = shape
    g = torch.from_numpy(rng.normal(size=(h, n, d)).astype("float32"))
    g = g.to(DEVICE).transpose(0, 1)
    return g if not contiguous else g.contiguous()


def _check_backward(plan, lg, v, out, m, den, g, worst: dict, name: str):
    """Both backward kernels against their plain versions on one case."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (edge_softmax_bwd_ref,
                                         segment_sum_bwd_ref)
    got = ops.segment_sum_bwd_op(g, plan)
    d_lg, d_v = ops.edge_softmax_bwd_op(g, lg, v, out, m, den, plan)
    gc = g.contiguous()
    want = segment_sum_bwd_ref(gc.flatten(1), plan.edge_dst)
    w_lg, w_v = edge_softmax_bwd_ref(gc, lg, v, m, den, (out * gc).sum(-1),
                                     plan.edge_dst)
    torch.cuda.synchronize()
    for kname, pairs in (("segment_sum_bwd", [(got.flatten(1), want)]),
                         ("edge_softmax_bwd", [(d_lg, w_lg), (d_v, w_v)])):
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                       msg=f"{kname} on {name}")
            if a.numel():
                worst[kname] = max(worst[kname], float((a - b).abs().max()))


def check_kernels() -> dict:
    """Max abs error of each kernel against its plain version over every
    case; raises past rtol/atol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import build_csc_plan
    from repro_torch.kernels.ref import edge_softmax_ref, segment_sum_ref
    rng = np.random.default_rng(0)
    cases = {
        # the serving path's buckets: GAT-E's 4 heads of 8 in its
        # (4096, 16384) bucket and GCN's 128 in its (4096, 131072) one,
        # with pad edges and masked edges
        "gat_e_bucket": dict(n=3000, e=12000, h=4, d=8, mask=0.2,
                             e_pad=16384, n_pad=4096),
        "gat_e_bucket_large": dict(n=12000, e=60000, h=4, d=8, mask=0.2,
                                   e_pad=65536, n_pad=16384),
        "gcn_bucket": dict(n=3000, e=70000, h=1, d=128, mask=0.2,
                           e_pad=131072, n_pad=4096),
        "empty_rows": dict(n=5000, e=1000, h=4, d=8),
        "all_masked_rows": dict(n=500, e=4000, h=4, d=8, all_masked=100),
        "no_edges": dict(n=300, e=0, h=4, d=8),
        "width_130": dict(n=700, e=5000, h=1, d=130),
        "heads_4x16": dict(n=700, e=5000, h=4, d=16),
        # the training path's: a GCN mini-batch bucket and a GAT-E cluster
        # bucket; pad edges carry garbage logits and read row N - 1
        "gcn_train_bucket": dict(n=3500, e=90000, h=1, d=128, e_pad=131072,
                                 n_pad=4096),
        "gat_e_train_bucket": dict(n=6000, e=30000, h=4, d=8, e_pad=32768,
                                   n_pad=8192),
    }
    worst = {k: 0.0 for k in KERNELS}
    for name, kw in cases.items():
        plan, lg, v = _case(rng, **kw)
        flat = v.flatten(1)
        got = ops.segment_sum_op(flat, plan)
        want = segment_sum_ref(flat, plan.perm, plan.indptr,
                               plan.num_segments)
        out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
        w_out, w_m, w_den = edge_softmax_ref(lg, v, plan.perm, plan.indptr,
                                             plan.num_segments)
        torch.cuda.synchronize()
        for kname, pairs in (("segment_sum", [(got, want)]),
                             ("edge_softmax", [(out, w_out), (m, w_m),
                                               (den, w_den)])):
            for a, b in pairs:
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                           msg=f"{kname} on {name}")
                if a.numel():
                    worst[kname] = max(worst[kname],
                                       float((a - b).abs().max()))
        for contiguous in (True, False):
            g = _cotangent(rng, tuple(out.shape), contiguous)
            _check_backward(plan, lg, v, out, m, den, g, worst,
                            f"{name}, contiguous={contiguous}")
        print(f"  {name}: ok", flush=True)
    # no rows: every edge reads nothing, the gradients are zeros
    plan = build_csc_plan(np.zeros(64, np.int32), 0).to(DEVICE)
    g = torch.zeros((0, 4, 8), device=DEVICE)
    d_lg, d_v = ops.edge_softmax_bwd_op(
        g, torch.zeros((64, 4), device=DEVICE),
        torch.zeros((64, 4, 8), device=DEVICE), g,
        torch.zeros((0, 4), device=DEVICE), torch.zeros((0, 4),
                                                        device=DEVICE), plan)
    if ops.segment_sum_bwd_op(g, plan).any() or d_lg.any() or d_v.any():
        raise AssertionError("backward with no rows gave non-zero gradients")
    print("  no_rows: ok", flush=True)
    print("kernels: " + ", ".join(
        f"{k} max_abs_err={worst[k]:.3e} (rtol {RTOL}, atol {ATOL}) pass"
        for k in KERNELS), flush=True)
    return worst


# -- phases 4 and 5: serving --------------------------------------------------


def serve(config: str, label: str, requests: int = 512) -> dict:
    """Serve a seeded trace on the card through the entry point's
    functions for the config module ``config``, hold it against the CPU,
    and return the launch counts of the served run."""
    import numpy as np
    from repro_torch.config import get_gnn_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import (build_server, config_for,
                                              print_report, request_trace,
                                              resolve_graph, run_clients)
    cfg, dataset = get_gnn_config(config)
    model, hidden, layers = cfg.model, cfg.hidden_dim, cfg.num_layers
    t0 = time.perf_counter()
    g = resolve_graph(dataset, model, seed=0)
    if config_for(g, model, layers, hidden) != cfg:
        raise AssertionError(f"{config}: the served model is not CONFIG")
    print(f"  graph {dataset}: {g.num_nodes} nodes, {g.num_edges} edges "
          f"(built in {time.perf_counter() - t0:.2f}s on the host)")
    trace = request_trace(g, requests, seed=0)
    kw = dict(max_batch=16, max_wait_ms=2.0)
    srv = build_server(g, model, layers, hidden, seed=0, device=DEVICE,
                       **kw)

    ops.reset_launches()
    srv.start()
    try:
        out, wall = run_clients(srv, trace, 4)
    finally:
        srv.stop()
    launches = dict(ops.launches)
    print_report(srv, wall, requests, label=f"{label}, {model}")
    print(f"  launches on the served path: {launches}")

    # the same port on the CPU, plain versions, every response
    cpu = build_server(g, model, layers, hidden, seed=0, device="cpu",
                       cache=False, **kw)
    uniq = np.unique(trace)
    ref = np.concatenate([cpu.submit(uniq[i:i + 16])
                          for i in range(0, len(uniq), 16)])
    want = ref[np.searchsorted(uniq, trace)]
    err = float(np.abs(out - want).max())
    if not np.isfinite(out).all() or out.shape != want.shape:
        raise AssertionError(f"{model}: bad responses {out.shape}")
    np.testing.assert_allclose(out, want, rtol=SERVE_TOL, atol=SERVE_TOL,
                               err_msg=f"{model}: card vs CPU")
    print(f"  card vs CPU over {requests} responses: max_abs_err={err:.3e} "
          f"(tolerance {SERVE_TOL}) pass")

    # a cache hit against a full recompute, on the card
    rng = np.random.default_rng(1)
    targets = rng.choice(g.num_nodes, 16, replace=False)
    cached = build_server(g, model, layers, hidden, seed=0, device=DEVICE,
                          **kw)
    full = cached.submit(targets)
    hits0 = cached.cache.hits
    again = cached.submit(targets)
    if cached.cache.hits == hits0:
        raise AssertionError(f"{model}: the second submit hit no cache row")
    np.testing.assert_allclose(again, full, rtol=RTOL, atol=ATOL,
                               err_msg=f"{model}: cache hit vs recompute")
    print(f"  cache hit vs full recompute: "
          f"{cached.cache.hits - hits0} hits, max_abs_err="
          f"{float(np.abs(again - full).max()):.3e}, bitwise="
          f"{bool(np.array_equal(again, full))}")
    return launches


# -- phase 6: kernel times ----------------------------------------------------


def _time_ms(fn, min_total_ms: float = 200.0) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    n = max(5, min(200, int(min_total_ms / max(start.elapsed_time(stop),
                                               1e-3))))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _bound(nbytes: float, nops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _layer0_inputs(config: str, **graph_kw):
    """The Sum-stage operands of layer 0 of a full-graph forward on the
    card for the config module ``config``: (graph, block, masked logits
    or None, masked values)."""
    import torch
    from repro_torch.config import get_gnn_config
    from repro_torch.core.tgar import tree_take
    from repro_torch.graph import build_block
    from repro_torch.kernels.ref import NEG
    from repro_torch.launch.serve_gnn import make_model, resolve_graph
    cfg, dataset = get_gnn_config(config)
    model = cfg.model
    t0 = time.perf_counter()
    g = resolve_graph(dataset, model, seed=0, **graph_kw)
    t_gen = time.perf_counter() - t0
    layer = make_model(g, model, cfg.num_layers, cfg.hidden_dim,
                       seed=0).layers[0].to(DEVICE)
    block = build_block(g, gcn_norm=model == "gcn", csc_plan=True).to(
        DEVICE)
    with torch.inference_mode():
        n = layer.transform(block.x)
        msg = layer.gather(tree_take(n, block.src), tree_take(n, block.dst),
                           block.edge_attr, block.edge_weight,
                           block.edge_mask)
        mask = block.edge_mask
        value = (msg["value"] * mask[:, None, None]).contiguous()
        logit = (torch.where(mask[:, None] > 0, msg["logit"],
                             torch.full_like(msg["logit"], NEG))
                 if "logit" in msg else None)
    print(f"  {dataset}: {g.num_nodes} nodes, {g.num_edges} edges "
          f"(generated in {t_gen:.1f}s on the host)")
    return g, block, logit, value


def kernel_times() -> dict:
    """Kernel, plain-version and library times at full-graph sizes,
    forward and backward, each kernel's output first held against its
    plain version there."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (edge_softmax_bwd_ref,
                                         edge_softmax_ref,
                                         segment_sum_bwd_ref,
                                         segment_sum_ref)
    rows = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.inference_mode():
        # GAT-E: edge_softmax and its backward at a full-graph layer 0
        g, block, logit, value = _layer0_inputs(
            "gnn_gat_e_alipay", num_nodes=KERNEL_NODES)
        plan = block.csc_plan
        E, H, D = value.shape
        N = plan.num_segments
        fwd = ops.edge_softmax_fwd_op(logit, value, plan)
        for a, b in zip(fwd, edge_softmax_ref(logit, value, plan.perm,
                                              plan.indptr, N)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        ms = _time_ms(lambda: ops.edge_softmax_fwd_op(logit, value, plan))
        plain = _time_ms(lambda: edge_softmax_ref(
            logit, value, plan.perm, plan.indptr, N), 100.0)
        nbytes = 4 * (E * H + E * H * D + E + (N + 1) + N * H * D + 2 * N * H)
        bound, by = _bound(nbytes, 8 * E * H * D)
        rows["edge_softmax"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                    bound_by=by, library_ms=None,
                                    shape=f"E={E} N={N} H={H} D={D}")
        out, m, den = fwd
        cot = torch.randn((N, H, D), generator=gen, device=DEVICE)
        bwd = (lambda: ops.edge_softmax_bwd_op(cot, logit, value, out, m,
                                               den, plan))
        bwd_plain = (lambda: edge_softmax_bwd_ref(
            cot, logit, value, m, den, (out * cot).sum(-1), plan.edge_dst))
        for a, b in zip(bwd(), bwd_plain()):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        ms = _time_ms(bwd)
        plain = _time_ms(bwd_plain, 100.0)
        # reads g, out, logits, values, m, den, edge_dst; writes d_logits
        # and d_values
        nbytes = 4 * (2 * N * H * D + 2 * E * H + 2 * E * H * D
                      + 2 * N * H + E)
        bound, by = _bound(nbytes, 3 * E * H * D + 5 * E * H + 2 * N * H * D)
        rows["edge_softmax_bwd"] = dict(ms=ms, plain_ms=plain,
                                        bound_ms=bound, bound_by=by,
                                        library_ms=None,
                                        shape=f"E={E} N={N} H={H} D={D}")
        del g, block, logit, value, plan, fwd, out, m, den, cot
        torch.cuda.empty_cache()

        # GCN: segment_sum and its backward at a full-graph layer 0
        g, block, _, value = _layer0_inputs("gnn_gcn_reddit")
        plan = block.csc_plan
        flat = value.flatten(1)
        E, D = flat.shape
        N = plan.num_segments
        torch.testing.assert_close(
            ops.segment_sum_op(flat, plan),
            segment_sum_ref(flat, plan.perm, plan.indptr, N),
            rtol=RTOL, atol=ATOL)
        ms = _time_ms(lambda: ops.segment_sum_op(flat, plan))
        plain = _time_ms(lambda: segment_sum_ref(flat, plan.perm,
                                                 plan.indptr, N))
        dst = block.dst.long()
        lib = _time_ms(lambda: torch.zeros(N, D, device=DEVICE).index_add_(
            0, dst, flat))
        nbytes = 4 * (E * D + E + (N + 1) + N * D)
        bound, by = _bound(nbytes, E * D)
        rows["segment_sum"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=lib,
                                   shape=f"E={E} N={N} D={D}")
        cot = torch.randn((N, D), generator=gen, device=DEVICE)
        torch.testing.assert_close(
            ops.segment_sum_bwd_op(cot, plan),
            segment_sum_bwd_ref(cot, plan.edge_dst), rtol=RTOL, atol=ATOL)
        ms = _time_ms(lambda: ops.segment_sum_bwd_op(cot, plan))
        plain = _time_ms(lambda: segment_sum_bwd_ref(cot, plan.edge_dst))
        idx = plan.edge_dst.clamp_max(N - 1)
        lib = _time_ms(lambda: cot.index_select(0, idx))
        bound, by = _bound(4 * (N * D + E + E * D), 0)
        rows["segment_sum_bwd"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                       bound_by=by, library_ms=lib,
                                       shape=f"E={E} N={N} D={D}")
    for name, r in rows.items():
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# -- phases 7 and 8: training --------------------------------------------------


def _fit_job(job, steps: int):
    """Make the job's trainer and fit ``steps`` steps, the first alone so
    its gradients can be read. Returns (trainer, views, losses, step-1
    grads on the CPU, seconds of steps 2.. with the device drained)."""
    import torch
    from repro_torch import api
    trainer, views, *_ = api.make_trainer(job)
    losses = trainer.fit(views, steps=1)["losses"]
    grads = {k: p.grad.detach().cpu() for k, p in trainer.params.items()}
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += trainer.fit(views, steps=steps - 1)["losses"]
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return trainer, views, losses, grads, time.perf_counter() - t0


def _profile(trainer, views, step_ms: float, steps: int = 5) -> None:
    """Device time per step by kernel over ``steps`` more steps, from a
    ``torch.profiler`` trace, and the device's busy share against the
    unprofiled step time ``step_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.fit(views, steps=steps)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3 / steps, e.count
                       / steps, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    print(f"    profile ({steps} steps): device busy {busy:.3f} ms per "
          f"step in {sum(k[1] for k in kernels):.0f} device ops, "
          f"{100 * busy / step_ms:.1f}% of the unprofiled "
          f"{step_ms:.3f} ms step; largest:")
    for ms, n, key in kernels[:6]:
        print(f"      {ms:.4f} ms/step over {n:.0f} calls  {key[:90]}")


def train(config: str, label: str, bwd_kernel: str) -> dict:
    """Train the config module's model on the card under each strategy,
    hold it against the same job on the CPU, and return the launch counts
    of the card runs. Then repeat 20 global steps on the card and report
    whether the two runs agree bit for bit."""
    import dataclasses
    import importlib
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import config_for, resolve_graph
    mod = importlib.import_module(f"repro_torch.configs.{config}")
    cfg = mod.CONFIG
    g = resolve_graph(mod.DATASET, cfg.model, seed=0)
    if config_for(g, cfg.model, cfg.num_layers, cfg.hidden_dim) != cfg:
        raise AssertionError(f"{config}: the trained model is not CONFIG")
    total = {}
    for strategy, tcfg in mod.TRAIN.items():
        job = api.TrainJob(
            dataset=mod.DATASET, model=cfg.model, strategy=strategy,
            steps=TRAIN_STEPS, num_layers=cfg.num_layers,
            hidden=cfg.hidden_dim, lr=tcfg.lr,
            weight_decay=tcfg.weight_decay, seed=tcfg.seed, compact=True,
            halo_hops=tcfg.cluster_halo_hops, eval_every=0, device=DEVICE)
        ops.reset_launches()
        card, views, losses, grads, wall = _fit_job(job, TRAIN_STEPS)
        launches = dict(ops.launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        _, _, want, want_grads, _ = _fit_job(
            dataclasses.replace(job, device="cpu"), TRAIN_STEPS)
        g_err = max(float((grads[k] - want_grads[k]).abs().max())
                    / max(float(want_grads[k].abs().max()), 1e-30)
                    for k in want_grads)
        l_err = max(abs(a - b) / max(1.0, abs(b))
                    for a, b in zip(losses, want))
        t = card.timing
        print(f"  [{label}, {cfg.model}, {strategy}] {TRAIN_STEPS} steps, "
              f"buckets {dict(card.step_calls)}: "
              f"{(TRAIN_STEPS - 1) / wall:.2f} steps/s over steps 2-"
              f"{TRAIN_STEPS}; host staging {t['stage_s']:.4f} s, device "
              f"step {t['step_s']:.4f} s (host clock, all steps)")
        print(f"    loss {losses[0]:.5f} -> {losses[-1]:.5f} (CPU "
              f"{want[0]:.5f} -> {want[-1]:.5f}); card vs CPU: step-1 "
              f"gradients max rel err {g_err:.3e} (tolerance {GRAD_TOL}), "
              f"losses max rel err {l_err:.3e} (tolerance {LOSS_TOL})")
        print(f"    launches: {launches}, "
              f"{launches[bwd_kernel] / TRAIN_STEPS:.2f} {bwd_kernel} per "
              "step")
        _profile(card, views, 1e3 * wall / (TRAIN_STEPS - 1))
        if not np.isfinite(losses).all() or len(losses) != TRAIN_STEPS:
            raise AssertionError(f"{strategy}: bad losses {losses}")
        if g_err > GRAD_TOL:
            raise AssertionError(f"{strategy}: step-1 gradients differ "
                                 f"from the CPU's by {g_err:.3e}")
        if l_err > LOSS_TOL:
            raise AssertionError(f"{strategy}: losses differ from the "
                                 f"CPU's by {l_err:.3e}")
        if strategy == "global" and not losses[-1] < losses[0]:
            raise AssertionError(f"global: the loss did not fall "
                                 f"({losses[0]} -> {losses[-1]})")
        if launches[bwd_kernel] <= 0:
            raise AssertionError(f"{strategy}: no {bwd_kernel} launch")

    # the same 20 global steps twice on the card: a report, not a gate
    job = api.TrainJob(dataset=mod.DATASET, model=cfg.model, steps=20,
                       num_layers=cfg.num_layers, hidden=cfg.hidden_dim,
                       lr=mod.TRAIN["global"].lr, eval_every=0,
                       device=DEVICE)
    runs = []
    for _ in range(2):
        trainer, views, *_ = api.make_trainer(job)
        losses = trainer.fit(views, steps=20)["losses"]
        runs.append((losses, {k: v.detach().cpu() for k, v in
                              trainer.model.state_dict().items()}))
    (la, pa), (lb, pb) = runs
    same = la == lb and all(bool((pa[k] == pb[k]).all()) for k in pa)
    diff = max([abs(a - b) for a, b in zip(la, lb)]
               + [float((pa[k] - pb[k]).abs().max()) for k in pa])
    print(f"  bitwise repeat, 20 global steps twice on the card: "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}, largest "
          f"difference over losses and final parameters {diff:.3e}")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="stop after phase 3 (build and check the kernels)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"\n== {name} == ({time.perf_counter() - t_start:.0f}s "
              "into the run)", flush=True)

    phase("1. device")
    resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    label = card_label()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{kind} x{torch.cuda.device_count()}; nvidia-smi: {label}")

    phase("2. build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {sorted(build.SIGNATURES)} in "
          f"{time.perf_counter() - t0:.1f}s")

    phase("3. kernels vs plain, on the card")
    errs = check_kernels()
    if args.only == "kernels":
        return 0

    # launches on the main paths: each path's counts are set to 0 just
    # before it runs and read just after; the JSON record sums them
    launches = {k: 0 for k in KERNELS}

    def count(got: dict) -> None:
        for k in launches:
            launches[k] += got[k]

    phase("4. serve GAT-E (alipay_like)")
    requests = 512
    got = serve("gnn_gat_e_alipay", label, requests)
    if got["edge_softmax"] <= 0:
        raise AssertionError("GAT-E serving launched no edge_softmax kernel")
    print(f"  {got['edge_softmax'] / requests:.3f} edge_softmax launches "
          "per served request")
    count(got)

    phase("5. serve GCN (reddit_like + self-loops)")
    got = serve("gnn_gcn_reddit", label, requests)
    if got["segment_sum"] <= 0:
        raise AssertionError("GCN serving launched no segment_sum kernel")
    print(f"  {got['segment_sum'] / requests:.3f} segment_sum launches per "
          "served request")
    count(got)

    phase("6. kernel times")
    rows = kernel_times()

    phase("7. train GAT-E (alipay_like)")
    count(train("gnn_gat_e_alipay", label, "edge_softmax_bwd"))

    phase("8. train GCN (reddit_like + self-loops)")
    count(train("gnn_gcn_reddit", label, "segment_sum_bwd"))
    phase("done")

    record = {"kernels": [
        {"name": k, "route": "cuda", **KERNELS[k],
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": rows[k]["ms"], "plain_ms": rows[k]["plain_ms"],
         "bound_ms": rows[k]["bound_ms"], "bound_by": rows[k]["bound_by"],
         "library_ms": rows[k]["library_ms"]} for k in KERNELS]}
    print()
    print(label)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
