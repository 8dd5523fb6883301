#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py                  # every phase; needs one card
    python3 chip_smoke.py --only kernels   # phases 1-3: build and check
    python3 chip_smoke.py --only gnn-times # and the GNN kernels' times
    python3 chip_smoke.py --only lm-times  # and the LM kernels' times
    python3 chip_smoke.py --only lm        # and the LM phases 12-13
    python3 chip_smoke.py --only runtime   # phases 1-2 and the runtime's 11
    python3 chip_smoke.py --only graphs    # phases 1-2 and the graphs' 14
    python3 chip_smoke.py --only engine    # phases 1-2 and the engine's 15

Phases (each raises on failure, so the script exits non-zero):

1. device — the card's name, count and power limit (nvidia-smi);
2. build — nvcc builds the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` and prints the ``-Xptxas -v`` report;
3. kernels vs plain — each kernel, forward and backward, against its
   plain PyTorch version on the card, at the serving and training paths'
   bucket shapes and at the edge cases (empty, masked and all-masked
   rows, pad edges that clip to the last row, no edges, no rows, a width
   that is not a multiple of 4, 4 heads of 16, a cotangent that is not
   contiguous); the segment-max pair exactly, over ties, empty,
   all-masked and NaN rows, pad edges, no edges and no rows, at widths
   64, 128 and 130; both forward kernels also over hub rows of 5,000 to
   6,000 edges, which they cut into pieces and merge (masked,
   all-masked and NaN hubs, hubs at the first and last rows beside empty
   rows, pad edges behind a hub, 4 heads of 16), over the GAT-E cells'
   own 20,000-node alipay_like plan, and ``edge_softmax`` over two plans
   of 1.1 million rows plus edges, which it runs as merge-path chunks;
   on those power-law rows ``segment_sum`` is held against a float64
   sum, within 1e-5 of each row's sum of |x|, also at widths 4, 8, 32,
   64, 128 and 130 over hub rows of 65 to 5,000 edges; and rows of 65 to
   5,000 edges behind a leading row of 0, 1, 17 or 63 edges must give the
   same bits through ``segment_sum``, ``edge_softmax`` and
   ``segment_max`` (row cuts counted from the row's start);
4. serve GAT-E (alipay_like, 20,000 nodes, published widths) on the card
   through ``repro_torch.launch.serve_gnn``: 512 requests, 4 clients,
   cache on; every response held against the same port run on the CPU,
   a cache hit held against a full recompute (16 seeded targets and the
   graph's highest in-degree node), the kernel's launch count read;
5. serve GCN (reddit_like + self-loops, hidden 128), the same way;
6. kernel times at layer 0 of a full-graph step (GAT-E on a
   1,000,000-node alipay_like graph, GCN on reddit_like; the segment-max
   pair on the 1,000,000-node plan at width 64), forward and backward:
   each kernel held against its plain version there, then kernel, plain
   version and library call timed with CUDA events, beside the bound from
   bytes moved; and the gather backward (a segment sum over the source
   plan) beside torch's ``index_add_``; ``edge_softmax`` and
   ``segment_max`` also on a hub-free plan of the same N and E, on the
   cells' layer-0 plans and a bucket each, and ``edge_softmax`` on
   power-law plans either side of its schedule switch; the GAT-E
   gathers' backward (``segment_sum`` at widths 32 and 4) over the 1M
   source plan and the cells' 20,000-node source and destination plans,
   and ``edge_softmax_bwd`` at both sizes; one JSON ``plan row`` each,
   with the profiled device ms beside the CUDA-event time;
7. train GAT-E (alipay_like, 20,000 nodes, the config's widths and lr)
   on the card through ``repro_torch.api.make_trainer`` and ``fit``
   (builder threads at the default count), 30 steps under each of
   global, mini (compact) and cluster (compact, halo 1), and the same
   jobs on the CPU from the same seed: step-1 gradients and every
   step's loss held against the CPU's, the same jobs on the card with
   inline staging must give the same losses bit for bit (their steps/s
   printed beside the threads'), the global loss must
   fall, the backward kernel must launch the same number of times on
   every step, and each Sum-stage kernel's profiled device ms a step is
   printed; then the same 20 global steps run twice on the card must
   agree bit for bit;
8. train GCN (reddit_like + self-loops, hidden 128), the same way;
9. serve SAGE-max (reddit_like without self-loops, the Reddit config's
   widths with the model swapped), as in phases 4-5;
10. train SAGE-max (the same job), as in phases 7-8;
11. the fault-tolerant runtime on the GAT-E and GCN mini cells at the
    configs' widths, 30 steps each through ``api.make_trainer`` and
    ``fit``: inline staging, builder threads 1 and 3, sampler processes
    (2) and the chaos run (the reference's chaos plan and a sampler
    killed mid-build, 3 processes, a checkpoint every 5 steps) must agree
    bit for bit in losses and final parameters; a 15-step run with
    checkpoints and a fresh trainer's ``resume=True`` for 15 more must be
    the uninterrupted run, the stream's cursor at 30; skip_view and
    rollback (a checkpoint every 2 steps) with a divergence injected at
    view 4 must end at step 29 and equal, bit for bit, a run over views
    0-3 and 5-29; the card's step-15 checkpoint must take one step on the
    CPU within ``LOSS_TOL`` of the card's step-16 loss; the process pool
    must not degrade to threads. Then, for the mini and cluster cells of
    both configs, ``stage_s`` (``first_stage_s`` of it the first view's
    wait, which holds a sampler pool's start), ``step_s`` and steps/s
    for inline staging, builder threads and sampler processes (default
    count), one JSON ``runtime row`` each;
12. serve Qwen3-4B at full width and depth (36 layers, d 2560) through
    ``repro_torch.launch.serve.BatchServer``: first the float32 parity
    gates on left-padded prompts (prefill plus 8 decode steps: the
    ``flash_attention`` kernel against its plain version at full depth
    on the card, one launch per layer on the kernel path and none on
    the plain one; then card against CPU at depth 2, decode fed seeded
    tokens and then the CPU's own argmax), then a bf16 serving run of 40
    requests (prompts uniform in 512-2048 tokens, 128 new tokens each,
    batch 4) with its tokens/s, the kernel's launches per prefill batch,
    a profile of one short batch and the bf16 kernel-vs-plain
    difference;
13. serve RWKV-6 1.6B (24 layers, d 2048) the same way through the
    ``wkv6`` kernel (prompts of whole 128-token chunks, 512-2048; the
    parity gates also cover the prefill's final states).
14. CUDA graphs per bucket (run after phase 11): the GNN train step
    (forward, backward, Adam) and the served forward are one CUDA graph
    per bucket on the card, the default, so phases 4-11 already run
    under replay; here every training cell (GAT-E, GCN and SAGE-max at
    the configs' widths under global, mini and cluster on compact views,
    and dense mini and cluster for GAT-E and GCN) runs 30 steps eagerly
    (``cuda_graphs=False``) and 30 under replay: losses, step-1 gradients
    and final parameters bitwise equal, exactly one capture per touched
    bucket (``assert_compiled_per_bucket``); the dense cells also against
    the CPU (phases 7-8's tolerances) and against the compact cell on the
    same stream indices (losses within 1e-3 * max(1, |loss|): cuBLAS may
    pick other algorithms for other row counts); then steady steps/s
    eager against replay in alternating order and the busy share under
    replay, one JSON ``graphs row`` each. The three served models: 512
    responses in fixed batches bitwise equal eager against replay, a
    cache hit bitwise a recompute under replay, one capture per bucket,
    and QPS and p50/p99 eager against replay (``serve row``). Last, ten
    alternating pairs of builder threads against inline staging under
    replay on the GAT-E and GCN mini cells, every fit's losses bitwise
    equal (``pairs row``).
15. the distributed engine (run after phase 14): the engine ``Trainer``
    through ``repro_torch.api.make_trainer`` with ``engine_partitions=4``
    (``1d_src``), all four partitions on the one card (``LocalComm``: no
    network time is measured). First ``segment_max`` and
    ``segment_max_bwd`` at width 4, GAT-E's logits, on shard 0's plan of
    the 20,000-node alipay_like graph, exactly their plain versions over
    ties and masked entries, timed (``plan row``). Then GAT-E (the
    config's widths) on that graph: one Trainer fits 30 steps of global,
    then mini, then cluster views (compact), with no restart, exactly one
    capture of the step; step 1 on the card against the CPU engine
    (loss and gradients within 1e-4) and its loss against one block's
    (the card ``CompactTrainer``) on the same global view within
    1e-4 * max(1, |loss|); the replayed fit bitwise equal to an eager
    one and to a second replayed fit; ``segment_sum``, ``segment_sum_bwd``,
    ``segment_max`` and ``segment_max_bwd`` launched, and no plain
    version called. GCN and SAGE-max (the Reddit config) on reddit_like
    over global views, the same checks. The engine's chaos scenarios,
    each bitwise its clean run. Last, GAT-E global on a 200,000-node
    alipay_like graph at P=1 and P=4. Each run prints a JSON ``engine
    row``: steps/s eager and under replay, the replayed step's busy
    share, launches per step by kernel, halo values per sync, the floats
    per value and bytes exchanged per step, and ``build_partitions``
    seconds. A ``gather row`` per width times ``index_select``, the
    engine's gathers, beside advanced indexing at the 200k graph's
    edges.

Phase 3 also holds ``flash_attention`` (causal, non-causal, window,
``seq_len < T``, ``kv_start`` with fully masked rows, GQA 1 and 4, D 32,
64 and 128, ragged T, T 129, 255 and 4,100 across the bf16 kernel's
tiles, a ``kv_start`` and a window edge inside a tile) and ``wkv6`` (B >
1, ragged T, T 1 and 33, B*H of 4, the final state; o in r's type and
float32) in float32 and bfloat16 (element by element) against their
plain versions; phase 6 times them at the Qwen3-4B and RWKV-6 1.6B
prefill shapes and at the served batch's, ``flash_attention`` beside
``scaled_dot_product_attention`` (timed only: the port never calls it)
and that call's share of the bf16 element gate. Phases 12-13 also print
each LM kernel's profiled device ms per batch and gate two identical
bf16 prefills bitwise equal. The GNN cache hits of phases 4, 5 and 9
must equal a full recompute bit for bit.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
RTOL = ATOL = 1e-5                 # kernel vs plain: sums in another order
WKV_TOL = 1e-4                     # wkv6 vs plain, float32
BF16_RTOL = 1e-2                   # LM kernels vs plain in bf16, each
BF16_ATOL = 1e-3                   # element: one bf16 ulp (< 2^-7 |out|),
                                   # plus 1e-3 * rms(out) of float32 noise
LIB_REL = 2e-2                     # bf16 kernel vs the library call,
                                   # * max|out| (it rounds p to bf16)
LM_PARITY = 1e-3                   # f32 kernel vs plain logits, * max|logit|
LM_CPU = 1e-4                      # f32 card vs CPU logits, * max|logit|
SERVE_TOL = 1e-4                   # card vs CPU responses
GRAD_TOL = 1e-4                    # card vs CPU step-1 gradients, relative
LOSS_TOL = 1e-3                    # card vs CPU losses, * max(1, |loss|)
TRAIN_STEPS = 30
RUNTIME_STEPS = 30                 # phase 11's runs
# the reference's chaos plan (tests/test_faults.py) and a sampler process
# killed mid-build: every fault is retried or recovered, so the run is
# bitwise the fault-free one
CHAOS_PLAN = {"worker_kill": {1}, "view_build": {0, 2}, "device_put": {0},
              "checkpoint_save": {0}, "proc_kill": {3}}
FAST = dict(backoff_base=0.0, backoff_cap=0.0, jitter=0.0)
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
    "segment_max": {
        "source": "src/repro_torch/kernels/csrc/segment_max.cu",
        "replaces": "src/repro/kernels/segment_sum.py:230"},
    "segment_max_bwd": {
        "source": "src/repro_torch/kernels/csrc/segment_max_bwd.cu",
        "replaces": "src/repro/kernels/backward.py:140"},
    "flash_attention": {
        # bf16, the served path's (float32 keeps flash_attention.cu)
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89"},
    "wkv6": {
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:78"},
}
MAX_WIDTH = 64                     # the Reddit config's feature width
LM_REQUESTS = 40                   # LM serving run: seeded requests,
LM_PROMPTS = (512, 2048)           # prompt lengths uniform in this range,
LM_NEW_TOKENS = 128                # new tokens each,
LM_BATCH = 4                       # in batches of 4


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def _ids(rng, n, e, hub=(), empty=()):
    """Sorted destination ids: ``e`` uniform over ``n`` rows, none in the
    rows ``empty``, plus ``deg`` more for each ``(row, deg)`` of ``hub``."""
    import numpy as np
    ids = rng.integers(0, n, e)
    ids = ids[~np.isin(ids, np.asarray(empty, dtype=np.int64))]
    return np.sort(np.concatenate(
        [ids] + [np.full(deg, row) for row, deg in hub])).astype(np.int32)


def _case(rng, n, e, h, d, *, mask=0.0, all_masked=0, e_pad=0, n_pad=0,
          hub=(), empty=(), masked_rows=()):
    """Inputs shaped as a served block: (plan, logits, values) on the card.
    ``mask`` masks that share of edges, ``all_masked`` every edge of the
    first rows and ``masked_rows`` every edge of those rows; ``hub`` adds
    hub rows and ``empty`` empties rows (:func:`_ids`); ``e_pad``/``n_pad``
    make a bucket with pad edges."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_bucket_csc_plan
    from repro_torch.kernels.ref import NEG
    ids = _ids(rng, n, e, hub, empty)
    e = len(ids)
    logits = (rng.normal(size=(max(e, e_pad), h)) * 3).astype(np.float32)
    values = rng.normal(size=(max(e, e_pad), h, d)).astype(np.float32)
    masked = ((rng.random(e) < mask) | (ids < all_masked)
              | np.isin(ids, np.asarray(masked_rows, dtype=np.int64)))
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
    """Both backward kernels against their plain versions on one case;
    ``segment_sum_bwd`` exactly (a gather is a copy), under its rule's
    schedule and under each of its two schedules."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (edge_softmax_bwd_ref,
                                         segment_sum_bwd_ref)
    got = ops.segment_sum_bwd_op(g, plan)
    d_lg, d_v = ops.edge_softmax_bwd_op(g, lg, v, out, m, den, plan)
    gc = g.contiguous()
    want = segment_sum_bwd_ref(gc.flatten(1), plan.edge_dst)
    forced = [ops._segment_sum_bwd_cuda(gc.flatten(1), plan, s)
              for s in ops.SUM_BWD_SCHEDULES]
    w_lg, w_v = edge_softmax_bwd_ref(gc, lg, v, m, den, (out * gc).sum(-1),
                                     plan.edge_dst)
    torch.cuda.synchronize()
    for kname, pairs, tol in (
            ("segment_sum_bwd", [(x, want) for x in [got.flatten(1)]
                                 + forced], 0.0),
            ("edge_softmax_bwd", [(d_lg, w_lg), (d_v, w_v)], RTOL)):
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=tol, atol=tol,
                                       msg=f"{kname} on {name}")
            if a.numel():
                worst[kname] = max(worst[kname], float((a - b).abs().max()))


def _max_case(rng, n, e, d, *, mask=0.0, all_masked=0, relu=False, nan=0,
              e_pad=0, n_pad=0, hub=(), empty=(), masked_rows=(),
              nan_rows=()):
    """Inputs shaped as the max combine hands them to the kernel: (plan,
    data) on the card, masked edges at NEG. ``relu`` clamps at 0 (the
    ties of layer 1, which pools ReLU outputs), ``nan`` puts NaN in that
    many entries and ``nan_rows`` in one entry of each of those rows;
    ``hub``, ``empty`` and ``masked_rows`` as in :func:`_case`; pad edges
    carry garbage and read row N - 1."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_bucket_csc_plan
    from repro_torch.kernels.ref import NEG
    ids = _ids(rng, n, e, hub, empty)
    e = len(ids)
    data = rng.normal(size=(max(e, e_pad), d)).astype(np.float32)
    if relu:
        data = np.maximum(data, 0)
    masked = ((rng.random(e) < mask) | (ids < all_masked)
              | np.isin(ids, np.asarray(masked_rows, dtype=np.int64)))
    data[:e][masked] = NEG
    if nan and e:
        data[rng.choice(e, nan, replace=False),
             rng.integers(0, d, nan)] = np.nan
    for row in nan_rows:
        at = np.flatnonzero(ids == row)
        data[at[len(at) // 2], d // 2] = np.nan
    plan = build_bucket_csc_plan(ids, max(n, n_pad), max(e, e_pad))
    return plan.to(DEVICE), torch.from_numpy(data).to(DEVICE)


def _check_max_case(plan, data, rng, worst: dict, name: str) -> None:
    """The segment-max pair against its plain versions on one case."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_max_bwd_ref, segment_max_ref
    got = ops.segment_max_op(data, plan)
    want = segment_max_ref(data, plan.perm, plan.indptr, plan.num_segments)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                               msg=f"segment_max on {name}")
    for contiguous in (True, False):
        # the same values, transposed in memory when not contiguous
        g = torch.from_numpy(rng.normal(size=(
            data.shape[1], plan.num_segments)).astype("float32"))
        g = g.to(DEVICE).t()
        g = g.contiguous() if contiguous else g
        d_data = ops.segment_max_bwd_op(g, got, data, plan)
        w_data = segment_max_bwd_ref(g.contiguous(), want, data,
                                     plan.edge_dst)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            d_data, w_data, rtol=0, atol=0, equal_nan=True,
            msg=f"segment_max_bwd on {name}, contiguous={contiguous}")
    live = ~torch.isnan(want)
    if live.any():
        worst["segment_max"] = max(worst["segment_max"], float(
            (got - want)[live].abs().max()))
    if d_data.numel():
        worst["segment_max_bwd"] = max(worst["segment_max_bwd"], float(
            (d_data - w_data).nan_to_num().abs().max()))
    print(f"  max {name}: ok", flush=True)


def check_max_kernels(rng, worst: dict, alipay_plan) -> None:
    """The segment-max pair against its plain versions, exactly: a max
    picks one of its inputs and the backward multiplies by 1 or 0."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import build_csc_plan
    hub = ((1500, 5000),)          # 5,000 edges: 78 of the kernel's pieces
    cases = {
        # SAGE-max training buckets: layer 0 pools the 64 raw features,
        # layer 1 the 128 ReLU outputs (ties at 0); pad edges clip
        "sage_max_bucket_d64": dict(n=3500, e=90000, d=64, e_pad=131072,
                                    n_pad=4096),
        "sage_max_bucket_d128_relu": dict(n=3500, e=90000, d=128,
                                          relu=True, mask=0.1,
                                          e_pad=131072, n_pad=4096),
        "empty_rows": dict(n=5000, e=1000, d=64),
        "all_masked_rows": dict(n=500, e=4000, d=64, all_masked=100),
        "nan": dict(n=500, e=4000, d=64, nan=12),
        "no_edges": dict(n=300, e=0, d=64),
        "width_130": dict(n=700, e=5000, d=130, relu=True),
        # hub rows, cut into many pieces and merged
        "hub_d64": dict(n=3000, e=20000, d=64, hub=hub),
        "hub_all_masked": dict(n=3000, e=20000, d=64, hub=hub,
                               masked_rows=(1500,)),
        "hub_nan": dict(n=3000, e=20000, d=64, hub=hub, nan_rows=(1500,)),
        "hubs_first_last_d128_relu": dict(
            n=3000, e=3000, d=128, relu=True,
            hub=((0, 5000), (2999, 6000)), empty=(1, 2, 2997, 2998)),
        "hub_bucket_pad": dict(n=3000, e=20000, d=64,
                               hub=((2999, 5000),), e_pad=32768,
                               n_pad=4096),
        "hub_width_130": dict(n=700, e=5000, d=130, hub=((350, 5000),)),
    }
    for name, kw in cases.items():
        plan, data = _max_case(rng, **kw)
        _check_max_case(plan, data, rng, worst, name)
    # the GAT-E cells' own 20,000-node alipay_like plan, seeded messages
    data = torch.from_numpy(rng.normal(size=(
        alipay_plan.num_edges, MAX_WIDTH)).astype(np.float32)).to(DEVICE)
    _check_max_case(alipay_plan, data, rng, worst, "alipay_like_20k_d64")
    # no rows: every edge reads nothing, the gradient is zeros
    plan = build_csc_plan(np.zeros(64, np.int32), 0).to(DEVICE)
    g = torch.zeros((0, MAX_WIDTH), device=DEVICE)
    data = torch.randn((64, MAX_WIDTH), device=DEVICE)
    if (ops.segment_max_op(data, plan).shape != (0, MAX_WIDTH)
            or ops.segment_max_bwd_op(g, g, data, plan).any()):
        raise AssertionError("segment_max with no rows misbehaved")
    print("  max no_rows: ok", flush=True)


def _bf16_rel(got, want) -> float:
    """Largest |got - want| over the largest |want|, in float32."""
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def _bf16_check(got, want, what: str) -> float:
    """Hold a bf16 kernel output against its plain version element by
    element. Both read the same bf16 inputs, compute in float32 and round
    to bf16 once, so they may part by one bf16 ulp (under 2^-7 of |want|)
    where float32 sum-order noise crosses a rounding boundary, and by that
    noise near 0: ``|got - want| <= BF16_ATOL * rms(want) + BF16_RTOL *
    |want|``. Returns the worst element's share of its limit (<= 1)."""
    g, w = got.float(), want.float()
    if not w.numel():
        return 0.0
    atol = BF16_ATOL * float(w.square().mean().sqrt())
    share = float(((g - w).abs() / (atol + BF16_RTOL * w.abs())).max())
    if not share <= 1.0:
        raise AssertionError(f"{what}: bf16 kernel vs plain, the worst "
                             f"element at {share:.3f} of its limit (rtol "
                             f"{BF16_RTOL}, atol {BF16_ATOL} * rms)")
    return share


def check_lm_kernels(rng, worst: dict) -> None:
    """``flash_attention`` and ``wkv6`` against their plain versions on
    the card, in float32 (rtol/atol 1e-5 and 1e-4) and bfloat16 (element
    by element, :func:`_bf16_check`); ``worst`` keeps the float32 max abs
    error and the bf16 worst share of the limit."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, wkv6_ref
    # name -> (B, T, Hq, Hkv, D, causal, window, seq_len, kv_start)
    flash = {
        # the Qwen3-4B prefill of a served batch: GQA 4, D 128, left pad
        "qwen3_prefill": (4, 512, 32, 8, 128, True, 0, 0, (0, 37, 300, 448)),
        "causal_gqa1_d64": (2, 256, 4, 4, 64, True, 0, 0, None),
        "noncausal_d64": (2, 200, 4, 4, 64, False, 0, 0, None),
        "window_d128": (2, 300, 8, 2, 128, True, 48, 0, None),
        "seq_len_noncausal": (2, 256, 4, 1, 128, False, 0, 190, None),
        "seq_len_causal": (1, 256, 8, 2, 64, True, 0, 130, None),
        # row 0 sees no key at all, rows of 1 and 2 lose a prefix
        "kv_start_all_masked": (3, 150, 8, 2, 128, True, 0, 0, (150, 70, 5)),
        "ragged_t_gqa4": (2, 77, 8, 2, 64, True, 0, 0, (0, 10)),
        "window_kv_start": (2, 333, 4, 1, 64, True, 100, 0, (200, 3)),
        # lengths that cross the bf16 kernel's 128-row query and 64-key
        # tiles; D 32; a kv_start and a window edge inside a tile
        "t129": (1, 129, 8, 2, 128, True, 0, 0, None),
        "t255_noncausal": (2, 255, 4, 2, 64, False, 0, 0, None),
        "t4100_qwen_heads": (1, 4100, 32, 8, 128, True, 0, 0, None),
        "d32": (2, 200, 4, 2, 32, True, 0, 0, (0, 50)),
        "kv_start_mid_tile": (2, 300, 8, 2, 128, True, 0, 0, (70, 201)),
        "window_crosses_tile": (2, 400, 8, 2, 64, True, 100, 0, (0, 30)),
    }
    for name, (B, T, Hq, Hkv, D, causal, window, seq_len, start) in \
            flash.items():
        q = torch.from_numpy(rng.normal(size=(B, T, Hq, D)).astype(
            "float32")).to(DEVICE)
        k = torch.from_numpy(rng.normal(size=(B, T, Hkv, D)).astype(
            "float32")).to(DEVICE)
        v = torch.from_numpy(rng.normal(size=(B, T, Hkv, D)).astype(
            "float32")).to(DEVICE)
        kv = (None if start is None else
              torch.tensor(start, dtype=torch.int32, device=DEVICE))
        kw = dict(causal=causal, sliding_window=window, seq_len=seq_len,
                  kv_start=kv)
        for dtype in (torch.float32, torch.bfloat16):
            a, b, c = q.to(dtype), k.to(dtype), v.to(dtype)
            got = ops.flash_attention_op(a, b, c, **kw)
            want = flash_attention_ref(a, b, c, **kw)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                           msg=f"flash_attention on {name}")
                worst["flash_attention"] = max(
                    worst["flash_attention"],
                    float((got - want).abs().max()))
            else:
                worst["flash_attention_bf16"] = max(
                    worst.get("flash_attention_bf16", 0.0),
                    _bf16_check(got, want, f"flash_attention on {name}"))
            if start is not None and start[0] >= T:
                if got[0].any():
                    raise AssertionError(f"flash_attention on {name}: a "
                                         "row with no visible key is not 0")
        print(f"  flash {name}: ok", flush=True)
    # name -> (B, T, H, K): the RWKV-6 1.6B prefill of a served batch,
    # then ragged T, the reduced head width, one step, two tiles and one,
    # B*H of 4, and more (b, h) blocks than an H100 has SMs
    wkv = {"rwkv6_prefill": (4, 512, 32, 64), "ragged_t": (3, 77, 4, 64),
           "k32": (2, 45, 3, 32), "t1": (2, 1, 4, 64),
           "t33": (1, 33, 8, 64), "bh4": (1, 200, 4, 64),
           "bh4_k32": (2, 70, 2, 32), "bh160_ragged": (5, 77, 32, 64),
           "bh144_k32": (9, 40, 16, 32)}
    for name, (B, T, H, K) in wkv.items():
        r, kk, vv = (torch.from_numpy((rng.normal(size=(B, T, H, K)) * 0.5)
                                      .astype("float32")).to(DEVICE)
                     for _ in range(3))
        w = torch.from_numpy(np.exp(-np.exp(rng.normal(
            -2.0, 0.7, size=(B, T, H, K)))).astype("float32")).to(DEVICE)
        u = torch.from_numpy((rng.normal(size=(H, K)) * 0.1).astype(
            "float32")).to(DEVICE)
        # (input type, out_dtype): o in r's type, then float32 o from
        # bf16 inputs (the model's call)
        for dtype, out in ((torch.float32, None), (torch.bfloat16, None),
                           (torch.bfloat16, torch.float32)):
            a, b, c = r.to(dtype), kk.to(dtype), vv.to(dtype)
            o, S = ops.wkv6_op(a, b, c, w, u, out_dtype=out)
            w_o, w_S = wkv6_ref(a, b, c, w, u, out_dtype=out)
            torch.cuda.synchronize()
            if o.dtype != w_o.dtype:
                raise AssertionError(f"wkv6 on {name}: o in {o.dtype}")
            torch.testing.assert_close(S, w_S, rtol=WKV_TOL, atol=WKV_TOL,
                                       msg=f"wkv6 final state on {name}")
            if o.dtype == torch.float32:
                torch.testing.assert_close(o, w_o, rtol=WKV_TOL,
                                           atol=WKV_TOL,
                                           msg=f"wkv6 on {name}, {dtype} "
                                           "in, float32 out")
                worst["wkv6"] = max(worst["wkv6"],
                                    float((o - w_o).abs().max()),
                                    float((S - w_S).abs().max()))
            else:
                worst["wkv6_bf16"] = max(worst.get("wkv6_bf16", 0.0),
                                         _bf16_check(o, w_o,
                                                     f"wkv6 on {name}"))
        print(f"  wkv6 {name}: ok", flush=True)


def _sum_f64_err(got, flat, plan, what: str) -> float:
    """segment_sum's output against a float64 sum of the same rows: each
    element within rtol 1e-5 of its row's sum of |x| (the scale of a
    float32 sum's rounding error, which cancellation can leave far
    above the sum itself) plus atol 1e-6. Returns the max abs error."""
    from repro_torch.kernels.ref import segment_sum_ref
    n = plan.num_segments
    x = flat.double()
    want = segment_sum_ref(x, plan.perm, plan.indptr, n)
    scale = segment_sum_ref(x.abs(), plan.perm, plan.indptr, n)
    err = (got.double() - want).abs()
    bad = err > ATOL + RTOL * scale
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements past atol {ATOL} + rtol "
            f"{RTOL} * sum|x| of a float64 sum (max abs err "
            f"{float(err.max()):.3e})")
    return float(err.max()) if err.numel() else 0.0


def _check_case(plan, lg, v, rng, worst: dict, name: str,
                hub: bool = False) -> None:
    """segment_sum, edge_softmax and both backward kernels against their
    plain versions on one case. On hub rows (``hub``) segment_sum is held
    against a float64 sum instead (:func:`_sum_f64_err`): a float32 sum
    of thousands of edges in plan order and the plain version's atomic
    ``index_add_`` differ past the element gate where the row's values
    cancel, whichever is nearer the exact sum."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import edge_softmax_ref, segment_sum_ref
    flat = v.flatten(1)
    got = ops.segment_sum_op(flat, plan)
    want = segment_sum_ref(flat, plan.perm, plan.indptr, plan.num_segments)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    w_out, w_m, w_den = edge_softmax_ref(lg, v, plan.perm, plan.indptr,
                                         plan.num_segments)
    torch.cuda.synchronize()
    if hub:
        worst["segment_sum"] = max(worst["segment_sum"], _sum_f64_err(
            got, flat, plan, f"segment_sum on {name}"))
    for kname, pairs in (("segment_sum", [] if hub else [(got, want)]),
                         ("edge_softmax", [(out, w_out), (m, w_m),
                                           (den, w_den)])):
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                       msg=f"{kname} on {name}")
            if a.numel():
                worst[kname] = max(worst[kname], float((a - b).abs().max()))
    for contiguous in (True, False):
        g = _cotangent(rng, tuple(out.shape), contiguous)
        _check_backward(plan, lg, v, out, m, den, g, worst,
                        f"{name}, contiguous={contiguous}")
    print(f"  {name}: ok", flush=True)


OFFSET_DEGREES = (65, 412, 2832, 5000)
OFFSET_LEADS = (0, 1, 17, 63)


def check_offsets() -> None:
    """A row gives the same bits wherever it lies in a plan (ROADMAP
    C.14): rows of 65 to 5,000 edges behind a leading row of 0, 1, 17 or
    63 edges, through ``segment_sum`` at widths 32 and 4, ``edge_softmax``
    (4 heads of 8) and ``segment_max``; each launched twice, bitwise
    equal, and held against its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import build_csc_plan
    from repro_torch.kernels.ref import edge_softmax_ref, segment_max_ref
    for deg in OFFSET_DEGREES:
        rows = []
        for lead in OFFSET_LEADS:
            row, head = (np.random.default_rng(s) for s in (deg, 9 + lead))
            lg = np.concatenate([head.normal(size=(lead, 4)),
                                 row.normal(size=(deg, 4)) * 3])
            v = np.concatenate([head.normal(size=(lead, 4, 8)),
                                row.normal(size=(deg, 4, 8))])
            lg, v = (torch.from_numpy(a.astype(np.float32)).to(DEVICE)
                     for a in (lg, v))
            plan = build_csc_plan(np.repeat(np.int32([0, 1]), [lead, deg]),
                                  3).to(DEVICE)
            flat = v.flatten(1)

            def softmax_ok(out, what):
                for x, w in zip(out, edge_softmax_ref(lg, v, plan.perm,
                                                      plan.indptr, 3)):
                    torch.testing.assert_close(x, w, rtol=RTOL, atol=ATOL,
                                               msg=what)

            def max_ok(out, what):
                torch.testing.assert_close(out[0], segment_max_ref(
                    flat, plan.perm, plan.indptr, 3), rtol=0, atol=0,
                    msg=what)
            # name -> (kernel call, check against the plain version)
            calls = {
                "segment_sum d32": (
                    lambda: (ops.segment_sum_op(flat, plan),),
                    lambda out, what: _sum_f64_err(out[0], flat, plan, what)),
                "segment_sum d4": (
                    lambda: (ops.segment_sum_op(lg, plan),),
                    lambda out, what: _sum_f64_err(out[0], lg, plan, what)),
                "edge_softmax": (lambda: ops.edge_softmax_fwd_op(lg, v, plan),
                                 softmax_ok),
                "segment_max": (lambda: (ops.segment_max_op(flat, plan),),
                                max_ok),
            }
            got = {}
            for name, (kern, check) in calls.items():
                a, b = kern(), kern()
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"{name}: two launches differ")
                check(a, f"{name}, {deg} edges behind {lead}")
                got[name] = [x[1].cpu() for x in a]
            rows.append(got)
        for lead, got in zip(OFFSET_LEADS[1:], rows[1:]):
            for name, outs in got.items():
                if not all(torch.equal(x, y)
                           for x, y in zip(rows[0][name], outs)):
                    raise AssertionError(
                        f"{name}: a row of {deg} edges behind {lead} edges "
                        "differs from the same row at offset 0")
        print(f"  offsets: a row of {deg} edges behind 0, 1, 17, 63 edges: "
              "bitwise equal (segment_sum d32/d4, edge_softmax, "
              "segment_max)", flush=True)


def check_kernels() -> dict:
    """Max abs error of each kernel against its plain version over every
    case; raises past rtol/atol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan import build_csc_plan
    rng = np.random.default_rng(0)
    chunk_hubs = ((0, 5000), (100_000, 6000), (199_999, 5000))
    chunk_empty = (1, 2, 199_997, 199_998)
    sum_hubs = ((0, 65), (1500, 412), (2000, 2832), (2999, 5000))
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
        # hub rows (5,000 edges: 78 of the kernels' 64-edge pieces at
        # these sizes), cut into pieces and merged: masked edges, an
        # all-masked hub, hubs at the first and last rows beside empty
        # rows, pad edges behind a hub, 4 heads of 16 (two passes of the
        # warp)
        "hub": dict(n=3000, e=12000, h=4, d=8, mask=0.2,
                    hub=((1500, 5000),)),
        "hub_all_masked": dict(n=2000, e=8000, h=4, d=8,
                               hub=((700, 5000),), masked_rows=(700,)),
        "hubs_first_last": dict(n=3000, e=3000, h=4, d=8,
                                hub=((0, 5000), (2999, 6000)),
                                empty=(1, 2, 2997, 2998)),
        "hub_bucket_pad": dict(n=3000, e=10000, h=4, d=8,
                               hub=((2999, 5000),), e_pad=32768,
                               n_pad=4096),
        "hub_heads_4x16": dict(n=700, e=5000, h=4, d=16,
                               hub=((350, 5000),)),
        # segment_sum at the widths that give its warps 32, 16, 8, 4, 2
        # and 1 sub-warps (4 and 32: the GAT-E gathers' backward), over
        # hub rows of 65 to 5,000 edges, empty rows and pad edges
        **{f"sum_hubs_d{d}": dict(n=3000, e=9000, h=1, d=d, mask=0.1,
                                  hub=sum_hubs, empty=(1, 2, 2997),
                                  e_pad=32768, n_pad=4096)
           for d in (4, 8, 32, 64, 128, 130)},
        # plans of 2^19 rows plus edges or more, which edge_softmax.cu
        # runs as merge-path chunks of 256 items: hubs at the first and
        # last rows beside empty rows, an all-masked hub cut by a few
        # dozen chunk edges, masked edges (a fifth of the short rows all
        # masked), and the same behind pad edges in a bucket
        "chunks_hubs": dict(n=200_000, e=900_000, h=4, d=8, mask=0.2,
                            hub=chunk_hubs, empty=chunk_empty,
                            masked_rows=(100_000,)),
        "chunks_hubs_bucket_pad": dict(n=200_000, e=900_000, h=4, d=8,
                                       mask=0.2, hub=chunk_hubs,
                                       empty=chunk_empty,
                                       masked_rows=(100_000,),
                                       e_pad=1_048_576, n_pad=262_144),
    }
    worst = {k: 0.0 for k in KERNELS}
    for name, kw in cases.items():
        plan, lg, v = _case(rng, **kw)
        _check_case(plan, lg, v, rng, worst, name, hub="hub" in kw)
    # the GAT-E cells' own layer 0: the 20,000-node alipay_like plan
    # (a power-law plan: rows of up to 412 edges, so segment_sum is held
    # as on the hub cases)
    _, block, lg, v = _layer0_inputs("gnn_gat_e_alipay")
    _check_case(block.csc_plan, lg, v, rng, worst, "alipay_like_20k_layer0",
                hub=True)
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
    check_offsets()
    check_max_kernels(rng, worst, block.csc_plan)
    check_lm_kernels(rng, worst)

    def tol(k: str) -> str:
        if k.startswith("segment_max"):
            return "exact"
        if k == "segment_sum_bwd":
            return "exact, both schedules"
        if k in ("flash_attention", "wkv6"):
            t = RTOL if k == "flash_attention" else WKV_TOL
            return (f"f32 rtol/atol {t}; bf16 worst element "
                    f"{worst[k + '_bf16']:.3f} of its limit, rtol "
                    f"{BF16_RTOL} atol {BF16_ATOL}*rms")
        return f"rtol {RTOL}, atol {ATOL}"
    print("kernels: " + ", ".join(
        f"{k} max_abs_err={worst[k]:.3e} ({tol(k)}) pass" for k in KERNELS),
        flush=True)
    return worst


# -- phases 4 and 5: serving --------------------------------------------------


def _config(config: str, model=None):
    """``(CONFIG, DATASET)`` of the config module, its model swapped for
    ``model`` when given (widths and dataset kept)."""
    import dataclasses
    from repro_torch.config import get_gnn_config
    cfg, dataset = get_gnn_config(config)
    return (dataclasses.replace(cfg, model=model) if model else cfg), dataset


def serve(config: str, label: str, requests: int = 512,
          model_name=None) -> dict:
    """Serve a seeded trace on the card through the entry point's
    functions for the config module ``config`` (its model swapped for
    ``model_name`` when given), hold it against the CPU, and return the
    launch counts of the served run."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import (build_server, config_for,
                                              print_report, request_trace,
                                              resolve_graph, run_clients)
    cfg, dataset = _config(config, model_name)
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

    # a cache hit against a full recompute, on the card: 16 seeded
    # targets and the graph's highest in-degree node, whose row the
    # kernels cut into pieces when it has more than 64 in-edges
    rng = np.random.default_rng(1)
    indeg = np.bincount(g.dst, minlength=g.num_nodes)
    hub = int(indeg.argmax())
    targets = np.union1d(rng.choice(g.num_nodes, 16, replace=False), [hub])
    cached = build_server(g, model, layers, hidden, seed=0, device=DEVICE,
                          **kw)
    full = cached.submit(targets)
    hits0 = cached.cache.hits
    if not cached.cache.coverage(np.array([hub]))[0]:
        raise AssertionError(f"{model}: the hub {hub} is not a cache hit")
    again = cached.submit(targets)
    if cached.cache.hits == hits0:
        raise AssertionError(f"{model}: the second submit hit no cache row")
    same = bool(np.array_equal(again, full))
    print(f"  cache hit vs full recompute ({len(targets)} targets, the hub "
          f"{hub} with {int(indeg[hub])} in-edges among them): "
          f"{cached.cache.hits - hits0} hits, max_abs_err="
          f"{float(np.abs(again - full).max()):.3e}, bitwise={same}")
    if not same:
        raise AssertionError(f"{model}: a cache hit is not bitwise equal "
                             "to a full recompute")
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


def _bound(nbytes: float, nops: float,
           ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
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


def _device_ms(fn, calls: int = 20, tries: int = 3):
    """Device milliseconds per call of ``fn`` from a ``torch.profiler``
    trace: every CUDA kernel it launches, summed, so the host's time
    between launches (which sets CUDA-event times at a cell's small
    shapes) is left out. A trace that holds no CUDA kernel, or a kernel
    whose count of launches is not a multiple of ``calls`` (a trace that
    dropped events), is taken again, up to ``tries`` traces; then None:
    a profile that saw nothing is not a kernel that took no time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events and not any(e.count % calls for e in events):
            return sum(e.self_device_time_total
                       for e in events) / 1e3 / calls
        print(f"  (a trace of {calls} calls recorded "
              f"{[(e.key, e.count) for e in events]})", flush=True)
    print("  (no whole trace: device_ms null)", flush=True)
    return None


def _softmax_row(plan, logit, value) -> dict:
    """``edge_softmax`` on one plan: held against its plain version, then
    timed beside it (CUDA events; profiled device ms) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import edge_softmax_ref
    _, H, D = value.shape
    N = plan.num_segments
    E = int(plan.indptr[-1])       # real edges: a bucket's pads join no row
    for a, b in zip(ops.edge_softmax_fwd_op(logit, value, plan),
                    edge_softmax_ref(logit, value, plan.perm, plan.indptr,
                                     N)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    kern = (lambda: ops.edge_softmax_fwd_op(logit, value, plan))
    ms = _time_ms(kern)
    plain = _time_ms(lambda: edge_softmax_ref(
        logit, value, plan.perm, plan.indptr, N), 100.0)
    nbytes = 4 * (E * H + E * H * D + E + (N + 1) + N * H * D + 2 * N * H)
    bound, by = _bound(nbytes, 8 * E * H * D)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"E={E} N={N} H={H} D={D}")


def _max_row(plan, data) -> dict:
    """``segment_max`` on one plan: held against its plain version
    exactly, then timed beside it, ``scatter_reduce_`` over the
    destinations and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import NEG, segment_max_ref
    (E_all, D), N = data.shape, plan.num_segments
    E = int(plan.indptr[-1])       # real edges: a bucket's pads join no row
    torch.testing.assert_close(
        ops.segment_max_op(data, plan),
        segment_max_ref(data, plan.perm, plan.indptr, N), rtol=0, atol=0)
    kern = (lambda: ops.segment_max_op(data, plan))
    ms = _time_ms(kern)
    plain = _time_ms(lambda: segment_max_ref(data, plan.perm, plan.indptr,
                                             N), 100.0)
    # pad edges (destination N) land in one spare row
    idx = plan.edge_dst.long()[:, None].expand(E_all, D)
    rows = N + (E_all > E)
    lib = _time_ms(lambda: torch.full((rows, D), NEG, device=DEVICE)
                   .scatter_reduce_(0, idx, data, "amax", include_self=True),
                   100.0)
    bound, by = _bound(4 * (E * D + N * D) + 4 * (E + N + 1), E * D)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                shape=f"E={E} N={N} D={D}")


def _bwd_row(plan, logit, value, gen) -> dict:
    """``edge_softmax_bwd`` on one plan, after the forward: held against
    its plain version, then timed beside it (CUDA events; profiled device
    ms) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import edge_softmax_bwd_ref
    E, H, D = value.shape
    N = plan.num_segments
    out, m, den = ops.edge_softmax_fwd_op(logit, value, plan)
    cot = torch.randn((N, H, D), generator=gen, device=DEVICE)
    bwd = (lambda: ops.edge_softmax_bwd_op(cot, logit, value, out, m, den,
                                           plan))
    bwd_plain = (lambda: edge_softmax_bwd_ref(
        cot, logit, value, m, den, (out * cot).sum(-1), plan.edge_dst))
    for a, b in zip(bwd(), bwd_plain()):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    ms = _time_ms(bwd)
    plain = _time_ms(bwd_plain, 100.0)
    # reads g, out, logits, values, m, den, perm and indptr; writes
    # d_logits and d_values
    nbytes = 4 * (2 * N * H * D + 2 * E * H + 2 * E * H * D + 2 * N * H
                  + E + N + 1)
    bound, by = _bound(nbytes, 3 * E * H * D + 5 * E * H + 2 * N * H * D)
    return dict(ms=ms, device_ms=_device_ms(bwd), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"E={E} N={N} H={H} D={D}")


def _sum_row(plan, idx, width: int, gen) -> dict:
    """``segment_sum`` over ``plan`` (the plan over ``idx``) on seeded
    (E, width) data: held against a float64 sum, then timed beside its
    plain version, ``index_add_`` over ``idx`` (atomic: what torch's own
    backward of the gather runs) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_ref
    E, N = plan.num_edges, plan.num_segments
    data = torch.randn((E, width), generator=gen, device=DEVICE)
    _sum_f64_err(ops.segment_sum_op(data, plan), data, plan,
                 f"segment_sum at width {width}")
    kern = (lambda: ops.segment_sum_op(data, plan))
    ms = _time_ms(kern)
    plain = _time_ms(lambda: segment_sum_ref(data, plan.perm, plan.indptr,
                                             N), 100.0)
    idx = idx.long()
    lib = _time_ms(lambda: torch.zeros(N, width, device=DEVICE).index_add_(
        0, idx, data), 100.0)
    bound, by = _bound(4 * (E * width + N * width + E + N + 1), E * width)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                shape=f"E={E} N={N} D={width}")


def gat_e_cell_rows(gen) -> None:
    """The GAT-E cells' own layer-0 plans (20,000-node alipay_like): the
    gathers' backward (``segment_sum``) over the source and the
    destination plans at widths 32 and 4, and ``edge_softmax_bwd``."""
    _, block, logit, value = _layer0_inputs("gnn_gat_e_alipay")
    label = "alipay_like, 20000 nodes (GAT-E cells)"
    _plan_row("edge_softmax_bwd", label, _bwd_row(block.csc_plan, logit,
                                                  value, gen))
    for name, plan, idx in (("source", block.src_plan, block.src),
                            ("destination", block.csc_plan, block.dst)):
        for width in (32, 4):
            _plan_row("segment_sum", f"{label}, {name} plan, width {width}",
                      _sum_row(plan, idx, width, gen))


def _plan_row(kernel: str, plan: str, row: dict) -> None:
    print("  plan row " + json.dumps({"kernel": kernel, "plan": plan,
                                      **row}), flush=True)


def _max_times(plan, gen) -> dict:
    """The segment-max pair at the 1,000,000-node ``alipay_like`` plan,
    on seeded (E, 64) messages: each held against its plain version, then
    timed beside it, its bound and, for the forward, ``scatter_reduce_``
    over the destinations (the backward has no single PyTorch call)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_max_bwd_ref
    E, N, D = plan.num_edges, plan.num_segments, MAX_WIDTH
    data = torch.randn((E, D), generator=gen, device=DEVICE)
    rows = {"segment_max": _max_row(plan, data)}
    _plan_row("segment_max", f"alipay_like, {N} nodes (power law)",
              rows["segment_max"])
    fwd = ops.segment_max_op(data, plan)
    cot = torch.randn((N, D), generator=gen, device=DEVICE)
    torch.testing.assert_close(
        ops.segment_max_bwd_op(cot, fwd, data, plan),
        segment_max_bwd_ref(cot, fwd, data, plan.edge_dst), rtol=0, atol=0)
    ms = _time_ms(lambda: ops.segment_max_bwd_op(cot, fwd, data, plan))
    plain = _time_ms(lambda: segment_max_bwd_ref(cot, fwd, data,
                                                 plan.edge_dst), 100.0)
    # reads g, fwd, data and edge_dst; writes d_data
    bound, by = _bound(4 * (2 * E * D + 2 * N * D) + 4 * E, 2 * E * D)
    rows["segment_max_bwd"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=None,
                                   shape=f"E={E} N={N} D={D}")
    return rows


def _dest_plan(dataset: str, model: str, **graph_kw):
    """The destination plan of a full-graph block of ``dataset`` (as
    ``model`` sees it: GCN adds self-loops), on the card."""
    from repro_torch.graph import build_block
    from repro_torch.launch.serve_gnn import resolve_graph
    g = resolve_graph(dataset, model, seed=0, **graph_kw)
    return build_block(g, csc_plan=True).csc_plan.to(DEVICE)


def plan_rows(E: int, N: int, H: int, D: int, gen) -> None:
    """``edge_softmax`` and ``segment_max`` on more plans, one JSON row
    each: a hub-free plan with the 1,000,000-node plan's N and E (uniform
    destinations: what the kernels take when no row is a hub), the
    cells' own layer-0 plans (GAT-E's 20,000-node alipay_like; SAGE-max's
    reddit_like at width 64), ``edge_softmax`` on power-law plans on
    either side of its schedule switch, and a bucket of each (short
    rows)."""
    import numpy as np
    import torch
    from repro_torch.kernels.plan import build_bucket_csc_plan, build_csc_plan
    ids = np.sort(np.random.default_rng(0).integers(0, N, E))
    plan = build_csc_plan(ids.astype(np.int32), N).to(DEVICE)
    del ids
    logit = torch.randn((E, H), generator=gen, device=DEVICE) * 3
    value = torch.randn((E, H, D), generator=gen, device=DEVICE)
    _plan_row("edge_softmax", f"uniform, {N} nodes (hub-free)",
              _softmax_row(plan, logit, value))
    del logit, value
    data = torch.randn((E, MAX_WIDTH), generator=gen, device=DEVICE)
    _plan_row("segment_max", f"uniform, {N} nodes (hub-free)",
              _max_row(plan, data))
    del data, plan
    torch.cuda.empty_cache()
    _, block, logit, value = _layer0_inputs("gnn_gat_e_alipay")
    _plan_row("edge_softmax", "alipay_like, 20000 nodes (GAT-E cells)",
              _softmax_row(block.csc_plan, logit, value))
    plan = _dest_plan("reddit_like", "sage_max")
    data = torch.randn((plan.num_edges, MAX_WIDTH), generator=gen,
                       device=DEVICE)
    _plan_row("segment_max", "reddit_like (SAGE-max cells)",
              _max_row(plan, data))
    # edge_softmax on either side of its schedule switch (2^19 rows plus
    # edges, csrc/edge_softmax.cu's kLargePlan): alipay_like power-law
    # plans of 0.35, 0.7 and 1.4 million items, between the cells' 20k
    # plan (0.14 million) and the 1M one (7 million)
    for nodes in (50_000, 100_000, 200_000):
        plan = _dest_plan("alipay_like", "gat_e", num_nodes=nodes)
        e = plan.num_edges
        _plan_row("edge_softmax", f"alipay_like, {nodes} nodes (power law)",
                  _softmax_row(plan, torch.randn(
                      (e, H), generator=gen, device=DEVICE) * 3, torch.randn(
                      (e, H, D), generator=gen, device=DEVICE)))
    # bucket-padded views with short uniform rows, the kind the serving
    # and mini-batch paths stage: a GAT-E serving bucket and a SAGE-max
    # training bucket
    rng = np.random.default_rng(1)
    for kernel, n, e, n_pad, e_pad in (("edge_softmax", 3000, 12000, 4096,
                                        16384),
                                       ("segment_max", 3500, 90000, 4096,
                                        131072)):
        plan = build_bucket_csc_plan(
            np.sort(rng.integers(0, n, e)).astype(np.int32), n_pad,
            e_pad).to(DEVICE)
        label = f"bucket ({n_pad}, {e_pad}), {e} uniform edges"
        if kernel == "edge_softmax":
            row = _softmax_row(plan, torch.randn(
                (e_pad, H), generator=gen, device=DEVICE) * 3, torch.randn(
                (e_pad, H, D), generator=gen, device=DEVICE))
        else:
            row = _max_row(plan, torch.randn((e_pad, MAX_WIDTH),
                                             generator=gen, device=DEVICE))
        _plan_row(kernel, label, row)


# GCN's hidden width, the only width the system sends this kernel (its
# Sum stage's backward; the gathers' backward is segment_sum), and two
# narrower ones on either side of the schedules' crossover
SUM_BWD_WIDTHS = (128, 32, 4)
SUM_BWD_SWEEP = (4, 8, 16, 32, 64, 128)   # widths timed under both schedules


def _sum_bwd_rule(width: int):
    """The schedule ``segment_sum_bwd``'s rule takes for rows of
    ``width`` floats; None in an older tree whose kernel has one schedule
    (timed beside this one, as the README's recipe for parent and change
    in one call does)."""
    from repro_torch.kernels import ops
    rule = getattr(ops, "sum_bwd_schedule", None)
    return rule(width) if rule else None


def _sum_bwd_bytes(E: int, N: int, width: int) -> int:
    """What ``segment_sum_bwd`` must move whichever schedule runs: g and
    one E-long index read, d_data written."""
    return 4 * (N * width + E * width + E)


def _sum_bwd_row(plan, width: int, gen) -> dict:
    """``segment_sum_bwd`` on a destination plan on a seeded (N, width)
    cotangent, under its rule's schedule: held exactly against its plain
    version, then timed (CUDA events; profiled device ms) beside it,
    ``index_select`` over the clipped destinations (one PyTorch call for
    the same function) and its bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_bwd_ref
    E, N = plan.num_edges, plan.num_segments
    cot = torch.randn((N, width), generator=gen, device=DEVICE)
    kern = (lambda: ops.segment_sum_bwd_op(cot, plan))
    torch.testing.assert_close(kern(), segment_sum_bwd_ref(
        cot, plan.edge_dst), rtol=0, atol=0)
    ms = _time_ms(kern)
    plain = _time_ms(lambda: segment_sum_bwd_ref(cot, plan.edge_dst), 100.0)
    idx = plan.edge_dst.clamp_max(N - 1)
    lib = _time_ms(lambda: cot.index_select(0, idx), 100.0)
    bound, by = _bound(_sum_bwd_bytes(E, N, width), 0)
    return dict(ms=ms, device_ms=_device_ms(kern), plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                schedule=_sum_bwd_rule(width),
                shape=f"E={E} N={N} D={width}")


def _sum_bwd_sweep(label: str, plan, gen, widths=SUM_BWD_SWEEP) -> None:
    """Both of ``segment_sum_bwd``'s schedules on one plan at each of
    ``widths``, each held exactly against the plain version, then
    timed (CUDA events; profiled device ms): one JSON line a width, with
    the cotangent's size against the L2 cache and the rule's choice."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_bwd_ref
    E, N = plan.num_edges, plan.num_segments
    l2 = torch.cuda.get_device_properties(DEVICE).L2_cache_size
    for width in widths:
        cot = torch.randn((N, width), generator=gen, device=DEVICE)
        want = segment_sum_bwd_ref(cot, plan.edge_dst)
        row = {"kernel": "segment_sum_bwd", "plan": label,
               "shape": f"E={E} N={N} D={width}",
               "g_over_l2": 4 * N * width / l2,
               "rule": _sum_bwd_rule(width)}
        for schedule in ops.SUM_BWD_SCHEDULES:
            kern = (lambda: ops._segment_sum_bwd_cuda(cot, plan, schedule))
            torch.testing.assert_close(kern(), want, rtol=0, atol=0)
            row[f"{schedule}_ms"] = _time_ms(kern)
            row[f"{schedule}_device_ms"] = _device_ms(kern)
        row["bound_ms"] = _bound(_sum_bwd_bytes(E, N, width), 0)[0]
        del want
        print("  sum_bwd sweep " + json.dumps(row), flush=True)


def sum_bwd_times(gen=None, plan=None, sweep: bool = False) -> dict:
    """``segment_sum_bwd`` where the card does real work and on the GCN
    cells' plan: the 1,000,000-node alipay_like destination plan (built
    here unless ``plan`` is given) at widths 128, 32 and 4 and the
    reddit_like plan at the GCN config's hidden width, under the rule's
    schedule, one plan row each; with ``sweep``, both schedules at
    widths 4 to 128 on those plans and on 200,000- and 50,000-node
    alipay_like plans, whose cotangents lie on either side of the L2
    cache's size, and at widths 4 to 32 on a plan of 4,000,000 rows and
    24,000,000 edges in random order (uniform destinations), whose
    narrow cotangents outgrow it too. Returns the GCN cells' row."""
    import numpy as np
    import torch
    from repro_torch.config import get_gnn_config
    from repro_torch.kernels.plan import build_csc_plan
    gen = gen or torch.Generator(device=DEVICE).manual_seed(0)
    if plan is None:
        plan = _dest_plan("alipay_like", "gat_e", num_nodes=KERNEL_NODES)
    label = f"alipay_like, {plan.num_segments} nodes"
    for width in SUM_BWD_WIDTHS:
        _plan_row("segment_sum_bwd", f"{label}, destination plan, width "
                  f"{width}", _sum_bwd_row(plan, width, gen))
    plans = {label: plan}
    if sweep:
        for nodes in (200_000, 50_000):
            plans[f"alipay_like, {nodes} nodes"] = _dest_plan(
                "alipay_like", "gat_e", num_nodes=nodes)
    cfg, dataset = get_gnn_config("gnn_gcn_reddit")
    gcn = _dest_plan(dataset, cfg.model)
    width = cfg.hidden_dim
    record = _sum_bwd_row(gcn, width, gen)
    _plan_row("segment_sum_bwd", f"reddit_like (GCN cells), width {width}",
              record)
    plans["reddit_like (GCN cells)"] = gcn
    if sweep:
        for name, p in plans.items():
            _sum_bwd_sweep(name, p, gen)
        del plans, plan, gcn
        n = 4 * KERNEL_NODES
        ids = np.random.default_rng(2).integers(0, n, 6 * n)
        _sum_bwd_sweep(f"uniform, {n} nodes", build_csc_plan(
            ids.astype(np.int32), n).to(DEVICE), gen, SUM_BWD_SWEEP[:4])
    return record


def kernel_times() -> dict:
    """Kernel, plain-version and library times at full-graph sizes,
    forward and backward, each kernel's output first held against its
    plain version there."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_sum_ref
    rows = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.inference_mode():
        # GAT-E: edge_softmax and its backward at a full-graph layer 0
        g, block, logit, value = _layer0_inputs(
            "gnn_gat_e_alipay", num_nodes=KERNEL_NODES)
        plan = block.csc_plan
        E, H, D = value.shape
        N = plan.num_segments
        rows["edge_softmax"] = _softmax_row(plan, logit, value)
        _plan_row("edge_softmax", f"alipay_like, {N} nodes (power law)",
                  rows["edge_softmax"])
        rows["edge_softmax_bwd"] = _bwd_row(plan, logit, value, gen)
        _plan_row("edge_softmax_bwd", f"alipay_like, {N} nodes (power law)",
                  rows["edge_softmax_bwd"])
        # the GAT-E gathers' backward over the source plan, at the widths
        # of n (4 heads of 8) and of the logit halves (4 heads)
        for width in (32, 4):
            _plan_row("segment_sum", f"alipay_like, {N} nodes, source plan, "
                      f"width {width} (gathers' backward)",
                      _sum_row(block.src_plan, block.src, width, gen))
        del logit, value
        rows.update(_max_times(plan, gen))
        # segment_sum_bwd on the same destination plan (its schedules'
        # crossover is sum_bwd_times(sweep=True), run on its own)
        rows["segment_sum_bwd"] = sum_bwd_times(gen, plan)
        del g, block, plan
        torch.cuda.empty_cache()
        plan_rows(E, N, H, D, gen)
        gat_e_cell_rows(gen)

        # GCN: segment_sum at a full-graph layer 0 (sum_bwd_times above
        # times its backward)
        g, block, _, value = _layer0_inputs("gnn_gcn_reddit")
        plan = block.csc_plan
        flat = value.flatten(1)
        E, D = flat.shape
        N = plan.num_segments
        torch.testing.assert_close(
            ops.segment_sum_op(flat, plan),
            segment_sum_ref(flat, plan.perm, plan.indptr, N),
            rtol=RTOL, atol=ATOL)
        kern = (lambda: ops.segment_sum_op(flat, plan))
        ms = _time_ms(kern)
        plain = _time_ms(lambda: segment_sum_ref(flat, plan.perm,
                                                 plan.indptr, N))
        dst = block.dst.long()
        lib = _time_ms(lambda: torch.zeros(N, D, device=DEVICE).index_add_(
            0, dst, flat))
        nbytes = 4 * (E * D + E + (N + 1) + N * D)
        bound, by = _bound(nbytes, E * D)
        rows["segment_sum"] = dict(ms=ms, device_ms=_device_ms(kern),
                                   plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=lib,
                                   shape=f"E={E} N={N} D={D}")
        _plan_row("segment_sum", "reddit_like (GCN cells)",
                  rows["segment_sum"])

        # the NN-G gather's backward (ROADMAP C.7): the segment_sum kernel
        # over the source plan, against index_select's own backward, an
        # atomic index_add_ over src
        splan, src = block.src_plan, block.src.long()
        d_msg = torch.randn((E, D), generator=gen, device=DEVICE)
        torch.testing.assert_close(
            ops.segment_sum_op(d_msg, splan),
            torch.zeros(N, D, device=DEVICE).index_add_(0, src, d_msg),
            rtol=RTOL, atol=ATOL)
        ms = _time_ms(lambda: ops.segment_sum_op(d_msg, splan))
        lib = _time_ms(lambda: torch.zeros(N, D, device=DEVICE).index_add_(
            0, src, d_msg))
        print(f"  gather backward [E={E} N={N} D={D}]: segment_sum over the "
              f"source plan {ms:.4f} ms, index_add_ over src {lib:.4f} ms")
    for name, r in rows.items():
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def _flash_inputs(gen, B, T, Hq, Hkv, D):
    import torch
    return [torch.randn((B, T, h, D), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv)]


def _flash_bound(B, T, Hq, Hkv, D, pads=None) -> tuple:
    """q, k, v read and out written once, in bf16; causal attention does
    QK^T and PV, 2 * D multiply-adds each, over the visible (query, key)
    pairs of each head (T (T + 1) / 2 of a row, (T - pad) (T - pad + 1) /
    2 of a left-padded one), at the bf16 tensor-core peak."""
    nbytes = 2 * B * T * (2 * Hq * D + 2 * Hkv * D)
    pairs = sum((T - p) * (T - p + 1) / 2 for p in (pads or (0,) * B))
    nops = 4 * D * Hq * pairs
    return _bound(nbytes, nops, BF16_OPS_PER_S)


def _bf16_share(got, want) -> float:
    """:func:`_bf16_check`'s worst-element share, reported, not gated."""
    g, w = got.float(), want.float()
    atol = BF16_ATOL * float(w.square().mean().sqrt())
    return float(((g - w).abs() / (atol + BF16_RTOL * w.abs())).max())


def _flash_row(gen, B, T, pads=None, plain: bool = True) -> dict:
    """``flash_attention`` at the Qwen3-4B attention shape (32 q heads, 8
    kv heads of 128, bf16, causal), B rows of T with left ``pads``:
    held against its plain version (when ``plain``) and SDPA, then
    timed beside both. SDPA runs with ``is_causal`` or, with pads, a
    boolean mask; its share of the element gate against the plain
    version is reported over the rows that see a key."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    Hq, Hkv, D = 32, 8, 128
    q, k, v = _flash_inputs(gen, B, T, Hq, Hkv, D)
    start = (None if pads is None else
             torch.tensor(pads, dtype=torch.int32, device=DEVICE))
    # the library's layout, made once outside the timed call
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    mask = None
    if pads is not None:
        i = torch.arange(T, device=DEVICE)
        mask = ((i[None, :] <= i[:, None])[None]
                & (i[None, None, :] >= start.long()[:, None, None]))[:, None]
        # a masked call takes repeated kv heads (no GQA backend with masks)
        kt, vt = (a.repeat_interleave(Hq // Hkv, dim=1) for a in (kt, vt))

    def lib_fn():
        # never the math backend: its scores would not fit at 32k
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=mask is None)

    def kern():
        return ops.flash_attention_op(q, k, v, kv_start=start)
    got = kern()
    lib_out = lib_fn().transpose(1, 2)
    seen = (slice(None) if pads is None else
            torch.arange(T, device=DEVICE)[None, :] >= start[:, None])
    lib_rel = _bf16_rel(got[seen], lib_out[seen])
    if lib_rel > LIB_REL:
        raise AssertionError(f"flash_attention at B {B} T {T} vs SDPA: "
                             f"{lib_rel:.3e} of max|out|")
    plain_ms = lib_share = kern_share = None
    if plain:
        want = flash_attention_ref(q, k, v, kv_start=start)
        kern_share = _bf16_check(got, want, f"flash_attention at B {B} "
                                 f"T {T}")
        lib_share = _bf16_share(lib_out[seen], want[seen])
        del want
        plain_ms = _time_ms(lambda: flash_attention_ref(
            q, k, v, kv_start=start), 100.0)
    ms = _time_ms(kern, 100.0)
    lib = _time_ms(lib_fn, 100.0)
    bound, by = _flash_bound(B, T, Hq, Hkv, D, pads)
    shape = (f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
             + (f" pads={tuple(pads)}" if pads else ""))
    print(f"  flash_attention [{shape}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms} ms, SDPA {lib:.4f} ms, bound {bound:.4f} ms ({by}); "
          f"element-gate share vs plain: kernel {kern_share}, SDPA "
          f"{lib_share} (reported); kernel vs SDPA {lib_rel:.3e} of "
          "max|out|", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib, shape=shape)


def _wkv6_row(gen, B, T, H=32, K=64) -> dict:
    """``wkv6`` at the RWKV-6 1.6B shape (32 heads of 64), r/k/v in bf16,
    float32 o (the model's call): held against its plain version, then
    timed beside it and the bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import wkv6_ref
    r, kk, vv = (torch.randn((B, T, H, K), generator=gen, device=DEVICE)
                 .mul_(0.5).to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, H, K), generator=gen,
                                         device=DEVICE) * 0.7 - 2.0))
    u = torch.randn((H, K), generator=gen, device=DEVICE) * 0.1
    f32 = torch.float32
    o, S = ops.wkv6_op(r, kk, vv, w, u, out_dtype=f32)
    w_o, w_S = wkv6_ref(r, kk, vv, w, u, out_dtype=f32)
    torch.testing.assert_close(S, w_S, rtol=WKV_TOL, atol=WKV_TOL)
    torch.testing.assert_close(o, w_o, rtol=WKV_TOL, atol=WKV_TOL)
    ms = _time_ms(lambda: ops.wkv6_op(r, kk, vv, w, u, out_dtype=f32),
                  100.0)
    plain = _time_ms(lambda: wkv6_ref(r, kk, vv, w, u, out_dtype=f32), 100.0)
    n = B * T * H * K
    # r, k, v in bf16, w and o in f32 (14 bytes a (b, t, h, k)), u and
    # the f32 final state; an FMA for the output and one for the decayed
    # state per (k, v) and step (csrc/wkv6.cu's note counts the same)
    nbytes = 14 * n + 4 * H * K + 4 * B * H * K * K
    bound, by = _bound(nbytes, 4 * B * T * H * K * K)
    shape = f"B={B} T={T} H={H} K=V={K} bf16 in, f32 o"
    print(f"  wkv6 [{shape}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bound:.4f} ms ({by})", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, shape=shape)


def lm_kernel_times() -> dict:
    """``flash_attention`` at the Qwen3-4B prefill shapes: B 1 at T 4096
    (the record's row) and 32768 (kernel and SDPA: the plain version's
    scores would not fit), and the served batch (B 4, T 2048, left pads
    0, 37, 300, 448); ``wkv6`` at the RWKV-6 1.6B prefill, B 8 T 4096
    (the record's row) and the served batch, B 4 T 2048. Each kernel is
    held against its plain version there first."""
    import torch
    rows = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    with torch.inference_mode():
        rows["flash_attention"] = _flash_row(gen, 1, 4096)
        torch.cuda.empty_cache()
        _flash_row(gen, 1, 32768, plain=False)
        torch.cuda.empty_cache()
        _flash_row(gen, 4, 2048, pads=(0, 37, 300, 448))
        torch.cuda.empty_cache()
        rows["wkv6"] = _wkv6_row(gen, 8, 4096)
        _wkv6_row(gen, 4, 2048)
        torch.cuda.empty_cache()
    return rows


# -- phases 12 and 13: LM serving ----------------------------------------------


@contextlib.contextmanager
def plain_lm_kernels():
    """Inside the block the model's prefill calls the kernels' plain
    versions in place of the wrappers (the port itself has no such
    switch: on a CUDA tensor a wrapper launches its kernel)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, wkv6_ref
    saved = ops.flash_attention_op, ops.wkv6_op
    ops.flash_attention_op, ops.wkv6_op = flash_attention_ref, wkv6_ref
    try:
        yield
    finally:
        ops.flash_attention_op, ops.wkv6_op = saved


def _lm_run(model, toks, pads, feed=None, steps: int = 8):
    """Prefill a left-padded batch, then ``steps`` decode steps fed the
    tokens ``feed`` (B, steps), or, when it is None, each step's own
    argmax as the server feeds them; returns (logits of every step,
    float32 on the CPU; the prefill's final states for RWKV; the fed
    tokens)."""
    import torch
    dev = model.device
    B, P = toks.shape
    valid = torch.arange(P)[None, :] >= pads[:, None]
    positions = (torch.arange(P)[None, :] - pads[:, None]).clamp_min(0)
    batch = {"tokens": toks.to(dev), "valid": valid.to(dev),
             "positions": positions.to(dev, torch.int32)}
    logits, caches, idx = model.prefill(batch, cache_len=P + steps)
    out = [logits.float().cpu()]
    pre = [{k: (v.float().cpu() if torch.is_tensor(v) else None)
            for k, v in (c.get("time", {}) or {}).items()}
           for c in caches]
    fed = []
    for i in range(steps):
        tok = (feed[:, i:i + 1] if feed is not None
               else out[-1][:, -1].argmax(-1)[:, None])
        fed.append(tok)
        step = {"tokens": tok.to(dev), "valid": batch["valid"],
                "positions": (idx - pads.to(dev))[:, None].to(torch.int32)}
        logits, caches, idx = model.decode_step(step, caches, idx)
        out.append(logits.float().cpu())
    return torch.cat(out, 1), pre, torch.cat(fed, 1)


def _kernel_and_plain(model, kernel: str, toks, pads, feed):
    """``_lm_run`` through the kernels, then through their plain
    versions, on the same model; the counts show the two took different
    paths: one ``kernel`` launch per layer in the first, none in the
    second."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    got = _lm_run(model, toks, pads, feed)
    n = ops.launches[kernel]
    ops.reset_launches()
    with plain_lm_kernels():
        want = _lm_run(model, toks, pads, feed)
    if n != model.cfg.num_layers or any(ops.launches.values()):
        raise AssertionError(f"{kernel}: {n} launches on the kernel path "
                             f"(expected {model.cfg.num_layers}), "
                             f"{dict(ops.launches)} on the plain path")
    return got, want


def _prefill_repeat(model, toks, pads) -> None:
    """The same left-padded prefill twice on the card: logits and every
    cache tensor (the final WKV states of RWKV-6, K and V of attention)
    must be bitwise equal, since no kernel of the path sums in an order
    that changes from run to run."""
    import torch
    dev = model.device
    P = toks.shape[1]
    valid = torch.arange(P)[None, :] >= pads[:, None]
    batch = {"tokens": toks.to(dev), "valid": valid.to(dev),
             "positions": (torch.arange(P)[None, :] - pads[:, None])
             .clamp_min(0).to(dev, torch.int32)}

    def leaves(tree):
        if torch.is_tensor(tree):
            return [tree]
        items = tree.values() if isinstance(tree, dict) else tree
        return [x for t in items if t is not None for x in leaves(t)]
    runs = []
    for _ in range(2):
        logits, caches, _ = model.prefill(batch, cache_len=P)
        runs.append([logits] + leaves(caches))
    same = all(bool(torch.equal(a, b)) for a, b in zip(*runs))
    print(f"  bitwise repeat, one bf16 prefill ({len(toks)} prompts of "
          f"{P} padded tokens) twice on the card: "
          f"{'bitwise equal' if same else 'NOT bitwise equal'} over the "
          f"logits and {len(runs[0]) - 1} cache tensors")
    if not same:
        raise AssertionError("two identical prefills on the card differ")


def _profile_lm(server, reqs, kernel_key: str) -> None:
    """Device time by kernel over one short served batch (prefill and its
    decode rounds), from a ``torch.profiler`` trace, and the device's
    busy share against the same batch's unprofiled time; the port's LM
    kernel (names holding ``kernel_key``) on a line of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        r.out.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.run(reqs)
    batch_ms = 1e3 * (time.perf_counter() - t0)
    for r in reqs:
        r.out.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.run(reqs)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    print(f"    profile (one batch of {len(reqs)}, prompts "
          f"{[len(r.prompt) for r in reqs]}, {reqs[0].max_new} new tokens): "
          f"device busy {busy:.3f} ms in {sum(k[1] for k in kernels):.0f} "
          f"device ops, {100 * busy / batch_ms:.1f}% of the unprofiled "
          f"{batch_ms:.3f} ms batch; largest:")
    for ms, n, key in kernels[:6]:
        print(f"      {ms:.4f} ms over {n:.0f} calls  {key[:90]}")
    mine = [k for k in kernels if kernel_key in k[2]]
    print(f"    {kernel_key}: {sum(k[0] for k in mine):.4f} ms over "
          f"{sum(k[1] for k in mine):.0f} calls in the batch")
    if not mine:
        raise AssertionError(f"the profile shows no {kernel_key} launch")


def _lm_batch(cfg, lengths, seed: int = 0):
    """Seeded prompts of the given lengths, left-padded: (tokens, pads)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    P = max(lengths)
    toks = np.zeros((len(lengths), P), np.int64)
    for i, n in enumerate(lengths):
        toks[i, P - n:] = rng.integers(0, cfg.vocab_size, n)
    pads = torch.tensor([P - n for n in lengths])
    return torch.from_numpy(toks), pads


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _state_rel(got_pre, want_pre) -> float:
    return max(_rel(a["state"], b["state"]) for a, b in zip(got_pre,
                                                              want_pre))


def serve_lm(arch: str, kernel: str, lengths, serve_lengths,
             new_tokens: int = LM_NEW_TOKENS) -> dict:
    """The parity gates and the bf16 serving run of one LM (see the
    module docstring, phases 12-13); returns the serving run's launch
    counts."""
    import copy
    import gc
    import numpy as np
    import torch
    from repro_torch.arch import build_model
    from repro_torch.config import get_arch_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BatchServer, Request
    cfg = get_arch_config(arch)
    f32 = cfg.replace(dtype="float32")
    toks, pads = _lm_batch(cfg, lengths)
    # seeded decode tokens: the same feed whatever the logits say
    seeded = torch.randint(0, cfg.vocab_size, (len(lengths), 8),
                           generator=torch.Generator().manual_seed(1))

    # f32, full depth: the kernel path against the plain path on the card
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = build_model(f32, gen).requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"  {arch}: {f32.num_layers} layers, d {f32.d_model}, "
          f"{n_params / 1e9:.3f} B parameters, float32 "
          f"({4 * n_params / 1e9:.1f} GB), made on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    (got, got_pre, _), (want, want_pre, _) = _kernel_and_plain(
        model, kernel, toks, pads, seeded)
    err = _rel(got, want)
    print(f"  f32 full depth, kernel vs plain on the card: prefill + 8 "
          f"decode logits max diff {err:.3e} of max|logit| (limit "
          f"{LM_PARITY}); {f32.num_layers} {kernel} launches, 0 plain")
    if not torch.isfinite(got).all() or err > LM_PARITY:
        raise AssertionError(f"{arch}: kernel vs plain logits {err:.3e}")
    if cfg.rwkv is not None:
        s_err = _state_rel(got_pre, want_pre)
        print(f"  f32 full depth, kernel vs plain: prefill final states max "
              f"diff {s_err:.3e} of max|S| (limit {LM_PARITY})")
        if s_err > LM_PARITY:
            raise AssertionError(f"{arch}: final states differ by {s_err}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # f32, depth 2 at full width: the card against the CPU, decode fed
    # the seeded tokens, then the CPU's own argmax as the server feeds
    # (the card is fed the CPU's picks, so a near tie cannot part them)
    cfg2 = f32.replace(num_layers=2)
    cpu = build_model(cfg2, torch.Generator().manual_seed(1))
    card = copy.deepcopy(cpu).to(DEVICE)
    for feed_name, feed in (("seeded", seeded), ("argmax", None)):
        want, want_pre, fed = _lm_run(cpu, toks, pads, feed)
        got, got_pre, _ = _lm_run(card, toks, pads, fed)
        err = _rel(got, want)
        msg = (f"  f32 depth 2, card vs CPU, {feed_name} feed: logits max "
               f"diff {err:.3e} of max|logit| (limit {LM_CPU})")
        if feed is None:
            same = float((got[:, :-1].argmax(-1) == fed).float().mean())
            msg += (f"; the card's own argmax picks the CPU's token at "
                    f"{100 * same:.1f}% of {fed.numel()} steps")
        if cfg.rwkv is not None:
            s_err = _state_rel(got_pre, want_pre)
            msg += f"; final states {s_err:.3e} of max|S|"
            err = max(err, s_err)
        print(msg)
        if err > LM_CPU:
            raise AssertionError(f"{arch}: card vs CPU, {feed_name} feed, "
                                 f"differ by {err:.3e}")
    del cpu, card
    gc.collect()
    torch.cuda.empty_cache()

    # bf16, full width and depth: the serving run
    rng = np.random.default_rng(0)
    B = LM_BATCH
    server = BatchServer(arch, batch_size=B,
                         cache_len=max(serve_lengths) + new_tokens,
                         reduced=False, seed=0, device=DEVICE)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    new_tokens) for i, n in enumerate(serve_lengths)]
    server.run(reqs[:B])                  # warm-up batch, not counted
    server.stats = type(server.stats)()
    for r in reqs[:B]:
        r.out.clear()
    ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, len(reqs), B):
        server.run(reqs[i:i + B])
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    st = server.stats
    n_batches = (len(reqs) + B - 1) // B
    print(f"  bf16 serving, {len(reqs)} requests (prompts "
          f"{min(serve_lengths)}-{max(serve_lengths)}, mean "
          f"{np.mean(serve_lengths):.0f}), batch {B}, {new_tokens} new "
          f"tokens: prefill {st.prefill_tokens} tok in {st.prefill_s:.4f}s "
          f"= {st.prefill_tokens / st.prefill_s:.1f} tok/s; decode "
          f"{st.decode_tokens} tok in {st.decode_s:.4f}s = "
          f"{st.decode_tokens / st.decode_s:.1f} tok/s "
          f"({1e3 * st.decode_s / (n_batches * (new_tokens - 1)):.2f} ms "
          f"per decode round); wall {wall:.3f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    print(f"  launches: {kernel} {launches[kernel]} = "
          f"{launches[kernel] / n_batches:.0f} per prefill batch "
          f"({cfg.num_layers} layers)")
    if any(len(r.out) != new_tokens for r in reqs):
        raise AssertionError(f"{arch}: a request got the wrong token count")
    if launches[kernel] != cfg.num_layers * n_batches:
        raise AssertionError(f"{arch}: {launches[kernel]} {kernel} "
                             f"launches, expected one per layer per batch")

    # a trace of one batch short enough to profile: the first prompts,
    # 16 new tokens
    _profile_lm(server, [Request(r.rid, r.prompt, 16) for r in reqs[:B]],
                "flash_tc_kernel" if kernel == "flash_attention"
                else "wkv6_kernel")
    _prefill_repeat(server.model, toks, pads)

    # bf16: kernel against plain on one batch, reported only
    (got, _, _), (want, _, _) = _kernel_and_plain(server.model, kernel,
                                                  toks, pads, seeded)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"  bf16 kernel vs plain (reported, not gated): logits max diff "
          f"{_rel(got, want):.3e} of max|logit|; greedy tokens agree on "
          f"{100 * agree:.1f}% of {got.shape[0] * got.shape[1]} positions")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phases 7 and 8: training --------------------------------------------------


def _fit_job(job, steps: int, prefetch: bool = True,
             cuda_graphs: bool = True):
    """Make the job's trainer (``cuda_graphs=False``: every step eager)
    and fit ``steps`` steps, the first alone so its gradients can be
    read. Returns (trainer, views, losses, step-1 grads on the CPU,
    seconds of steps 2.. with the device drained)."""
    import torch
    from repro_torch import api
    trainer, views, *_ = api.make_trainer(job)
    if not cuda_graphs:
        trainer = _eager(trainer)
    losses = trainer.fit(views, steps=1, prefetch=prefetch)["losses"]
    grads = {k: p.grad.detach().cpu() for k, p in trainer.params.items()}
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += trainer.fit(views, steps=steps - 1,
                          prefetch=prefetch)["losses"]
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return trainer, views, losses, grads, time.perf_counter() - t0


# the port's Sum-stage kernel sources: a profiled CUDA kernel counts for
# the first whose name, with an underscore after it, is in its own
_FAMILIES = ("segment_sum_bwd", "segment_sum", "edge_softmax_bwd",
             "edge_softmax", "segment_max_bwd", "segment_max")


def _eager(trainer):
    """The same trainer (its model, graph, optimizer and staging) with
    every step eager: no CUDA graph."""
    from repro_torch.core.trainer import CompactTrainer
    return CompactTrainer(trainer.model, trainer.g, trainer.opt,
                          gcn_norm=trainer.stager.gcn_norm,
                          device=trainer.device, cuda_graphs=False)


def _profile(trainer, views, step_ms: float, steps: int = 5) -> float:
    """Device time per step by kernel over ``steps`` more steps, from a
    ``torch.profiler`` trace, and the device's busy share against the
    unprofiled step time ``step_ms``; returns the busy ms per step."""
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
    port = [k for k in kernels[6:] if any(
        name in k[2] for name in ("segment_sum", "edge_softmax",
                                  "segment_max"))]
    if port:
        print("    and the port's other Sum-stage kernels:")
    for ms, n, key in port:
        print(f"      {ms:.4f} ms/step over {n:.0f} calls  {key[:90]}")
    # each Sum-stage kernel's device ms a step, its launches (the rows or
    # chunks and the merge) summed
    fams = {}
    for ms, n, key in kernels:
        name = next((f for f in _FAMILIES if f"{f}_" in key), None)
        if name:
            t, c = fams.get(name, (0.0, 0.0))
            fams[name] = (t + ms, c + n)
    print("    Sum-stage kernels, device ms/step: " + ", ".join(
        f"{k} {t:.4f} ({c:.0f} CUDA launches)" for k, (t, c) in fams.items()))
    return busy


def _src_plan_s(trainer, views, steps: int):
    """Host seconds that building the source plans (the gather
    backward's, ROADMAP C.7) adds to staging the first ``steps`` views of
    a compact stream; None for the global stream, whose one plan is
    built once per graph."""
    from repro_torch.core.views import CompactView
    from repro_torch.kernels.plan import build_bucket_csc_plan
    total = 0.0
    for i in range(steps):
        view = views.build(i)
        if not isinstance(view, CompactView):
            return None
        n_pad, e_pad = trainer.stager._pick(view)
        t0 = time.perf_counter()
        build_bucket_csc_plan(view.src_local, n_pad, e_pad)
        total += time.perf_counter() - t0
    return total


def train(config: str, label: str, bwd_kernel: str, bwd_per_step: int,
          model_name=None) -> dict:
    """Train the config module's model (swapped for ``model_name`` when
    given) on the card under each strategy, hold it against the same job
    on the CPU, and return the launch counts of the card runs; the
    backward kernel must launch ``bwd_per_step`` times on every step.
    Then run 20 global steps twice on the card: the two runs must agree
    bit for bit."""
    import dataclasses
    import importlib
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import config_for, resolve_graph
    mod = importlib.import_module(f"repro_torch.configs.{config}")
    cfg, dataset = _config(config, model_name)
    g = resolve_graph(dataset, cfg.model, seed=0)
    if config_for(g, cfg.model, cfg.num_layers, cfg.hidden_dim) != cfg:
        raise AssertionError(f"{config}: the trained model is not CONFIG")
    total = {}
    for strategy, tcfg in mod.TRAIN.items():
        job = api.TrainJob(
            dataset=dataset, model=cfg.model, strategy=strategy,
            steps=TRAIN_STEPS, num_layers=cfg.num_layers,
            hidden=cfg.hidden_dim, lr=tcfg.lr,
            weight_decay=tcfg.weight_decay, seed=tcfg.seed, compact=True,
            halo_hops=tcfg.cluster_halo_hops, eval_every=0, device=DEVICE)
        ops.reset_launches()
        card, views, losses, grads, wall = _fit_job(job, TRAIN_STEPS)
        launches = dict(ops.launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        # the same job with inline staging (the parent's), next to the
        # card run and before the CPU job, whose threads would slow it:
        # fit's default builder threads share the GIL with the step's
        # launches, and a global stream is staged inline either way
        inl, _, inl_losses, _, inl_wall = _fit_job(
            dataclasses.replace(job, dataset=g), TRAIN_STEPS, prefetch=False)
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
        ti = inl.timing
        print(f"    inline staging: {(TRAIN_STEPS - 1) / inl_wall:.2f} "
              f"steps/s over steps 2-{TRAIN_STEPS} (builder threads "
              f"{(TRAIN_STEPS - 1) / wall:.2f}); host staging "
              f"{ti['stage_s']:.4f} s, device step {ti['step_s']:.4f} s; "
              f"losses {'bitwise equal' if inl_losses == losses else 'DIFFER'}")
        if inl_losses != losses:
            raise AssertionError(f"{strategy}: inline staging's losses "
                                 "differ from the builder threads'")
        src_s = _src_plan_s(card, views, TRAIN_STEPS)
        if src_s is not None:
            # the builder threads stage ahead: stage_s is the loop's
            # wait for a staged view, not the staging's own time
            print(f"    source plans (gather backward): {src_s:.4f} s to "
                  f"build for these views, beside the loop's "
                  f"{t['stage_s']:.4f} s wait for staged views")
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
        # every step runs the same layers, so launches on every step show
        # as exactly bwd_per_step * steps
        if launches[bwd_kernel] != bwd_per_step * TRAIN_STEPS:
            raise AssertionError(
                f"{strategy}: {launches[bwd_kernel]} {bwd_kernel} launches "
                f"in {TRAIN_STEPS} steps, expected {bwd_per_step} per step")

    # the same 20 global steps twice on the card, bit for bit
    job = api.TrainJob(dataset=dataset, model=cfg.model, steps=20,
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
    if not same:
        raise AssertionError(f"{cfg.model}: two identical training runs on "
                             "the card differ")
    return total


# -- phase 11: the fault-tolerant runtime ---------------------------------------


def _rt_run(job, steps: int = RUNTIME_STEPS, policy=None, injector=None,
            **fit_kw):
    """A fresh trainer for ``job`` (``api.make_trainer``; rebuilt around
    the same model with a runtime when an ``injector`` is given), fit
    ``steps`` steps over the job's own stream with ``fit_kw``. Returns
    (trainer, stream, fit's result, wall seconds with the device
    drained)."""
    import torch
    from repro_torch import api
    from repro_torch.core.trainer import CompactTrainer
    trainer, stream, *_ = api.make_trainer(job)
    if injector is not None:
        trainer = CompactTrainer(
            trainer.model, trainer.g, trainer.opt,
            gcn_norm=trainer.stager.gcn_norm, device=trainer.device,
            fault_policy=policy, injector=injector)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.fit(stream, steps=steps, **fit_kw)
    torch.cuda.synchronize()
    return trainer, stream, out, time.perf_counter() - t0


def _params(trainer) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in trainer.model.state_dict().items()}


def _bitwise(what: str, got, want) -> None:
    """Gate: losses and final parameters equal bit for bit."""
    (lg, pg), (lw, pw) = got, want
    same = lg == lw and pg.keys() == pw.keys() and all(
        bool((pg[k] == pw[k]).all()) for k in pw)
    print(f"    {what}: {len(lg)} losses and the final parameters "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}")
    if not same:
        raise AssertionError(f"{what}: not bitwise equal to the reference "
                             "run")


def runtime(label: str) -> dict:
    """Phase 11: the GAT-E and GCN mini cells under the fault-tolerant
    runtime, 30 steps each, at the configs' full widths on the card:
    inline staging, builder threads 1 and 3, sampler processes and the
    chaos run agree bit for bit; a 15 + 15 step checkpoint-resume split
    is the uninterrupted run; skip_view and rollback equal a run that
    never saw the poison view; a card checkpoint steps on the CPU within
    LOSS_TOL of the card's next loss. Then ``stage_s``, ``step_s`` and
    steps/s per staging mode for the mini and cluster cells. Returns the
    phase's launch counts."""
    import dataclasses
    import importlib
    import math
    import os
    import tempfile
    import numpy as np
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_gnn import resolve_graph
    from repro_torch.runtime import FaultInjector, FaultPolicy, procpool
    if not procpool.shared_memory_available():
        raise AssertionError("shared memory is unavailable: the sampler "
                             "processes cannot start")
    cores = os.cpu_count()
    workers = max(1, min(4, (cores or 2) - 1))
    print(f"  host: {cores} CPU cores, default prefetch workers {workers}")
    ops.reset_launches()
    for config, kernels in (
            ("gnn_gat_e_alipay", ("edge_softmax", "edge_softmax_bwd",
                                  "segment_sum")),
            ("gnn_gcn_reddit", ("segment_sum", "segment_sum_bwd"))):
        mod = importlib.import_module(f"repro_torch.configs.{config}")
        cfg, dataset = _config(config)
        g = resolve_graph(dataset, cfg.model, seed=0)

        def job(strategy, **kw):
            t = mod.TRAIN[strategy]
            return api.TrainJob(
                dataset=g, model=cfg.model, strategy=strategy,
                num_layers=cfg.num_layers, hidden=cfg.hidden_dim, lr=t.lr,
                weight_decay=t.weight_decay, seed=t.seed, compact=True,
                halo_hops=t.cluster_halo_hops, eval_every=0, device=DEVICE,
                **kw)

        before = dict(ops.launches)
        mini = job("mini")
        print(f"  [{label}, {cfg.model}, mini, {RUNTIME_STEPS} steps]")
        tr, _, out, _ = _rt_run(mini, prefetch=False)
        ref = (out["losses"], _params(tr))
        if not np.isfinite(ref[0]).all():
            raise AssertionError(f"{cfg.model}: bad losses {ref[0]}")
        for what, kw in (("thread workers 1", dict(prefetch_workers=1)),
                         ("thread workers 3", dict(prefetch_workers=3)),
                         ("process workers 2", dict(
                             prefetch_workers=2, prefetch_mode="process"))):
            tr, _, out, _ = _rt_run(mini, **kw)
            _bitwise(f"{what} vs inline", (out["losses"], _params(tr)), ref)
        inj = FaultInjector(CHAOS_PLAN, seed=0)
        with tempfile.TemporaryDirectory() as d:
            tr, _, out, _ = _rt_run(
                mini, policy=FaultPolicy(**FAST), injector=inj,
                prefetch_workers=3, prefetch_mode="process",
                checkpoint_dir=d, checkpoint_every=5)
        print(f"    chaos faults fired: {dict(inj.fired)}")
        if inj.total_fired() < 3:
            raise AssertionError(f"chaos: only {inj.fired} fired")
        _bitwise("chaos, process workers 3, checkpoint_every 5",
                 (out["losses"], _params(tr)), ref)

        half = RUNTIME_STEPS // 2
        with tempfile.TemporaryDirectory() as d:
            _rt_run(mini, steps=half, checkpoint_dir=d, checkpoint_every=5)
            tr, stream, out, _ = _rt_run(mini, steps=RUNTIME_STEPS - half,
                                         checkpoint_dir=d, resume=True)
            _bitwise(f"resume: steps {half + 1}-{RUNTIME_STEPS} after a "
                     f"{half}-step run", (out["losses"], _params(tr)),
                     (ref[0][half:], ref[1]))
            if stream.cursor != RUNTIME_STEPS:
                raise AssertionError(f"resume: the stream's cursor reads "
                                     f"{stream.cursor}")
            cpu, views, *_ = api.make_trainer(
                dataclasses.replace(mini, device="cpu"))
            cpu.restore(d)
            loss = cpu.fit(views, steps=1, prefetch=False)["losses"][0]
            err = abs(loss - ref[0][half]) / max(1.0, abs(ref[0][half]))
            print(f"    the card's step-{half} checkpoint on the CPU: step "
                  f"{half + 1} loss {loss:.6f}, card {ref[0][half]:.6f}, "
                  f"rel err {err:.3e} (tolerance {LOSS_TOL})")
            if not err <= LOSS_TOL:
                raise AssertionError(f"cross-device: {err:.3e}")

        clean, stream, *_ = api.make_trainer(mini)
        want = clean.fit(stream, steps=4, prefetch=False)["losses"]
        stream.seek(5)
        want += clean.fit(stream, steps=RUNTIME_STEPS - 5,
                          prefetch=False)["losses"]
        for action in ("skip_view", "rollback"):
            with tempfile.TemporaryDirectory() as d:
                tr, _, out, _ = _rt_run(
                    mini, policy=FaultPolicy(on_divergence=action, **FAST),
                    injector=FaultInjector({"diverge": {4}}),
                    checkpoint_dir=d, checkpoint_every=2)
            if (tr.step_num != RUNTIME_STEPS - 1
                    or not all(map(math.isfinite, out["losses"]))):
                raise AssertionError(f"{action}: ended at step "
                                     f"{tr.step_num}, losses {out['losses']}")
            _bitwise(f"{action}, diverge at view 4, ends at step "
                     f"{tr.step_num}, vs views 0-3 and 5-{RUNTIME_STEPS - 1}",
                     (out["losses"], _params(tr)), (want, _params(clean)))

        for strategy in ("mini", "cluster"):
            for mode, kw in (("inline", dict(prefetch=False)),
                             (f"thread x{workers}", {}),
                             (f"process x{workers}",
                              dict(prefetch_mode="process"))):
                tr, _, out, wall = _rt_run(job(strategy), **kw)
                t = tr.timing
                # the first view's wait holds a sampler pool's start (its
                # samplers import torch), other_s the fit's set-up and the
                # pool's close; the loop's rate counts neither
                loop = t["stage_s"] - t["first_stage_s"] + t["step_s"]
                row = {"config": config, "strategy": strategy,
                       "mode": mode, "steps": RUNTIME_STEPS,
                       "stage_s": t["stage_s"],
                       "first_stage_s": t["first_stage_s"],
                       "step_s": t["step_s"],
                       "other_s": wall - t["stage_s"] - t["step_s"],
                       "wall_s": wall, "steps_per_s": RUNTIME_STEPS / wall,
                       "loop_steps_per_s": RUNTIME_STEPS / loop,
                       "cores": cores, "card": label}
                print("    runtime row " + json.dumps(row))
        if procpool._DEGRADE_WARNED:
            raise AssertionError("process mode degraded to threads")
        for k in kernels:
            if ops.launches[k] - before.get(k, 0) <= 0:
                raise AssertionError(f"{cfg.model}: no {k} launches")
    return dict(ops.launches)


# -- phase 14: CUDA graphs per bucket ----------------------------------------------


GRAPH_PAIRS = 10          # threads against inline, alternating pairs
DENSE_REL = 1e-3          # dense vs compact losses, * max(1, |loss|)


def _graph_cells():
    """(config, model swap, strategy, compact) of every training cell the
    phase holds replay against eager in: the three models under the three
    strategies (mini and cluster compact), and dense mini and cluster for
    GAT-E and GCN."""
    cells = [(config, model, strategy, True)
             for config, model in (("gnn_gat_e_alipay", None),
                                   ("gnn_gcn_reddit", None),
                                   ("gnn_gcn_reddit", "sage_max"))
             for strategy in ("global", "mini", "cluster")]
    cells += [(config, None, strategy, False)
              for config in ("gnn_gat_e_alipay", "gnn_gcn_reddit")
              for strategy in ("mini", "cluster")]
    return cells


def _timed_fit(trainer, views, steps: int, **fit_kw):
    """``reset()`` the trainer, move the stream to view 0 and fit
    ``steps`` steps with the device drained on both sides: the same
    trajectory as the trainer's first fit, over buckets it has seen.
    Returns (losses, wall seconds)."""
    import torch
    trainer.reset()
    views.seek(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.fit(views, steps=steps, **fit_kw)["losses"]
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def _graph_train(label: str) -> dict:
    """Replay against eager in every training cell: 30 steps each way,
    losses, final parameters and step-1 gradients bitwise equal, one
    capture per touched bucket; then steady steps/s, eager against
    replay in alternating order, and the busy share under replay. The
    dense cells also against the CPU and against the compact cell on the
    same stream indices. Returns the compact cells' replay losses."""
    import dataclasses
    import importlib
    import numpy as np
    from repro_torch import api
    from repro_torch.launch.serve_gnn import resolve_graph
    graphs, compact_losses = {}, {}
    for i, (config, model_name, strategy, compact) in enumerate(
            _graph_cells()):
        mod = importlib.import_module(f"repro_torch.configs.{config}")
        cfg, dataset = _config(config, model_name)
        if (dataset, cfg.model) not in graphs:
            graphs[(dataset, cfg.model)] = resolve_graph(dataset, cfg.model,
                                                         seed=0)
        g = graphs[(dataset, cfg.model)]
        t = mod.TRAIN[strategy]
        job = api.TrainJob(
            dataset=g, model=cfg.model, strategy=strategy,
            num_layers=cfg.num_layers, hidden=cfg.hidden_dim, lr=t.lr,
            weight_decay=t.weight_decay, seed=t.seed, compact=compact,
            halo_hops=t.cluster_halo_hops, eval_every=0, device=DEVICE)
        name = f"{cfg.model} {strategy}" + ("" if compact else " dense")
        order = (False, True) if i % 2 == 0 else (True, False)
        runs = {}
        for graphs_on in order:
            runs[graphs_on] = _fit_job(job, TRAIN_STEPS,
                                       cuda_graphs=graphs_on)
        (eager, ev, el, eg, ewall), (rep, rv, rl, rg, rwall) = (
            runs[False], runs[True])
        same = (el == rl and all(torch_equal(eg[k], rg[k]) for k in eg)
                and _params(eager).keys() == _params(rep).keys()
                and all(torch_equal(a, b) for a, b in zip(
                    _params(eager).values(), _params(rep).values())))
        if not np.isfinite(rl).all():
            raise AssertionError(f"{name}: bad losses {rl}")
        rep.assert_compiled_per_bucket()
        touched = {k: 1 for k in rep.buckets_touched}
        if rep.captures != touched:
            raise AssertionError(f"{name}: captures {rep.captures}, "
                                 f"buckets touched {sorted(touched)}")
        print(f"  [{label}] {name}: {TRAIN_STEPS} steps eager and under "
              f"replay: losses, step-1 gradients and final parameters "
              f"{'bitwise equal' if same else 'DIFFER'}; captures "
              f"{dict(rep.captures)} = one per touched bucket")
        if not same:
            raise AssertionError(f"{name}: replay differs from eager")
        # steady state: every bucket captured, the same views again
        wall = {}
        for graphs_on in order:
            tr, views = (rep, rv) if graphs_on else (eager, ev)
            losses, wall[graphs_on] = _timed_fit(tr, views, TRAIN_STEPS)
            if losses != rl:
                raise AssertionError(f"{name}: a refit after reset() "
                                     f"differs (graphs={graphs_on})")
        if rep.captures != touched:
            raise AssertionError(f"{name}: the refit captured again "
                                 f"({rep.captures})")
        rv.seek(0)
        busy = _profile(rep, rv, 1e3 * wall[True] / TRAIN_STEPS)
        row = {"cell": name, "config": config, "steps": TRAIN_STEPS,
               "buckets": len(touched),
               "steps_per_s_eager": TRAIN_STEPS / wall[False],
               "steps_per_s_replay": TRAIN_STEPS / wall[True],
               "first_fit_steps_per_s_eager": (TRAIN_STEPS - 1) / ewall,
               "first_fit_steps_per_s_replay": (TRAIN_STEPS - 1) / rwall,
               "busy_ms_per_step_replay": busy,
               "busy_share_replay": busy * TRAIN_STEPS / (1e3 * wall[True]),
               "order": "eager first" if not order[0] else "replay first",
               "card": label}
        print("    graphs row " + json.dumps(row))
        if compact:
            compact_losses[(config, model_name, strategy)] = rl
            continue
        # the dense view on the card against the CPU, and against the
        # compact view of the same stream index
        _, _, want, want_grads, _ = _fit_job(
            dataclasses.replace(job, device="cpu"), TRAIN_STEPS)
        g_err = max(float((rg[k] - want_grads[k]).abs().max())
                    / max(float(want_grads[k].abs().max()), 1e-30)
                    for k in want_grads)
        l_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(rl, want))
        ref = compact_losses[(config, model_name, strategy)]
        d_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(rl, ref))
        print(f"    dense card vs CPU: step-1 gradients max rel err "
              f"{g_err:.3e} (tolerance {GRAD_TOL}), losses max rel err "
              f"{l_err:.3e} (tolerance {LOSS_TOL}); dense vs compact on "
              f"the same views: losses max rel err {d_err:.3e} (tolerance "
              f"{DENSE_REL}); loss {rl[0]:.5f} -> {rl[-1]:.5f}")
        if g_err > GRAD_TOL or l_err > LOSS_TOL:
            raise AssertionError(f"{name}: card vs CPU {g_err:.3e} / "
                                 f"{l_err:.3e}")
        if d_err > DENSE_REL:
            raise AssertionError(f"{name}: dense vs compact {d_err:.3e}")
    return compact_losses


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and bool(torch.equal(a, b))


def _graph_pairs(label: str) -> None:
    """Builder threads against inline staging under replay, in
    ``GRAPH_PAIRS`` alternating pairs on the GAT-E and GCN mini cells:
    one trainer per cell (its buckets captured once), every fit from
    ``reset()`` over the same views; every fit's losses bitwise equal."""
    import importlib
    from repro_torch import api
    from repro_torch.launch.serve_gnn import resolve_graph
    for config in ("gnn_gat_e_alipay", "gnn_gcn_reddit"):
        mod = importlib.import_module(f"repro_torch.configs.{config}")
        cfg, dataset = _config(config)
        t = mod.TRAIN["mini"]
        job = api.TrainJob(
            dataset=resolve_graph(dataset, cfg.model, seed=0),
            model=cfg.model, strategy="mini", num_layers=cfg.num_layers,
            hidden=cfg.hidden_dim, lr=t.lr, weight_decay=t.weight_decay,
            seed=t.seed, compact=True, eval_every=0, device=DEVICE)
        trainer, views, *_ = api.make_trainer(job)
        ref = trainer.fit(views, steps=TRAIN_STEPS)["losses"]  # captures
        rates = {"threads": [], "inline": []}
        for pair in range(GRAPH_PAIRS):
            modes = (("threads", {}), ("inline", dict(prefetch=False)))
            for mode, kw in (modes if pair % 2 == 0 else modes[::-1]):
                losses, wall = _timed_fit(trainer, views, TRAIN_STEPS, **kw)
                if losses != ref:
                    raise AssertionError(f"{cfg.model} mini, {mode}: "
                                         "losses differ")
                rates[mode].append(TRAIN_STEPS / wall)
        trainer.assert_compiled_per_bucket()
        med = {m: float(sorted(r)[len(r) // 2]) for m, r in rates.items()}
        row = {"cell": f"{cfg.model} mini", "pairs": GRAPH_PAIRS,
               "steps": TRAIN_STEPS, "threads_steps_per_s": rates["threads"],
               "inline_steps_per_s": rates["inline"], "median": med,
               "threads_over_inline": med["threads"] / med["inline"],
               "card": label}
        print(f"  [{label}] {cfg.model} mini under replay, {GRAPH_PAIRS} "
              f"alternating pairs, losses bitwise equal in all: builder "
              f"threads {med['threads']:.2f} steps/s, inline "
              f"{med['inline']:.2f} (medians)")
        print("    pairs row " + json.dumps(row))


def _graph_serve(label: str, requests: int = 512) -> None:
    """Served responses under replay bitwise equal to eager (the same
    fixed batches through ``submit``), a cache hit bitwise a recompute,
    one capture per bucket; then QPS and p50/p99 eager against replay
    over 4 clients, in alternating order, each server after an untimed
    pass of the trace (its buckets captured) with its cache aged out."""
    import numpy as np
    from repro_torch.launch.serve_gnn import (build_server, request_trace,
                                              resolve_graph, run_clients)
    from repro_torch.serving.server import ServeStats
    kw = dict(max_batch=16, max_wait_ms=2.0)
    for i, (config, model_name) in enumerate((
            ("gnn_gat_e_alipay", None), ("gnn_gcn_reddit", None),
            ("gnn_gcn_reddit", "sage_max"))):
        cfg, dataset = _config(config, model_name)
        model, hidden, layers = cfg.model, cfg.hidden_dim, cfg.num_layers
        g = resolve_graph(dataset, model, seed=0)
        trace = request_trace(g, requests, seed=0)
        out, srv = {}, {}
        for graphs_on in (False, True):
            srv[graphs_on] = build_server(g, model, layers, hidden, seed=0,
                                          device=DEVICE,
                                          cuda_graphs=graphs_on, **kw)
            out[graphs_on] = np.concatenate([
                srv[graphs_on].submit(trace[j:j + 16])
                for j in range(0, requests, 16)])
            srv[graphs_on].assert_compiled_per_bucket()
        same = bool(np.array_equal(out[False], out[True]))
        tr = srv[True].server_stats()["trace"]
        print(f"  [{label}] serve {model}: {requests} responses in batches "
              f"of 16, replay vs eager {'bitwise equal' if same else 'DIFFER'}"
              f"; captures full {sum(tr['full']['captures'].values())} over "
              f"{len(tr['full']['buckets'])} buckets, hit "
              f"{sum(tr['hit']['captures'].values())} over "
              f"{len(tr['hit']['buckets'])}")
        if not same:
            raise AssertionError(f"{model}: served replay differs from eager")
        # a cache hit against a full recompute, under replay
        rng = np.random.default_rng(1)
        indeg = np.bincount(g.dst, minlength=g.num_nodes)
        targets = np.union1d(rng.choice(g.num_nodes, 16, replace=False),
                             [int(indeg.argmax())])
        cached = build_server(g, model, layers, hidden, seed=0,
                              device=DEVICE, **kw)
        full = cached.submit(targets)
        hits0 = cached.cache.hits
        again = cached.submit(targets)
        if cached.cache.hits == hits0 or not np.array_equal(again, full):
            raise AssertionError(f"{model}: under replay a cache hit is not "
                                 "bitwise a full recompute")
        cached.assert_compiled_per_bucket()
        print(f"    cache hit vs full recompute under replay "
              f"({len(targets)} targets): bitwise equal")
        order = (False, True) if i % 2 == 0 else (True, False)
        for graphs_on in order:
            s = srv[graphs_on]
            s.start()
            try:
                run_clients(s, trace, 4)      # untimed: the last captures
                s.cache.advance()             # every entry stale again
                s.stats = ServeStats()
                before = _captures(s)
                _, wall = run_clients(s, trace, 4)
                late = _captures(s) - before
            finally:
                s.stop()
            s.assert_compiled_per_bucket()
            lat = s.server_stats()["latency_ms"]
            # a bucket first touched in the timed run is captured there
            row = {"model": model, "mode": "replay" if graphs_on else
                   "eager", "requests": requests, "qps": requests / wall,
                   "p50_ms": lat["p50"], "p99_ms": lat["p99"],
                   "captures_in_timed_run": late, "card": label}
            print("    serve row " + json.dumps(row))


def _captures(server) -> int:
    trace = server.server_stats()["trace"]
    return sum(sum(trace[p]["captures"].values()) for p in ("full", "hit"))


def graph_phase(label: str) -> dict:
    """Phase 14: CUDA graphs per bucket against eager, training and
    serving; returns the phase's launch counts."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    _graph_train(label)
    _graph_serve(label)
    _graph_pairs(label)
    return dict(ops.launches)


# -- phase 15: the distributed engine ---------------------------------------

ENGINE_P = 4                  # partitions, all on the one card (LocalComm)
ENGINE_STEPS = 30             # steps per strategy
ENGINE_TOL = 1e-4             # card vs CPU step 1; engine vs one block
ENGINE_TIMING_NODES = 200_000  # alipay_like nodes for the timing row
ENGINE_KERNELS = ("segment_sum", "segment_sum_bwd", "segment_max",
                  "segment_max_bwd")
# the engine's chaos scenarios on the card: every injection point alone,
# the combined plan, a sampler process killed, and both divergence
# recoveries
ENGINE_CHAOS = ("view_build", "device_put", "step", "checkpoint_save",
                "worker_kill")


def _engine_job(config: str, strategy: str, g, model=None, P=ENGINE_P,
                device=DEVICE):
    """The config's job under ``strategy`` on the engine over ``P``
    partitions (``1d_src``), compact mini and cluster views, the config's
    global rate for every strategy (one optimizer runs them all)."""
    import importlib
    from repro_torch import api
    mod = importlib.import_module(f"repro_torch.configs.{config}")
    cfg, _ = _config(config, model)
    t, glob = mod.TRAIN[strategy], mod.TRAIN["global"]
    return api.TrainJob(
        dataset=g, model=cfg.model, strategy=strategy,
        num_layers=cfg.num_layers, hidden=cfg.hidden_dim, lr=glob.lr,
        weight_decay=glob.weight_decay, seed=glob.seed, compact=True,
        halo_hops=t.cluster_halo_hops, eval_every=0, device=device,
        engine_partitions=P)


def _engine_trainer(job, cuda_graphs: bool = True):
    """``api.make_trainer(job)``: the engine Trainer and the job's views;
    ``cuda_graphs=False`` rebuilds it around the same engine eager."""
    from repro_torch import api
    from repro_torch.core.trainer import Trainer
    trainer, views, *_ = api.make_trainer(job)
    if not cuda_graphs:
        trainer = Trainer(trainer.engine, trainer.opt, cuda_graphs=False)
    return trainer, views


def _engine_streams(job, strategies):
    """The job's view stream under each strategy (the facade's choices)."""
    import dataclasses
    from repro_torch import api
    return [api._build(dataclasses.replace(job, strategy=s))[3]
            for s in strategies]


@contextlib.contextmanager
def _no_plain_versions():
    """Count calls of the kernels' plain versions through the wrappers;
    the block fails if there is any."""
    from repro_torch.kernels import ops
    names = [n for n in dir(ops) if n.endswith("_ref")]
    calls = {}

    def wrap(name, fn):
        def counted(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return counted

    saved = {n: getattr(ops, n) for n in names}
    for n, fn in saved.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    if calls:
        raise AssertionError(f"the engine path called plain versions: "
                             f"{calls}")


def _exchange_widths(trainer, view) -> int:
    """Floats per halo value that cross the exchange in one eager step
    (forward and backward), counted on the engine's communicator."""
    import torch
    comm = trainer.engine.comm
    seen = [0]

    class Count(torch.autograd.Function):
        @staticmethod
        def forward(ctx, buf):
            seen[0] += buf.shape[-1]
            return buf.view_as(buf)

        @staticmethod
        def backward(ctx, g):
            seen[0] += g.shape[-1]
            return g

    orig = comm.all_to_all
    comm.all_to_all = lambda buf: orig(Count.apply(buf))
    try:
        trainer.engine.make_loss_and_grad()(view)
    finally:
        del comm.all_to_all
    return seen[0]


def _step1(engine, view) -> tuple:
    """(loss, gradients on the CPU) of the engine's first step over
    ``view``: nothing is updated."""
    from repro_torch.core.strategies import shard_view
    loss, grads = engine.make_loss_and_grad()(
        engine.stage_view(shard_view(engine.plan, view)))
    return float(loss), {k: v.detach().cpu().clone()
                         for k, v in grads.items()}


def _rel_grads(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def _engine_checks(name: str, job, g, view) -> None:
    """Step 1 of the card engine against the CPU engine (the kernels'
    plain versions), and its loss against one block's (the card
    CompactTrainer's) on the same view."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core.mpgnn import loss_block
    card, _ = _engine_trainer(job, cuda_graphs=False)
    cpu, _ = _engine_trainer(dataclasses.replace(job, device="cpu"),
                             cuda_graphs=False)
    loss, grads = _step1(card.engine, view)
    want, want_grads = _step1(cpu.engine, view)
    g_err = _rel_grads(grads, want_grads)
    l_err = abs(loss - want) / max(1.0, abs(want))
    block_tr, *_ = api.make_trainer(dataclasses.replace(
        job, engine_partitions=0, strategy="global"))
    with torch.no_grad():
        one = float(loss_block(block_tr.model, block_tr._prepare(view)))
    b_err = abs(loss - one) / max(1.0, abs(one))
    print(f"    {name}: card vs CPU step 1: loss rel err {l_err:.3e}, "
          f"gradients max rel err {g_err:.3e}; P={job.engine_partitions} "
          f"engine vs one block on the card: loss {loss:.6f} vs "
          f"{one:.6f}, rel err {b_err:.3e} (tolerance {ENGINE_TOL})")
    if max(g_err, l_err, b_err) > ENGINE_TOL:
        raise AssertionError(f"{name}: engine parity {g_err:.3e} / "
                             f"{l_err:.3e} / {b_err:.3e}")


def _engine_fit(job, streams, cuda_graphs: bool):
    """A fresh engine Trainer fit ``ENGINE_STEPS`` steps over each stream
    in turn, with no restart. Returns (trainer, losses, final
    parameters, wall seconds per stream with the device drained)."""
    import torch
    trainer, _ = _engine_trainer(job, cuda_graphs)
    losses, walls = [], []
    for st in streams:
        st.seek(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += trainer.fit(st, steps=ENGINE_STEPS)["losses"]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return trainer, losses, _params(trainer), walls


def _steady(trainer, streams) -> list:
    """Seconds of ``ENGINE_STEPS`` more steps over each stream, on a
    trainer whose step is already captured (or eager), device drained."""
    import torch
    walls = []
    for st in streams:
        st.seek(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(st, steps=ENGINE_STEPS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _engine_run(name: str, job, g, strategies, label: str, kernels,
                repeat: bool = False) -> dict:
    """One phase-15 run: the card engine's checks, then a replay fit and
    an eager fit over the strategies' streams (bitwise equal, one
    capture, each of ``kernels`` launched), a second replay fit when
    ``repeat`` (bitwise equal), steady steps/s eager and under replay,
    the exchange volume, the busy share under replay and the launches by
    kernel. Returns the replay fit's launch counts."""
    import numpy as np
    from repro_torch.core.partition import build_partitions, partition_stats
    from repro_torch.core.strategies import shard_view
    from repro_torch.kernels import ops
    streams = _engine_streams(job, strategies)
    _engine_checks(name, job, g, streams[0].build(0))
    ops.reset_launches()
    with _no_plain_versions():
        rep, rl, rp, rwall = _engine_fit(job, streams, cuda_graphs=True)
    got = dict(ops.launches)
    rep.assert_compiled_once()
    if rep.trace_counts["train_step"] != 1:
        raise AssertionError(f"{name}: {rep.trace_counts} captures")
    missing = [k for k in kernels if got[k] <= 0]
    if missing or not np.isfinite(rl).all():
        raise AssertionError(f"{name}: kernels {missing} not launched, or "
                             f"bad losses {rl}")
    eager, el, ep, ewall = _engine_fit(job, streams, cuda_graphs=False)
    _bitwise(f"{name}: replay vs eager over {'/'.join(strategies)}",
             (rl, rp), (el, ep))
    print(f"    {name}: one engine Trainer over {' -> '.join(strategies)}: "
          f"captures {rep.trace_counts} (the step captured once); loss "
          f"{rl[0]:.5f} -> {rl[-1]:.5f}")
    if repeat:
        _, l2, p2, _ = _engine_fit(job, streams, cuda_graphs=True)
        _bitwise(f"{name}: two card fits", (l2, p2), (rl, rp))
    t0 = time.perf_counter()
    sg = build_partitions(g, job.engine_partitions,
                          method=job.partition_method,
                          gcn_norm=job.model == "gcn")
    part_s = time.perf_counter() - t0
    stats = partition_stats(sg)
    view0 = streams[0].build(0)
    widths = _exchange_widths(eager, eager.engine.stage_view(
        shard_view(eager.plan, view0)))
    steps = ENGINE_STEPS * len(strategies)
    per_step = {k: v / steps for k, v in got.items() if v}
    # steady state: the step captured, the same views again
    swall = {True: _steady(rep, streams), False: _steady(eager, streams)}
    streams[0].seek(0)
    busy = _profile(rep, streams[0], 1e3 * swall[True][0] / ENGINE_STEPS)
    row = {"run": name, "P": job.engine_partitions, "card": label,
           "shared_card": True, "network_time": "not measured",
           "strategies": list(strategies),
           "steps_per_s_eager": [ENGINE_STEPS / w for w in swall[False]],
           "steps_per_s_replay": [ENGINE_STEPS / w for w in swall[True]],
           "first_fit_steps_per_s_eager": [ENGINE_STEPS / w for w in ewall],
           "first_fit_steps_per_s_replay": [ENGINE_STEPS / w
                                            for w in rwall],
           "busy_ms_per_step_replay": busy,
           "busy_share_replay": busy * ENGINE_STEPS
           / (1e3 * swall[True][0]),
           "launches_per_step": per_step,
           "halo_values_per_sync": stats["halo_values_per_sync"],
           "floats_per_value_per_step": widths,
           "bytes_exchanged_per_step":
               4 * stats["halo_values_per_sync"] * widths,
           "replica_factor": stats["replica_factor"],
           "edge_balance": stats["edge_balance"],
           "build_partitions_s": part_s}
    print("    engine row " + json.dumps(row), flush=True)
    return got


def _engine_chaos(label: str) -> None:
    """The engine's chaos scenarios on the card, each bitwise its clean
    run and each re-certifying the one capture."""
    from repro_torch.runtime import chaos
    names = []
    for point in ENGINE_CHAOS:
        occ = {1} if point == "worker_kill" else {0, 2}
        names.append((f"{point}/engine", lambda p=point, o=occ:
                      chaos.run_scenario(f"{p}/engine", {p: o}, "engine",
                                         device=DEVICE)))
    names.append(("combined/engine", lambda: chaos.run_scenario(
        "combined/engine", chaos.SMOKE_PLAN, "engine", device=DEVICE)))
    names.append(("proc_kill/process/engine", lambda: chaos.run_scenario(
        "proc_kill/process/engine", {"proc_kill": {1}}, "engine",
        mode="process", device=DEVICE)))
    for action in ("skip_view", "rollback"):
        names.append((f"diverge/{action}/engine", lambda a=action:
                      chaos.run_divergence(f"diverge/{a}/engine", a,
                                           "engine", device=DEVICE)))
    failed = [n for n, run in names if not run()]
    print(f"    [{label}] engine chaos: {len(names) - len(failed)}/"
          f"{len(names)} scenarios bitwise equal to their clean runs")
    if failed:
        raise AssertionError(f"engine chaos scenarios failed: {failed}")


def _engine_max_pair(g, gen) -> dict:
    """``segment_max`` and ``segment_max_bwd`` at width 4 (GAT-E's
    logits, the softmax's max pass on the engine path) on shard 0's
    destination plan: exactly their plain versions, over ties and masked
    (NEG) entries; timed beside them with their bounds."""
    import torch
    from repro_torch.core.partition import build_partitions
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import NEG, segment_max_bwd_ref
    plan = build_partitions(g, ENGINE_P).plan.csc_plans()[0].to(DEVICE)
    E, N, D = plan.num_edges, plan.num_segments, 4
    data = torch.randint(0, 8, (E, D), generator=gen, device="cpu")
    data = data.float().to(DEVICE)
    masked = torch.rand((E, 1), generator=gen).to(DEVICE) < 0.1
    data = torch.where(masked, torch.full_like(data, NEG), data)
    rows = {"segment_max": _max_row(plan, data)}
    fwd = ops.segment_max_op(data, plan)
    cot = torch.randn((N, D), generator=gen).to(DEVICE)
    torch.testing.assert_close(
        ops.segment_max_bwd_op(cot, fwd, data, plan),
        segment_max_bwd_ref(cot, fwd, data, plan.edge_dst), rtol=0, atol=0)
    ms = _time_ms(lambda: ops.segment_max_bwd_op(cot, fwd, data, plan))
    plain = _time_ms(lambda: segment_max_bwd_ref(cot, fwd, data,
                                                 plan.edge_dst), 100.0)
    bound, by = _bound(4 * (2 * E * D + 2 * N * D) + 4 * E, 2 * E * D)
    rows["segment_max_bwd"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                   bound_by=by, library_ms=None,
                                   shape=f"E={E} N={N} D={D}")
    for k, row in rows.items():
        _plan_row(k, f"alipay_like {g.num_nodes} nodes, shard 0 of "
                  f"{ENGINE_P}, width 4 (exact)", row)
    return rows


def _gather_rows(g) -> None:
    """Where the engine's device step goes: its gathers are
    ``index_select`` over the node axis (``core/aggregate.py:take``).
    Times it beside advanced indexing (the same rows, the same bits) at
    the 200k graph's edge count and the widths GAT-E gathers (1, 4, 32),
    with the bytes bound; one JSON ``gather row`` each. Diagnostic: the
    port calls ``index_select``."""
    import torch
    gen = torch.Generator().manual_seed(1)
    idx = torch.from_numpy(g.dst).to(DEVICE)
    for width in (1, 4, 32):
        shape = (g.num_nodes,) + ((width,) if width > 1 else ())
        v = torch.randn(shape, generator=gen).to(DEVICE)
        if not torch.equal(v.index_select(0, idx), v[idx]):
            raise AssertionError("index_select and v[idx] differ")
        sel = _time_ms(lambda: v.index_select(0, idx))
        adv = _time_ms(lambda: v[idx])
        bound, by = _bound(4 * (len(idx) * (width + 1) + v.numel()), 0)
        print("  gather row " + json.dumps({
            "rows": len(idx), "table_rows": g.num_nodes, "width": width,
            "index_select_ms": sel, "advanced_index_ms": adv,
            "bound_ms": bound, "bound_by": by}), flush=True)


def engine_phase(label: str) -> dict:
    """Phase 15: the distributed engine on the card (all ``ENGINE_P``
    partitions on the one card, so no network time is measured). Returns
    the launch counts of its main-path runs (the replayed fits)."""
    import torch
    from repro_torch.launch.serve_gnn import resolve_graph
    from repro_torch.graph import make_dataset
    gen = torch.Generator().manual_seed(0)
    counts = {k: 0 for k in KERNELS}

    def add(got):
        for k in counts:
            counts[k] += got.get(k, 0)

    ga = resolve_graph("alipay_like", "gat_e", seed=0)
    _engine_max_pair(ga, gen)
    print("  GAT-E (alipay_like, 20,000 nodes), P=4, global -> mini -> "
          "cluster in one Trainer:")
    add(_engine_run("gat_e", _engine_job("gnn_gat_e_alipay", "global", ga),
                    ga, ("global", "mini", "cluster"), label, ENGINE_KERNELS,
                    repeat=True))
    # GCN's Sum stage and gathers are sums; SAGE-max's Sum stage is the
    # max pair, its gathers' backward a sum
    for model, kernels in (("gcn", ("segment_sum", "segment_sum_bwd")),
                           ("sage_max", ("segment_max", "segment_max_bwd",
                                         "segment_sum"))):
        g = resolve_graph("reddit_like", model, seed=0)
        print(f"  {model} (reddit_like), P=4, global:")
        add(_engine_run(model, _engine_job("gnn_gcn_reddit", "global", g,
                                           model=model), g, ("global",),
                        label, kernels))
    _engine_chaos(label)
    gt = make_dataset("alipay_like", seed=0, num_nodes=ENGINE_TIMING_NODES)
    _gather_rows(gt)
    for P in (1, ENGINE_P):
        print(f"  timing: GAT-E global, alipay_like "
              f"{ENGINE_TIMING_NODES} nodes, P={P}:")
        add(_engine_run(f"gat_e {ENGINE_TIMING_NODES // 1000}k P={P}",
                        _engine_job("gnn_gat_e_alipay", "global", gt, P=P),
                        gt, ("global",), label, ENGINE_KERNELS))
    return counts


def lm_phases(phase) -> list:
    """Phases 12 and 13; returns each serving run's launch counts."""
    import numpy as np
    rng = np.random.default_rng(0)
    lo, hi = LM_PROMPTS
    phase("12. serve Qwen3-4B (full width, 36 layers)")
    got = [serve_lm("qwen3-4b", "flash_attention", (512, 301, 77, 160),
                    [int(n) for n in rng.integers(lo, hi + 1,
                                                  LM_REQUESTS)])]
    phase("13. serve RWKV-6 1.6B (full width, 24 layers)")
    # whole chunks of 128, so every padded batch length is one too
    got.append(serve_lm("rwkv6-1.6b", "wkv6", (512, 384, 128, 256),
                        [int(n) for n in rng.choice(
                            np.arange(lo, hi + 1, 128), LM_REQUESTS)]))
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only",
                    choices=["kernels", "gnn-times", "lm-times", "lm",
                             "runtime", "graphs", "engine"],
                    default=None,
                    help="kernels: stop after phase 3 (build and check the "
                    "kernels); gnn-times: phases 1-3 and the GNN kernels' "
                    "times; lm-times: phases 1-3 and the LM kernels' "
                    "times; lm: those and phases 12-13; runtime: phases "
                    "1-2 and 11; graphs: phases 1-2 and 14; engine: "
                    "phases 1-2 and 15")
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

    if args.only == "runtime":
        phase("11. the fault-tolerant runtime (GAT-E, GCN)")
        runtime(label)
        return 0
    if args.only == "graphs":
        phase("14. CUDA graphs per bucket against eager")
        graph_phase(label)
        return 0
    if args.only == "engine":
        phase("15. the distributed engine (P=4 on one card)")
        engine_phase(label)
        return 0

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

    if args.only == "gnn-times":
        phase("6. kernel times (GNN)")
        kernel_times()
        return 0
    if args.only in ("lm-times", "lm"):
        phase("6. kernel times (LM zoo)")
        lm_kernel_times()
        if args.only == "lm":
            lm_phases(phase)
        return 0

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
    rows.update(lm_kernel_times())

    phase("7. train GAT-E (alipay_like)")
    count(train("gnn_gat_e_alipay", label, "edge_softmax_bwd", 2))

    phase("8. train GCN (reddit_like + self-loops)")
    count(train("gnn_gcn_reddit", label, "segment_sum_bwd", 2))

    phase("9. serve SAGE-max (reddit_like)")
    got = serve("gnn_gcn_reddit", label, requests, model_name="sage_max")
    if got["segment_max"] <= 0:
        raise AssertionError("SAGE-max serving launched no segment_max "
                             "kernel")
    print(f"  {got['segment_max'] / requests:.3f} segment_max launches per "
          "served request")
    count(got)

    phase("10. train SAGE-max (reddit_like)")
    # layer 0 pools the raw features, which take no gradient: two forward
    # launches and one backward launch per step
    got = train("gnn_gcn_reddit", label, "segment_max_bwd", 1,
                model_name="sage_max")
    if got["segment_max"] != 2 * 3 * TRAIN_STEPS:
        raise AssertionError(f"SAGE-max training: {got['segment_max']} "
                             "segment_max launches, expected 2 per step")
    count(got)

    phase("11. the fault-tolerant runtime (GAT-E, GCN)")
    count(runtime(label))

    phase("14. CUDA graphs per bucket against eager")
    count(graph_phase(label))

    phase("15. the distributed engine (P=4 on one card)")
    count(engine_phase(label))

    for got in lm_phases(phase):
        count(got)
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
