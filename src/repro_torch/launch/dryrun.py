"""Multi-card dry-run: plan every (arch x input-shape x mesh) combination
on the H100 production mesh, without a card, and report a card's memory
and the step's roofline terms (the counterpart of
``repro/launch/dryrun.py``).

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
        --shape train_4k --mesh single --out results/
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles its step for 512 placeholder devices
and reads XLA's memory and cost analyses and HLO. Here the port's own
step (the loss, its gradients and the AdamW update with float32 moments;
``prefill``; or ``decode_step``) is traced at full size on fake tensors
(:mod:`repro_torch.launch.faketrace`), every layer unrolled, and a card's
share is reckoned from the sharding rules
(:mod:`repro_torch.launch.sharding`) and the activation hints
(:mod:`repro_torch.arch.hints`):

- held: the parameters, and for training their gradients and the AdamW
  moments in float32, for decode the caches, and the inputs, each leaf
  over the shards its spec cuts it into;
- plus the traced peak of what the step allocates, the activations over
  the activation shard factor (the shards of the residual stream's
  hint: |dp| x |model| where the hints shard the sequence, |dp| with
  ``--no-seq-shard``, less where the mesh does not divide a dim) and
  the gradients at their parameters' shares;
- plus the largest layer's gathered weights (the bytes a card does not
  hold of its largest block, or of the embedding or LM head).

``run_one`` also takes any shape-only mesh (:class:`~repro_torch.launch.
mesh.ShapeMesh`), config and input shape: at mesh (1, 1) its numbers
are what one card holds and allocates, which ``chip_smoke.py`` checks on
an H100.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.arch.hints import resolve, use_hints
from repro_torch.config import (ASSIGNED_ARCHS, INPUT_SHAPES, ArchConfig,
                                InputShape, get_arch_config)
from repro_torch.launch import sharding as sh
from repro_torch.launch.faketrace import fake_model, trace, train_step
from repro_torch.launch.mesh import (ExpertMesh, data_axes,
                                     make_production_mesh)
from repro_torch.launch.roofline import (RecordingComm, collective_bytes,
                                         derive_terms)
from repro_torch.optim import adamw

# long_500k policy (DESIGN.md §skips): sub-quadratic archs only; dense archs
# run it only with the sliding-window variant (--swa / arch suffix ":swa").
LONG_OK = {"rwkv6-1.6b", "jamba-1.5-large-398b", "mixtral-8x7b"}
LONG_SKIP_REASON = {
    "qwen3-4b": "full attention; run with --swa for the SWA variant",
    "qwen3-32b": "full attention (O(S^2), 500k infeasible by design)",
    "phi3-medium-14b": "full attention (O(S^2), 500k infeasible by design)",
    "minicpm3-4b": "MLA is full attention over the latent cache",
    "qwen2-vl-2b": "full attention",
    "whisper-base": "enc-dec; decoder positions << 500k by construction",
    "dbrx-132b": "full attention",
}


def applicable(arch: str, shape_name: str, swa: bool) -> Optional[str]:
    """None if runnable, else skip reason."""
    if shape_name == "long_500k" and arch not in LONG_OK:
        if swa and arch in ("qwen3-4b", "phi3-medium-14b", "qwen3-32b"):
            return None
        return LONG_SKIP_REASON.get(arch, "full attention")
    return None


def arch_config(arch: str, swa: bool = False,
                mamba_chunk: int = 0) -> ArchConfig:
    cfg = get_arch_config(arch)
    if swa and cfg.sliding_window == 0 and cfg.num_heads:
        cfg = cfg.replace(sliding_window=4096)
    if mamba_chunk and cfg.mamba is not None:
        cfg = cfg.replace(mamba=dataclasses.replace(cfg.mamba,
                                                    chunk=mamba_chunk))
    return cfg


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: InputShape, mesh, device=None):
    """``(batch, specs)``: every input of the step that ``shape``
    exercises, zero-filled (tokens and labels are id 0), made in the
    current mode (fake tensors under the trace's), and their specs."""
    dp = data_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    tok_S = 1 if shape.kind == "decode" else S
    kw = {"device": device}
    batch = {}
    if cfg.embed_inputs:
        batch["embeds"] = torch.zeros((B, tok_S, cfg.d_model),
                                      dtype=torch.bfloat16, **kw)
    else:
        batch["tokens"] = torch.zeros((B, tok_S), dtype=torch.int32, **kw)
    if shape.kind == "train":
        batch["labels"] = torch.zeros((B, tok_S), dtype=torch.int32, **kw)
    if cfg.mrope:
        batch["mrope_positions"] = torch.zeros((3, B, tok_S),
                                               dtype=torch.int32, **kw)
    if cfg.encoder_layers:
        # serving carries the prefill-computed encoder memory
        key = "enc_memory" if shape.kind == "decode" else "enc_frames"
        batch[key] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                 dtype=torch.bfloat16, **kw)
    return batch, sh.batch_specs(batch, mesh, dp)


def hint_rules(mesh, seq_shard: bool = True):
    dp = data_axes(mesh)
    dpn = dp if len(dp) > 1 else dp[0]
    return {"batch": dpn, "seq": "model" if seq_shard else None,
            "vocab": "model", "heads_flat": "model"}


# ---------------------------------------------------------------------------
# the step, traced
# ---------------------------------------------------------------------------


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def _held(tensors, specs, mesh) -> float:
    """A card's bytes of the leaves ``tensors`` (a mapping) at ``specs``."""
    return sum(_bytes(t) / sh.shard_count(specs[k], mesh)
               for k, t in tensors.items())


def _leaves(tree, specs):
    """(tensor, spec) pairs of a nested list/dict tree and its specs."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            yield from _leaves(t, s)
    else:
        yield tree, specs


def _gathered(params, specs, mesh) -> float:
    """The largest layer's bytes that a card does not hold: what it
    gathers to run that layer (a block, the embedding or the LM head)."""
    per = {}
    for k, p in params.items():
        parts = k.split(".")
        layer = ".".join(parts[:2]) if parts[0] in ("blocks", "encoder") \
            else parts[0]
        n = sh.shard_count(specs[k], mesh)
        per[layer] = per.get(layer, 0.0) + _bytes(p) * (1 - 1 / n)
    return max(per.values(), default=0.0)


def _act_factor(sites, rules, mesh) -> int:
    """The shards of the residual stream: the spec ``rules`` give its
    first ("batch", "seq", None) hint (the embedding's)."""
    for logical, shape, _ in sites:
        if logical == ("batch", "seq", None):
            return sh.shard_count(resolve(shape, logical, rules, mesh), mesh)
    return 1


@dataclasses.dataclass
class _Traced:
    """A traced step and the fake state it ran over."""
    key: tuple
    params: dict
    batch: dict
    opt_state: Optional[dict]
    caches: Optional[list]
    trace: object
    sites: list
    seconds: float
    comm: object


_LAST: Optional[_Traced] = None    # the last dense trace, for the next mesh


def _trace_step(cfg, shape, mesh, moe_impl, rolling, opts) -> _Traced:
    """Trace ``shape``'s step of ``cfg`` on fake tensors. A dense step's
    trace does not depend on the mesh (the hints record, they do not
    shard), so the last one is reused when only the mesh changes."""
    global _LAST
    kind = shape.kind
    remat_policy = opts.get("remat", "full")
    key = (cfg, shape, moe_impl, rolling, remat_policy,
           opts.get("remat_gran", "group"), opts.get("microbatch", 1))
    if moe_impl == "dense" and _LAST is not None and _LAST.key == key:
        return _LAST
    _LAST = None
    dp = data_axes(mesh)
    comm = ep_mesh = None
    if moe_impl == "ep":
        comm = RecordingComm(mesh.shape["model"])
        ep_mesh = ExpertMesh(math.prod(mesh.shape[a] for a in dp),
                             mesh.shape["model"], comm)
    mode, model = fake_model(
        cfg, moe_impl=moe_impl, mesh=ep_mesh, remat=(kind == "train"),
        rolling_window_decode=rolling, remat_policy=remat_policy,
        remat_granularity=opts.get("remat_gran", "group"))
    params = dict(model.named_parameters())
    B, S = shape.global_batch, shape.seq_len
    opt_state = caches = grads_of = None
    with mode:
        batch, _ = input_specs(cfg, shape, mesh)
        if kind == "train":
            opt = adamw(1e-4)
            opt_state = opt.init(params)

            def step():
                return train_step(model, opt, opt_state, params, batch,
                                  opts.get("microbatch", 1))
            grads_of = lambda r: r[1].values()            # noqa: E731
        elif kind == "prefill":
            def step():
                return model.prefill(batch, S)
        else:
            caches = model.init_cache(B, S)

            def step():
                return model.decode_step(batch, caches, S - 1)
    rules = hint_rules(mesh, not opts.get("no_seq_shard", False))
    t0 = time.perf_counter()
    with use_hints(mesh, rules) as sites:
        _, tr = trace(step, mode, grads=grads_of)
    out = _Traced(key, params, batch, opt_state, caches, tr, sites,
                  time.perf_counter() - t0, comm)
    if moe_impl == "dense":
        _LAST = out
    return out


def plan_step(cfg: ArchConfig, shape: InputShape, mesh, moe_impl="dense",
              rolling: bool = False, opts: Optional[dict] = None) -> dict:
    """Trace ``shape``'s step of ``cfg`` on fake tensors and reckon a
    card's share on ``mesh``; returns the plan's numbers."""
    opts = opts or {}
    kind = shape.kind
    t = _trace_step(cfg, shape, mesh, moe_impl, rolling, opts)
    dp = data_axes(mesh)
    params, tr = t.params, t.trace
    serve_dp = () if (kind == "decode"
                      and opts.get("serve_weights") == "model-only") else dp
    p_specs = sh.param_specs(params, mesh, serve_dp)
    state = {"params": _held(params, p_specs, mesh),
             "inputs": _held(t.batch, sh.batch_specs(t.batch, mesh, dp),
                             mesh)}
    if t.opt_state is not None:
        state["opt"] = (_held(t.opt_state["m"], p_specs, mesh)
                        + _held(t.opt_state["v"], p_specs, mesh))
    if t.caches is not None:
        c_specs = sh.cache_specs(t.caches, mesh, dp)
        state["caches"] = sum(_bytes(c) / sh.shard_count(s, mesh)
                              for c, s in _leaves(t.caches, c_specs))
    chips = mesh.size
    # the gradients are shaped, typed and sharded as the parameters
    grads = state["params"] if kind == "train" else 0.0
    grad_div = (sum(map(_bytes, params.values())) / grads if grads
                else 1.0)
    rules = hint_rules(mesh, not opts.get("no_seq_shard", False))
    act_div = _act_factor(t.sites, rules, mesh)
    transient = tr.peak_bytes(act_div, grad_div)
    gathered = _gathered(params, p_specs, mesh)
    a2a = 0.0
    if t.comm is not None:
        M, dp_n = mesh.shape["model"], math.prod(mesh.shape[a] for a in dp)
        a2a = t.comm.sent / (M * dp_n) * (M - 1) / M
    coll = collective_bytes(params, p_specs, mesh, kind == "train",
                            kind == "train"
                            and opts.get("remat", "full") != "none", a2a)
    held = sum(state.values()) + grads
    return {
        "trace": tr, "trace_seconds": t.seconds, "chips": chips,
        "cost": {"flops": tr.flops / chips,
                 "bytes": tr.bytes_accessed / chips, "coll": coll},
        "state_bytes_per_device": {**state, "grads": grads},
        "held_bytes_per_device": held,
        "activation_shard_factor": act_div,
        "transient_peak_bytes_per_device": transient,
        "gathered_bytes_per_device": gathered,
        "memory_per_device_bytes": held - grads + transient + gathered,
        "hint_sites": len(t.sites),
    }


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _write(rec: dict, tag: str, out_dir: Optional[str]) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = tag.replace("|", "__").replace(":", "_") + ".json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1, default=str)


def run_one(arch: str, shape_name: str, mesh_name: str, moe_impl: str,
            swa: bool, out_dir: Optional[str], verbose: bool = True,
            calibrate: bool = True, opts: Optional[dict] = None,
            tag_suffix: str = "", mesh=None, cfg: Optional[ArchConfig] = None,
            shape: Optional[InputShape] = None) -> dict:
    """Plan one combination and return its record (``status`` ok | skip
    | error), written to ``out_dir`` as ``<tag>.json`` when given.
    ``calibrate`` has no effect: every layer is traced. ``mesh``,
    ``cfg`` and ``shape`` replace the production mesh of ``mesh_name``,
    the arch's config and the named input shape."""
    del calibrate
    opts = opts or {}
    shape = shape or INPUT_SHAPES[shape_name]
    skip = applicable(arch, shape_name, swa)
    tag = (f"{arch}{':swa' if swa else ''}|{shape_name}|{mesh_name}|"
           f"{moe_impl}{tag_suffix}")
    if skip:
        rec = {"tag": tag, "status": "skip", "reason": skip}
        if verbose:
            print(f"[dryrun] SKIP {tag}: {skip}")
        _write(rec, tag, out_dir)
        return rec
    cfg = cfg or arch_config(arch, swa, mamba_chunk=opts.get("mamba_chunk",
                                                               0))
    mesh = mesh or make_production_mesh(multi_pod=(mesh_name == "multi"))
    rolling = swa or (arch == "mixtral-8x7b" and shape_name == "long_500k") \
        or opts.get("rolling", False)
    try:
        plan = plan_step(cfg, shape, mesh, moe_impl, rolling, opts)
        tr = plan["trace"]
        terms = derive_terms(arch + (":swa" if swa else ""), shape,
                             mesh_name, plan["chips"], plan["cost"],
                             plan["memory_per_device_bytes"], cfg)
        rec = {"tag": tag, "status": "ok",
               "traced_layers": cfg.num_layers + cfg.encoder_layers,
               **terms.as_dict(),
               "bound_s": terms.bound_s,
               "held_bytes_per_device": plan["held_bytes_per_device"],
               "state_bytes_per_device": plan["state_bytes_per_device"],
               "activation_shard_factor": plan["activation_shard_factor"],
               "transient_peak_bytes_per_device":
                   plan["transient_peak_bytes_per_device"],
               "gathered_bytes_per_device": plan["gathered_bytes_per_device"],
               "traced_ops": tr.ops, "kernels": tr.kernels,
               "hint_sites": plan["hint_sites"],
               "trace_seconds": plan["trace_seconds"]}
        if verbose:
            t = (terms.t_compute_s, terms.t_memory_s, terms.t_collective_s)
            share = "/".join(f"{x / sum(t):.0%}" for x in t)
            print(f"[dryrun] OK   {tag}  "
                  f"flops/dev={terms.traced_flops_per_device:.3e} "
                  f"mem/dev={terms.memory_per_device_bytes / 2**30:.2f}GiB "
                  f"coll/dev={terms.collective_bytes_per_device / 2**20:.1f}"
                  f"MiB dom={terms.dominant} c/m/x={share} "
                  f"bound={terms.bound_s * 1e3:.1f}ms "
                  f"useful={terms.useful_flops_ratio:.2f} "
                  f"({tr.ops} ops in {plan['trace_seconds']:.1f}s)")
    except Exception as e:  # noqa: BLE001 — report every failure mode
        rec = {"tag": tag, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        if verbose:
            print(f"[dryrun] FAIL {tag}: {type(e).__name__}: {e}")
    _write(rec, tag, out_dir)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--moe-impl", default="dense", choices=["dense", "ep"])
    ap.add_argument("--swa", action="store_true",
                    help="sliding-window variant for dense archs")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rolling", action="store_true",
                    help="O(window) rolling decode cache (SWA archs)")
    ap.add_argument("--serve-weights", default="fsdp",
                    choices=["fsdp", "model-only"])
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--remat-gran", default="group",
                    choices=["group", "block"])
    ap.add_argument("--mamba-chunk", type=int, default=0)
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="batch-only activation sharding (SSM archs)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation micro-batches (train)")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="accepted for the reference's CLI; no effect "
                         "(every layer is traced)")
    ap.add_argument("--tag", default="",
                    help="suffix for perf-iteration artifacts")
    args = ap.parse_args(argv)
    opts = {"rolling": args.rolling, "serve_weights": args.serve_weights,
            "remat": args.remat, "remat_gran": args.remat_gran,
            "mamba_chunk": args.mamba_chunk,
            "no_seq_shard": args.no_seq_shard,
            "microbatch": args.microbatch}

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.perf_counter()
    results = []
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                results.append(run_one(arch, shape, mesh_name,
                                       args.moe_impl, args.swa, args.out,
                                       opts=opts,
                                       calibrate=not args.no_calibrate,
                                       tag_suffix=args.tag))
    bad = [r for r in results if r["status"] == "error"]
    print(f"[dryrun] {len(results)} combos: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skip' for r in results)} skip, "
          f"{len(bad)} error in {time.perf_counter() - t0:.0f}s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
