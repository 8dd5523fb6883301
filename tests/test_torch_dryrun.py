"""The port's dry-run against the JAX package's, on the CPU: the remat
knobs' loss and gradients, the skip policy, ``run_one``'s records, the
fake-tensor trace's FLOPs against XLA's cost analysis of the same step,
and the CLI at full size.

The traced FLOPs count the products only (``FlopCounterMode``), XLA's
``cost_analysis()["flops"]`` every op; on a reduced Qwen3 train step at
d_model 512 (B 2, T 256, remat full, AdamW) the port traces 2.37% fewer
FLOPs than XLA compiles (2.791729e10 against 2.859364e10).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.arch.model as jax_model_mod  # noqa: E402
from repro.arch import build_model as jax_build_model  # noqa: E402
from repro.config import get_arch_config as jax_arch_config  # noqa: E402

from repro_torch.arch import build_model  # noqa: E402
from repro_torch.config import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                get_arch_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.faketrace import (fake_model, trace,  # noqa: E402
                                          train_step, visible_pairs)
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5      # the LM-training tolerance of test_torch_lm_train
CHUNK = 16
SETTINGS = [(p, g) for p in ("full", "dots", "none")
            for g in ("group", "block")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ref_dryrun():
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_remat_knobs_match_the_reference(arch):
    """full | dots | none x group | block: the loss and its gradients
    within the LM-training tolerance of the reference's
    ``value_and_grad`` at the same settings, and bitwise equal to each
    other on the CPU (recomputing changes no bit). Reduced Jamba is one
    group of two layers, so group and block differ there; a dense or MoE
    model's group is one block, where the reference's "block" program is
    its "group" one, so its three policies are compiled once each."""
    jcfg = jax_arch_config(arch).reduced().replace(dtype="float32")
    cfg = get_arch_config(arch).reduced().replace(dtype="float32")
    jm = jax_build_model(jcfg, remat=True)
    params = jm.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    sd = lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, params))
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()}
    got = []
    for policy, gran in SETTINGS:
        model = build_model(cfg, remat=True, remat_policy=policy,
                            remat_granularity=gran)
        model.load_state_dict(sd, strict=True)
        loss = model.loss(batch, chunk=CHUNK)
        loss.backward()
        got.append((loss.detach(), {k: p.grad for k, p in
                                    model.named_parameters()}))
    for loss, grads in got[1:]:
        assert torch.equal(loss, got[0][0])
        assert all(torch.equal(grads[k], got[0][1][k]) for k in grads)
    orig = jax_model_mod.LOSS_CHUNK
    jax_model_mod.LOSS_CHUNK = CHUNK
    try:
        jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
        for (policy, gran), (loss, grads) in zip(SETTINGS, got):
            if gran == "block" and not jcfg.attn_every:
                continue
            jm.remat_policy, jm.remat_granularity = policy, gran
            want_l, want_g = jax.jit(jax.value_and_grad(jm.loss))(params,
                                                                  jb)
            want_g = lm_params_from_jax(
                cfg, jax.tree_util.tree_map(np.asarray, want_g))
            assert abs(float(loss) - float(want_l)) <= \
                RTOL * abs(float(want_l)) + ATOL, (policy, gran)
            for k, g in grads.items():
                w = want_g[k].numpy()
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=RTOL,
                    atol=ATOL * max(1.0, float(np.abs(w).max())),
                    err_msg=f"{arch} {policy}/{gran} {k}")
    finally:
        jax_model_mod.LOSS_CHUNK = orig


def test_remat_knobs_refuse_unknown_values():
    cfg = get_arch_config("qwen3-4b").reduced()
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(cfg, remat_policy="some")
    with pytest.raises(ValueError, match="remat_granularity"):
        build_model(cfg, remat_granularity="layer")


def test_applicable_agrees_with_the_reference():
    ref = _ref_dryrun()
    n = 0
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            for swa in (False, True):
                assert dryrun.applicable(arch, shape, swa) == \
                    ref.applicable(arch, shape, swa), (arch, shape, swa)
                n += 1
    assert n == 80
    assert dryrun.LONG_OK == ref.LONG_OK
    assert dryrun.LONG_SKIP_REASON == ref.LONG_SKIP_REASON


KEYS = {"tag", "status", "traced_layers", "arch", "shape", "mesh", "chips",
        "traced_flops_per_device", "traced_bytes_per_device",
        "collective_bytes_per_device", "nvlink_bytes_per_device",
        "network_bytes_per_device", "t_compute_s", "t_memory_s",
        "t_nvlink_s", "t_network_s", "t_collective_s", "dominant",
        "model_flops_per_device", "useful_flops_ratio",
        "memory_per_device_bytes", "collective_breakdown", "bound_s",
        "held_bytes_per_device", "state_bytes_per_device",
        "activation_shard_factor", "transient_peak_bytes_per_device",
        "gathered_bytes_per_device", "traced_ops", "kernels", "hint_sites",
        "trace_seconds"}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_run_one_on_reduced_configs(arch, tmp_path):
    """Every combo of a reduced config (at a short sequence): ``ok``, with
    the record's keys, written under the reference's file name; the
    skipped long_500k ones with the reference's reason."""
    cfg = get_arch_config(arch).reduced()
    mesh = ShapeMesh(("data", "model"), (2, 2))
    for name, shape in INPUT_SHAPES.items():
        small = shape.__class__(name, 64, 4, shape.kind)
        rec = dryrun.run_one(arch, name, "single", "dense", False,
                             str(tmp_path), verbose=False, mesh=mesh,
                             cfg=cfg, shape=small)
        reason = dryrun.applicable(arch, name, False)
        fname = tmp_path / f"{arch}__{name}__single__dense.json"
        assert json.loads(fname.read_text())["status"] == rec["status"]
        if reason:
            assert rec == {"tag": rec["tag"], "status": "skip",
                           "reason": reason}
            continue
        assert rec["status"] == "ok", rec.get("trace")
        assert set(rec) == KEYS
        assert rec["traced_layers"] == cfg.num_layers + cfg.encoder_layers
        assert rec["traced_flops_per_device"] > 0
        assert rec["memory_per_device_bytes"] >= rec["held_bytes_per_device"]
        assert rec["activation_shard_factor"] == (
            4 if shape.kind != "decode" else 2)


def test_ep_plan_counts_the_all_to_alls():
    """``--moe-impl ep``: the all-to-alls that moe_ffn_ep sent, forward
    and backward, reach the NVLink term."""
    cfg = get_arch_config("mixtral-8x7b").reduced()
    mesh = ShapeMesh(("data", "model"), (2, 2))
    small = INPUT_SHAPES["train_4k"].__class__("train_4k", 64, 4, "train")
    ep = dryrun.run_one("mixtral-8x7b", "train_4k", "single", "ep", False,
                        None, verbose=False, mesh=mesh, cfg=cfg, shape=small)
    dense = dryrun.run_one("mixtral-8x7b", "train_4k", "single", "dense",
                           False, None, verbose=False, mesh=mesh, cfg=cfg,
                           shape=small)
    assert ep["status"] == dense["status"] == "ok"
    a2a = ep["collective_breakdown"]["all-to-all"]
    assert a2a > 0 and dense["collective_breakdown"]["all-to-all"] == 0
    assert ep["nvlink_bytes_per_device"] == pytest.approx(
        dense["nvlink_bytes_per_device"] + a2a)


def test_kernel_scopes_book_the_kernel_not_its_plain_version():
    """A served prefill books flash_attention's operands and outputs and
    its visible pairs' FLOPs, never the plain version's (B, H, S, S)
    scores; with no kernel in the way the trace's live bytes are the
    real step's."""
    cfg = get_arch_config("qwen3-4b").reduced()
    mode, model = fake_model(cfg, remat=False)
    B, S = 2, 1024
    with mode:
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    _, tr = trace(lambda: model.prefill(batch, S), mode)
    assert tr.kernels == {"flash_attention": cfg.num_layers}
    scores = B * cfg.num_heads * S * S * 4
    assert tr.peak_bytes() < scores
    hd = cfg.resolved_head_dim
    attn = 4 * B * cfg.num_heads * hd * visible_pairs(S)
    assert tr.flops == pytest.approx(tr.flops_by_op["aten.mm"]
                                     + cfg.num_layers * attn)
    assert visible_pairs(4) == 10 and visible_pairs(4, causal=False) == 16
    assert visible_pairs(6, sliding_window=2) == 11


def test_traced_flops_near_xla_cost_analysis():
    """A reduced dense train step at d_model 512: the trace's FLOPs
    within 10% of XLA's for the reference's same step (loss, gradients,
    AdamW), unrolled so XLA costs every layer."""
    from repro.optim import adamw as jax_adamw
    kw = dict(d_model=512, num_heads=4, num_kv_heads=2, head_dim=128,
              d_ff=1536, vocab_size=1024, num_layers=2)
    jcfg = jax_arch_config("qwen3-4b").replace(**kw)
    cfg = get_arch_config("qwen3-4b").replace(**kw)
    B, S = 2, 256
    jm = jax_build_model(jcfg, remat=True)
    jm.unroll_layers = True
    opt = jax_adamw(1e-4)
    p_shapes = jm.param_shapes()

    def step(params, state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        params, state = opt.update(grads, state, params)
        return loss, params, state

    spec = jax.ShapeDtypeStruct((B, S), jnp.int32)
    compiled = jax.jit(step).lower(
        p_shapes, jax.eval_shape(opt.init, p_shapes),
        {"tokens": spec, "labels": spec}).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    want = float(cost["flops"])
    mode, model = fake_model(cfg, remat=True)
    params = dict(model.named_parameters())
    with mode:
        popt = adamw(1e-4)
        state = popt.init(params)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
                 "labels": torch.zeros((B, S), dtype=torch.int32)}
    _, tr = trace(lambda: train_step(model, popt, state, params, batch),
                  mode, grads=lambda r: r[1].values())
    gap = tr.flops / want - 1
    assert abs(gap) < 0.10, (tr.flops, want, gap)


def test_cli_plans_qwen3_at_full_size(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-4b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(tmp_path)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 combos: 1 ok, 0 skip, 0 error" in proc.stdout
    rec = json.loads((tmp_path / "qwen3-4b__train_4k__single__dense.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["traced_layers"] == 36
    assert set(rec) == KEYS
    # 256 cards share the global batch: a card's share of a 4.4B model
    # under FSDP is 1/256 of its weights, gradients and moments
    n = get_arch_config("qwen3-4b")
    state = rec["state_bytes_per_device"]
    assert state["params"] == state["grads"]
    assert state["opt"] == 4 * state["params"]       # float32 m and v
    assert 0 < rec["memory_per_device_bytes"] < 80e9
    assert rec["model_flops_per_device"] == pytest.approx(
        6 * n.active_param_count() * 256 * 4096 / 256)
