"""LM training in the port against the JAX package's, on the CPU.

``TransformerLM.loss`` and its gradients against
``jax.value_and_grad(model.loss)`` on the same weights and batch, for a
reduced model of each family (dense, MoE, hybrid, MLA, RWKV, audio,
VLM), with ``remat`` off and on, within rtol 1e-4 / atol 1e-5 (RWKV-6's
gradient flows through the plain ``wkv_chunked``, never the
forward-only kernel); the gradient-accumulation twins of
``tests/test_microbatch.py``; and ``train_lm``'s losses over 20 steps
against the reference's ``train_lm`` from the same initial weights,
within 1e-4 * max(1, |loss|) at every step.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.arch.model as jax_model_mod  # noqa: E402
from repro.arch import build_model as jax_build_model  # noqa: E402
from repro.config import get_arch_config as jax_arch_config  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402

from repro_torch.arch import build_model  # noqa: E402
from repro_torch.config import get_arch_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.microbatch import (microbatched_value_and_grad,  # noqa: E402,E501
                                           split_batch)
from repro_torch.launch.train import train_lm  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
LOSS_REL = 1e-4
CHUNK = 16          # the loss chunk both packages use here
# one reduced arch per family: dense, MoE, hybrid, MLA, RWKV, audio, VLM
FAMILIES = ["qwen3-4b", "mixtral-8x7b", "jamba-1.5-large-398b",
            "minicpm3-4b", "rwkv6-1.6b", "whisper-base", "qwen2-vl-2b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(cfg, B, S, seed=0):
    """numpy inputs and labels, with distinct M-RoPE streams."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(S)[None], (B, S))
        out["mrope_positions"] = np.stack(
            [pos, pos + pos % 3, pos + 2 * (pos % 5)]).astype(np.int32)
    if cfg.encoder_layers:
        out["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _torch(b):
    return {k: (torch.from_numpy(v).long() if k in ("tokens", "labels")
                else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in b.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(arch, cfg, JAX params, the JAX loss and gradients by port name,
    the batch) for one reduced arch in float32."""
    arch = request.param
    jcfg = jax_arch_config(arch).reduced().replace(dtype="float32")
    cfg = get_arch_config(arch).reduced().replace(dtype="float32")
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(2))
    batch = _batch(cfg, 2, 32)
    orig = jax_model_mod.LOSS_CHUNK
    jax_model_mod.LOSS_CHUNK = CHUNK
    try:
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jax_model_mod.LOSS_CHUNK = orig
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (arch, cfg, lm_params_from_jax(cfg, host(params)), float(loss),
            lm_params_from_jax(cfg, host(grads)), batch)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(family, remat, monkeypatch):
    arch, cfg, sd, want_loss, want_grads, batch = family
    model = build_model(cfg, remat=remat)
    model.load_state_dict(sd, strict=True)
    # the training path never reaches a forward-only kernel's wrapper
    for name in ("flash_attention_op", "wkv6_op"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **k: pytest.fail(
            f"{arch}: the loss called {_n}"))
    loss = model.loss(_torch(batch), chunk=CHUNK)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - want_loss) <= RTOL * abs(want_loss) + ATOL, (
        arch, loss, want_loss)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        scale = float(np.abs(want_grads[k].numpy()).max())
        np.testing.assert_allclose(
            g.numpy(), want_grads[k].numpy(), rtol=RTOL,
            atol=ATOL * max(1.0, scale), err_msg=f"{arch} remat={remat} {k}")


def test_rwkv_loss_refuses_the_forward_only_kernel():
    """On the serving path (``train`` off) RWKV-6's recurrence is the
    ``wkv6`` kernel, which refuses autograd: a gradient through it would
    be silently zero on the card."""
    cfg = get_arch_config("rwkv6-1.6b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    x = model.embed["table"][torch.zeros((1, 16), dtype=torch.long)]
    with pytest.raises(RuntimeError, match="wkv6.*forward-only"):
        model._backbone(x, positions=None)
    h, _, _ = model._backbone(x, positions=None, train=True)
    h.sum().backward()
    assert model.blocks[0]["time"]["bonus_u"].grad.abs().sum() > 0


def _qwen(vocab=256):
    return get_arch_config("qwen3-4b").reduced().replace(dtype="float32",
                                                         vocab_size=vocab)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_microbatched_grads_match_full_batch(n_micro):
    cfg = _qwen()
    model = build_model(cfg, torch.Generator().manual_seed(0), remat=False)
    params = dict(model.named_parameters())
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (8, 16))),
             "labels": torch.from_numpy(rng.integers(0, 256, (8, 16)))}
    loss_fn = lambda b: model.loss(b, chunk=16)  # noqa: E731
    l0, g0 = microbatched_value_and_grad(loss_fn, 1)(params, batch)
    l1, g1 = microbatched_value_and_grad(loss_fn, n_micro)(params, batch)
    assert abs(float(l0) - float(l1)) < 1e-5
    assert set(g0) == set(g1) == set(params)
    for k in g0:
        assert g1[k].dtype == params[k].dtype
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-5)


def test_split_batch_handles_mrope_axis():
    batch = {"tokens": torch.zeros((8, 4), dtype=torch.int32),
             "mrope_positions": torch.arange(3 * 8 * 4).reshape(3, 8, 4)}
    mb = split_batch(batch, 4)
    assert mb["tokens"].shape == (4, 2, 4)
    assert mb["mrope_positions"].shape == (4, 3, 2, 4)
    # micro-batch 1 holds rows 2-3 of every stream
    assert torch.equal(mb["mrope_positions"][1],
                       batch["mrope_positions"][:, 2:4])
    with pytest.raises(ValueError, match="multiple of n_micro"):
        split_batch(batch, 3)


def test_microbatch_with_vlm_inputs():
    """Qwen2-VL's embeddings and streams split on their own batch axes;
    the accumulated gradients are the full batch's, and the JAX
    package's on the same weights."""
    arch = "qwen2-vl-2b"
    jcfg = jax_arch_config(arch).reduced().replace(dtype="float32",
                                                   vocab_size=256)
    cfg = get_arch_config(arch).reduced().replace(dtype="float32",
                                                  vocab_size=256)
    jm = jax_build_model(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, remat=False)
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jp)), strict=True)
    b = _batch(cfg, 4, 16, seed=1)
    del b["tokens"]
    params = dict(model.named_parameters())
    loss_fn = lambda x: model.loss(x, chunk=16)  # noqa: E731
    l0, g0 = microbatched_value_and_grad(loss_fn, 1)(params, _torch(b))
    l1, g1 = microbatched_value_and_grad(loss_fn, 2)(params, _torch(b))
    assert abs(float(l0) - float(l1)) < 1e-5
    orig = jax_model_mod.LOSS_CHUNK
    jax_model_mod.LOSS_CHUNK = 16
    try:
        jl = jax.jit(jm.loss)(jp, {k: jnp.asarray(v) for k, v in b.items()})
    finally:
        jax_model_mod.LOSS_CHUNK = orig
    assert abs(float(l1) - float(jl)) < 1e-5
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-base", "qwen2-vl-2b",
                                  "rwkv6-1.6b"])
def test_train_lm_matches_the_reference(arch, monkeypatch):
    """20 steps at batch 2, seq 32 from the reference's initial weights:
    every step's loss within 1e-4 * max(1, |loss|) of the reference's
    ``train_lm`` (its ``LOSS_CHUNK`` rebinding undone after the test)."""
    monkeypatch.setattr(jax_model_mod, "LOSS_CHUNK", 512)
    steps, B, S = 20, 2, 32
    want = jax_train.train_lm(arch, steps, B, S, log_every=1)
    cfg = want["cfg"]
    jp = jax_build_model(cfg, remat=False).init(jax.random.PRNGKey(0))
    mine = get_arch_config(arch).reduced()
    mine = mine.replace(dtype="float32", vocab_size=min(mine.vocab_size,
                                                        1024))
    sd = lm_params_from_jax(mine, jax.tree_util.tree_map(np.asarray, jp))
    got = train_lm(arch, steps, B, S, device="cpu", state_dict=sd,
                   log_every=1)
    assert got["cfg"] == mine and len(got["losses"]) == steps
    ref = [h["loss"] for h in want["history"]]
    assert [h["step"] for h in got["history"]] == list(range(steps))
    for i, (a, b) in enumerate(zip(got["losses"], ref)):
        assert np.isfinite(a) and abs(a - b) <= LOSS_REL * max(1.0, abs(b)), (
            arch, i, a, b)
    assert got["final_loss"] == got["losses"][-1]
