"""The port's LM serving path against the JAX package's.

Reduced Qwen3-4B and RWKV-6 in float32, with the JAX model's params
loaded into the port through ``lm_params_from_jax``: prefill logits and
caches and 8 decode steps must match the JAX model within rtol 1e-4 /
atol 1e-5 (prefill goes through the kernels' plain versions on the CPU,
the reference through ``_sdpa`` and ``wkv_chunked``); prefill(S/2) plus
decodes must equal prefill(S) inside the port; and the port's
``BatchServer`` must produce the JAX server's tokens on mixed-length
prompts, batched equal to solo. Decode at a device-tensor index, and
through ``DecodeGraph``'s fixed buffers (what the card captures once per
bucket), must give eager decode's bits on the CPU; the capture itself is
tested on the card (``tests/test_torch_graphs.py``, which the card's
lane collects without JAX).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import build_model as jax_build_model  # noqa: E402
from repro.config import get_arch_config as jax_arch_config  # noqa: E402
from repro.launch.serve import BatchServer as JaxBatchServer  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402

from repro_torch.arch import build_model, layer_kinds  # noqa: E402
from repro_torch.config import get_arch_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.nn.attention import attention_apply  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["qwen3-4b", "rwkv6-1.6b"]
# and the attention archs that came with the MoE FFN and the rolling
# cache: MoE with a sliding window (mixtral), fine-grained MoE (dbrx),
# dense GQA (phi3, qwen3-32b)
SERVED = ARCHS + ["mixtral-8x7b", "dbrx-132b", "phi3-medium-14b",
                  "qwen3-32b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch):
    return (jax_arch_config(arch).reduced().replace(dtype="float32"),
            get_arch_config(arch).reduced().replace(dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, JAX params, port model with those params)."""
    jcfg, cfg = _cfgs(request.param)
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(1))
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return request.param, jm, params, model


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_configs_are_the_references():
    for arch in SERVED:
        jcfg = jax_arch_config(arch)
        cfg = get_arch_config(arch)
        for field in ("name", "family", "num_layers", "d_model", "num_heads",
                      "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                      "resolved_head_dim", "qk_norm", "sliding_window",
                      "rope_theta", "moe_every", "dtype", "norm_eps",
                      "tie_embeddings", "source"):
            assert getattr(cfg, field) == getattr(jcfg, field), (arch, field)
        red, jred = cfg.reduced(), jcfg.reduced()
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "head_dim", "d_ff", "vocab_size", "sliding_window"):
            assert getattr(red, field) == getattr(jred, field), (arch, field)
        assert (cfg.moe is None) == (jcfg.moe is None), arch
        if cfg.moe is not None:
            assert vars(cfg.moe) == vars(jcfg.moe), arch
            assert vars(red.moe) == vars(jred.moe), arch
        assert (cfg.rwkv is None) == (jcfg.rwkv is None)
        if cfg.rwkv is not None:
            assert vars(cfg.rwkv) == vars(jcfg.rwkv)
            assert vars(cfg.reduced().rwkv) == vars(jcfg.reduced().rwkv)
        assert layer_kinds(cfg) == [
            "rwkv" if cfg.rwkv is not None else "attn"] * cfg.num_layers


def test_prefill_and_decode_match_jax(pair):
    arch, jm, params, model = pair
    cfg = model.cfg
    B, P, N = 2, 16, 8
    toks = _tokens(cfg, B, P + N)
    jl, jc, jidx = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P])},
                              cache_len=P + N)
    pl, pc, idx = model.prefill({"tokens": torch.from_numpy(toks[:, :P])
                                 .long()}, cache_len=P + N)
    _close(pl, jl, f"{arch}: prefill logits")
    assert idx == int(jidx) == P
    for layer, c in enumerate(pc):
        if arch == "qwen3-4b":
            for key in ("k", "v"):
                _close(c[key], jc[0][key][layer], f"layer {layer} {key}")
        else:
            _close(c["time"]["state"], jc[0]["time"]["state"][layer],
                   f"layer {layer} state")
            _close(c["time"]["last"], jc[0]["time"]["last"][layer],
                   f"layer {layer} time shift")
            _close(c["channel"]["last"], jc[0]["channel"]["last"][layer],
                   f"layer {layer} channel shift")
    for t in range(P, P + N):
        jl, jc, jidx = jm.decode_step(
            params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc, jidx)
        pl, pc, idx = model.decode_step(
            {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, pc, idx)
        _close(pl, jl, f"{arch}: decode step {t - P}")


# bf16 logits, port vs reference (ROADMAP C.13). bf16 keeps 8 significant
# bits, so one rounding of a logit near the largest moves it by up to
# 2^-8 = 3.9e-3 of max|logit|; the two packages round activations at
# different places through the 2 reduced layers (XLA keeps some fused
# intermediates in float32, PyTorch's CPU ops round each output). Measured
# on the CPU: 1.21e-2 (Qwen3-4B) and 1.80e-2 (RWKV-6) of max|logit| over
# prefill and 4 decode steps, 1.55e-2 for RWKV-6 before its WKV output was
# kept in float32 (C.10). The gate is 4e-2, about 10 ulps at the largest
# logit and twice the larger measurement.
BF16_LOGITS = 4e-2


def _bf16_logit_gaps(jm, params, model, toks, P, N):
    """max|dlogit| / max|logit| of the port against the JAX model over a
    bf16 prefill of P tokens and N decode steps."""
    jl, jc, jidx = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P])},
                              cache_len=P + N)
    pl, pc, idx = model.prefill({"tokens": torch.from_numpy(toks[:, :P])
                                 .long()}, cache_len=P + N)
    pairs = [(pl, jl)]
    for t in range(P, P + N):
        jl, jc, jidx = jm.decode_step(
            params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc, jidx)
        pl, pc, idx = model.decode_step(
            {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, pc, idx)
        pairs.append((pl, jl))
    rels = []
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.isfinite(got).all()
        rels.append(float(np.abs(got - want).max() / np.abs(want).max()))
    return rels


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_near_jax(arch, monkeypatch):
    jcfg = jax_arch_config(arch).reduced()
    cfg = get_arch_config(arch).reduced()
    assert cfg.dtype == jcfg.dtype == "bfloat16"
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(1))
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_jax(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params)), strict=True)
    toks = _tokens(cfg, 2, 36)
    rels = _bf16_logit_gaps(jm, params, model, toks, 32, 4)
    print(f"{arch} bf16 max|dlogit|/max|logit| per step (prefill, 4 "
          f"decodes): {['%.3e' % r for r in rels]}")
    assert max(rels) <= BF16_LOGITS, rels
    if cfg.rwkv is not None:
        # the same run with WKV's o rounded to bf16 before ln_x, as
        # before C.10's repair: reported, not gated
        from repro_torch.kernels import ops
        real = ops.wkv6_op
        monkeypatch.setattr(ops, "wkv6_op",
                            lambda *a, out_dtype=None: real(*a))
        before = _bf16_logit_gaps(jm, params, model, toks, 32, 4)
        print(f"{arch} with o rounded to bf16 before ln_x: "
              f"{['%.3e' % r for r in before]}")


def test_bf16_rwkv_time_mixing_nearer_jax_with_float32_o(monkeypatch):
    """ROADMAP C.10 against the reference: in bf16, layer 0's time mixing
    parts from the JAX package's by less when ``ln_x`` reads the float32
    WKV output (the repair) than when it reads o rounded to bf16 first
    (the parent's path, rebuilt here by dropping ``out_dtype``)."""
    from repro.arch import rwkv6_block as jblk
    from repro_torch.arch import rwkv6_block as blk
    from repro_torch.kernels import ops
    jcfg = jax_arch_config("rwkv6-1.6b").reduced()
    cfg = get_arch_config("rwkv6-1.6b").reduced()
    params = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(1))
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_jax(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params)), strict=True)
    x = np.random.default_rng(5).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"][0]["time"])
    want, _ = jblk.rwkv_time_apply(jp, jnp.asarray(x).astype(jnp.bfloat16),
                                   jcfg.rwkv, jcfg.norm_eps)
    want = np.asarray(want, np.float32)

    def gap():
        with torch.no_grad():
            got, _ = blk.rwkv_time_apply(model.blocks[0]["time"],
                                         torch.from_numpy(x).bfloat16(),
                                         cfg.rwkv, cfg.norm_eps)
        d = np.abs(got.float().numpy() - want) / np.abs(want).max()
        return float(d.max()), float(d.mean())
    repaired = gap()
    real = ops.wkv6_op
    monkeypatch.setattr(ops, "wkv6_op", lambda *a, out_dtype=None: real(*a))
    parent = gap()
    print(f"rwkv6 layer-0 time mixing vs JAX, (max, mean) of max|out|: "
          f"float32 o {repaired}, bf16 o {parent}")
    assert repaired[0] < parent[0] and repaired[1] < parent[1]


def test_half_prefill_plus_decodes_equals_full_prefill(pair):
    arch, _, _, model = pair
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(model.cfg, B, S, seed=1)).long()
    full, _, _ = model.prefill({"tokens": toks}, cache_len=S)
    lo, caches, idx = model.prefill({"tokens": toks[:, :S // 2]},
                                    cache_len=S)
    for t in range(S // 2, S):
        lo, caches, idx = model.decode_step({"tokens": toks[:, t:t + 1]},
                                            caches, idx)
    _close(lo, full, f"{arch}: prefill(S/2) + decodes vs prefill(S)")


def _left_padded(cfg, lengths, seed=2):
    """(batch dict, pads) of seeded prompts of ``lengths``, left-padded."""
    P = max(lengths)
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), P), np.int64)
    for i, n in enumerate(lengths):
        toks[i, P - n:] = rng.integers(0, cfg.vocab_size, n)
    pads = torch.tensor([P - n for n in lengths])
    valid = torch.arange(P)[None, :] >= pads[:, None]
    return ({"tokens": torch.from_numpy(toks), "valid": valid,
             "positions": (torch.arange(P)[None, :] - pads[:, None])
             .clamp_min(0).to(torch.int32)}, pads)


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for t in items for x in _leaves(t)]


def test_decode_at_a_device_index_is_the_int_index(pair):
    """A decode step at a 0-d tensor index (what a captured round reads)
    gives the int index's logits and caches bit for bit, over left-padded
    prompts and 6 steps."""
    arch, _, _, model = pair
    batch, pads = _left_padded(model.cfg, (7, 3, 5))
    P, N = batch["tokens"].shape[1], 6
    runs = []
    for on_device in (False, True):
        logits, caches, idx = model.prefill(batch, cache_len=P + N)
        if on_device:
            idx = torch.tensor(idx)
        out = []
        for _ in range(N):
            tok = logits[:, -1].argmax(-1)[:, None]
            pos = (idx - pads)[:, None].to(torch.int32)
            logits, caches, idx = model.decode_step(
                {"tokens": tok, "valid": batch["valid"], "positions": pos},
                caches, idx)
            out.append(logits)
        assert int(idx) == P + N
        runs.append(out + _leaves(caches))
    assert all(torch.equal(a, b) for a, b in zip(*runs)), arch


def test_decode_graph_rounds_are_eager_decode(pair):
    """``DecodeGraph``'s rounds over its fixed buffers (a mask over every
    cache slot, the index a tensor, RWKV's states carried into place),
    eager on the CPU, give eager decode's logits and tokens bit for bit,
    for two batches in turn through the same buffers."""
    arch, _, _, model = pair
    cache_len = 16
    graph = serve.DecodeGraph(model, 3, cache_len)
    for lengths in ((7, 3, 5), (2, 9, 4)):
        batch, pads = _left_padded(model.cfg, lengths, seed=len(lengths))
        logits, caches, idx = model.prefill(batch, cache_len=cache_len)
        cur = logits[:, -1].argmax(-1)
        graph.start(caches, batch["valid"])
        logits, caches, idx = model.prefill(batch, cache_len=cache_len)
        want, got = [], []
        gcur, gidx = cur, idx
        for _ in range(4):
            pos = (idx - pads)[:, None].to(torch.int32)
            logits, caches, idx = model.decode_step(
                {"tokens": cur[:, None], "valid": batch["valid"],
                 "positions": pos}, caches, idx)
            cur = logits[:, -1].argmax(-1)
            want.append((logits.clone(), cur))
            glog, gcur = graph(gcur[:, None],
                               (gidx - pads)[:, None].to(torch.int32), gidx)
            gidx += 1
            got.append((glog.clone(), gcur.clone()))
        for (wl, wt), (gl, gt) in zip(want, got):
            assert torch.equal(wl, gl) and torch.equal(wt, gt), arch
    assert graph.captures == 0


def test_batch_server_certifies_its_decode():
    """Eager (the CPU) ``assert_compiled_per_bucket`` refuses a server
    that never decoded and passes once it has; the bucket is the batch
    size and cache length."""
    srv = serve.BatchServer("qwen3-4b", batch_size=2, cache_len=16,
                            device="cpu")
    assert not srv.graphs_on
    from repro_torch.core.trainer import RetraceError
    with pytest.raises(RetraceError):
        srv.assert_compiled_per_bucket()
    srv.run([serve.Request(0, np.arange(5, dtype=np.int32), 3)])
    srv.assert_compiled_per_bucket()
    assert srv.batches == 1 and srv.bucket == (2, 16)
    assert srv.captures == {}


def _mixed_prompts(vocab):
    # the prompts of tests/test_serving_extensions.py's batched-vs-solo
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (4, 9, 6)]


@pytest.mark.parametrize("arch", SERVED)
def test_batch_server_tokens_match_jax(arch, monkeypatch):
    """The port's server and the JAX server on the same weights give the
    same greedy tokens for mixed-length prompts. Mixtral is served as the
    reference serves it, rolling, with its window cut to 6 in both
    packages so that the 9-token batch's prefill and its decode wrap the
    cache's 6 slots."""
    rolling = arch == "mixtral-8x7b"
    if rolling:
        import repro.launch.serve as jax_serve
        for mod, get in ((jax_serve, jax_arch_config),
                         (serve, get_arch_config)):
            monkeypatch.setattr(mod, "get_arch_config", lambda a, g=get: (
                g(a).replace(sliding_window=6)))
    jsrv = JaxBatchServer(arch, batch_size=3, cache_len=24, reduced=True,
                          rolling=rolling)
    prompts = _mixed_prompts(jsrv.cfg.vocab_size)
    jreqs = [JaxRequest(i, p, 4) for i, p in enumerate(prompts)]
    jsrv.run(jreqs)
    cfg = get_arch_config(arch).reduced().replace(dtype="float32")
    sd = lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                        jsrv.params))
    srv = serve.BatchServer(arch, batch_size=3, cache_len=24, reduced=True,
                            rolling=rolling, device="cpu", state_dict=sd)
    if rolling:
        assert srv.cfg.sliding_window == jsrv.cfg.sliding_window == 6
        assert srv.model.init_cache(3, 24)[0]["pos"].shape == (6,)
    reqs = [serve.Request(i, p, 4) for i, p in enumerate(prompts)]
    srv.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert srv.stats.prefill_tokens == 9 * 3
    assert srv.stats.decode_tokens == 3 * 3


def test_batched_mixed_length_prompts_match_solo():
    srv = serve.BatchServer("qwen3-4b", batch_size=3, cache_len=24,
                            device="cpu", seed=3)
    prompts = _mixed_prompts(srv.cfg.vocab_size)
    reqs = [serve.Request(i, p, 4) for i, p in enumerate(prompts)]
    srv.run(reqs)
    solo = serve.BatchServer("qwen3-4b", batch_size=1, cache_len=24,
                             device="cpu", seed=3)
    for i, p in enumerate(prompts):
        r = serve.Request(0, p, 4)
        solo.run([r])
        assert r.out == reqs[i].out, (i, r.out, reqs[i].out)


def test_prefill_refuses_a_mask_that_is_not_a_left_pad():
    _, cfg = _cfgs("qwen3-4b")
    model = build_model(cfg)
    toks = torch.zeros((1, 4), dtype=torch.long)
    valid = torch.tensor([[True, False, True, True]])
    with pytest.raises(ValueError, match="left-pad"):
        model.prefill({"tokens": toks, "valid": valid}, cache_len=8)


def test_prefill_checks_the_left_pad_once(monkeypatch):
    """The pad mask's first real key per row is computed and checked once
    per prefill and handed to every attention layer."""
    from repro_torch.arch import model as model_mod
    _, cfg = _cfgs("qwen3-4b")
    model = build_model(cfg)
    assert cfg.num_layers > 1
    calls = []
    real = model_mod.left_pad_starts
    monkeypatch.setattr(model_mod, "left_pad_starts",
                        lambda v: calls.append(v) or real(v))
    toks = torch.zeros((2, 6), dtype=torch.long)
    valid = torch.arange(6)[None, :] >= torch.tensor([[0], [2]])
    with_start, _, _ = model.prefill({"tokens": toks, "valid": valid},
                                     cache_len=8)
    assert len(calls) == 1
    monkeypatch.setattr(model_mod, "left_pad_starts", lambda v: None)
    per_layer, _, _ = model.prefill({"tokens": toks, "valid": valid},
                                    cache_len=8)
    torch.testing.assert_close(with_start, per_layer, rtol=0, atol=0)


def test_unported_paths_raise():
    """What stays unported is refused by name: MLA (minicpm3), Mamba
    (jamba), Whisper (``get_arch_config`` has no config for them,
    ROADMAP A.12), expert parallelism (A.13), cross-attention and
    M-RoPE."""
    for arch in ("minicpm3-4b", "jamba-1.5-large-398b", "whisper-base"):
        with pytest.raises(NotImplementedError, match="A.12"):
            get_arch_config(arch)
    moe_cfg = get_arch_config("mixtral-8x7b").reduced().replace(
        dtype="float32")
    with pytest.raises(NotImplementedError, match="A.13"):
        build_model(moe_cfg, moe_impl="ep").prefill(
            {"tokens": torch.zeros((1, 3), dtype=torch.long)}, cache_len=4)
    cfg = get_arch_config("qwen3-4b").reduced().replace(dtype="float32")
    p = build_model(cfg).blocks[0]["attn"]
    x = torch.zeros((1, 2, cfg.d_model))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        attention_apply(p, x, kv_x=x, **kw)
    with pytest.raises(NotImplementedError, match="M-RoPE"):
        attention_apply(p, x, mrope_positions=torch.zeros((3, 1, 2)), **kw)


def test_serve_cli_defaults_to_mixtral_as_the_reference(capsys):
    """``--arch`` defaults to mixtral-8x7b, as ``repro/launch/serve.py``'s
    does: the reduced model, rolling, on the CPU."""
    assert serve.main(["--device", "cpu", "--requests", "2", "--batch",
                       "2", "--new-tokens", "2", "--prompt-len", "8"]) == 0
    assert "[cpu] mixtral-8x7b (2 layers" in capsys.readouterr().out


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", "qwen3-4b", "--device", "cpu",
                       "--requests", "2", "--batch", "2", "--new-tokens",
                       "2", "--prompt-len", "8"]) == 0
    assert "[cpu] qwen3-4b (2 layers" in capsys.readouterr().out
