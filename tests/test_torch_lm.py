"""The port's LM serving path against the JAX package's.

Reduced Qwen3-4B, RWKV-6, Jamba (a group of one GQA layer and one Mamba
layer, MoE on the second), MiniCPM3 (MLA), Whisper (encoder, cross-
attention, LayerNorm/GELU; the encoder runs the kernel's plain version
with ``causal=False``) and Qwen2-VL (embedding inputs, M-RoPE over three
distinct position streams) in float32, with the JAX
model's params loaded into the port through ``lm_params_from_jax``:
prefill logits and caches and 8 decode steps must match the JAX model
within rtol 1e-4 / atol 1e-5 (prefill goes through the kernels' plain
versions on the CPU, the reference through ``_sdpa`` and
``wkv_chunked``; Mamba and MLA are plain products in both); prefill(S/2) plus
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
# the hybrid Mamba/attention/MoE groups (jamba) and latent attention
# (minicpm3)
HYBRID = ["jamba-1.5-large-398b", "minicpm3-4b"]
# and the attention archs that came with the MoE FFN and the rolling
# cache: MoE with a sliding window (mixtral), fine-grained MoE (dbrx),
# dense GQA (phi3, qwen3-32b)
SERVED = ARCHS + HYBRID + ["mixtral-8x7b", "dbrx-132b", "phi3-medium-14b",
                           "qwen3-32b"]
# the encoder-decoder (whisper) and the VLM (qwen2-vl): frames and
# embeddings in, which BatchServer's token requests do not carry
ENCDEC = ["whisper-base", "qwen2-vl-2b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch):
    return (jax_arch_config(arch).reduced().replace(dtype="float32"),
            get_arch_config(arch).reduced().replace(dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS + HYBRID + ENCDEC)
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


def _mrope_of(pos):
    """Three distinct M-RoPE streams (t, h, w) from positions (B, S): with
    equal streams M-RoPE is plain RoPE and a section would not show."""
    return np.stack([pos, pos + pos % 3, pos + 2 * (pos % 5)]).astype(
        np.int32)


def _inputs(cfg, B, S, seed=0):
    """A sequence's inputs as numpy: ``tokens`` (B, S), and what the
    config also takes: ``embeds`` (B, S, D), ``mrope_positions`` (3, B,
    S), ``enc_frames`` (B, encoder_seq, D)."""
    out = {"tokens": _tokens(cfg, B, S, seed)}
    rng = np.random.default_rng(seed + 100)
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope:
        out["mrope_positions"] = _mrope_of(
            np.broadcast_to(np.arange(S)[None], (B, S)))
    if cfg.encoder_layers:
        out["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _span(inp, lo, hi):
    """Positions lo..hi-1 of the inputs (the frames whole)."""
    out = dict(inp)
    for k in ("tokens", "embeds"):
        if k in inp:
            out[k] = inp[k][:, lo:hi]
    if "mrope_positions" in inp:
        out["mrope_positions"] = inp["mrope_positions"][:, :, lo:hi]
    return out


def _jax(inp):
    return {k: jnp.asarray(v) for k, v in inp.items()}


def _torch(inp):
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).long()
                if k == "tokens" else torch.from_numpy(
                    np.ascontiguousarray(v)))
            for k, v in inp.items()}


ENCDEC_FIELDS = ("norm_type", "cross_attention", "encoder_layers",
                 "encoder_seq", "mrope", "embed_inputs")


def test_configs_are_the_references():
    for arch in SERVED + ENCDEC:
        jcfg = jax_arch_config(arch)
        cfg = get_arch_config(arch)
        for field in ("name", "family", "num_layers", "d_model", "num_heads",
                      "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                      "resolved_head_dim", "qk_norm", "sliding_window",
                      "rope_theta", "moe_every", "dtype", "norm_eps",
                      "tie_embeddings", "source") + ENCDEC_FIELDS:
            assert getattr(cfg, field) == getattr(jcfg, field), (arch, field)
        red, jred = cfg.reduced(), jcfg.reduced()
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "head_dim", "d_ff", "vocab_size",
                      "sliding_window") + ENCDEC_FIELDS:
            assert getattr(red, field) == getattr(jred, field), (arch, field)
        assert (cfg.moe is None) == (jcfg.moe is None), arch
        if cfg.moe is not None:
            assert vars(cfg.moe) == vars(jcfg.moe), arch
            assert vars(red.moe) == vars(jred.moe), arch
        assert red.attn_every == jred.attn_every, arch
        assert cfg.attn_every == jcfg.attn_every, arch
        for sub in ("rwkv", "mamba", "mla"):
            mine, ref = getattr(cfg, sub), getattr(jcfg, sub)
            assert (mine is None) == (ref is None), (arch, sub)
            if mine is not None:
                assert vars(mine) == vars(ref), (arch, sub)
                assert vars(getattr(red, sub)) == vars(getattr(jred, sub))
        from repro.arch.model import layer_kinds as jax_layer_kinds
        assert layer_kinds(cfg) == jax_layer_kinds(jcfg), arch
        assert layer_kinds(red) == jax_layer_kinds(jred), arch


def test_prefill_and_decode_match_jax(pair):
    arch, jm, params, model = pair
    cfg = model.cfg
    B, P, N = 2, 16, 8
    inp = _inputs(cfg, B, P + N)
    jl, jc, jidx = jm.prefill(params, _jax(_span(inp, 0, P)),
                              cache_len=P + N)
    pl, pc, idx = model.prefill(_torch(_span(inp, 0, P)), cache_len=P + N)
    _close(pl, jl, f"{arch}: prefill logits")
    assert idx == int(jidx) == P
    _close_caches(pc, jc, f"{arch} prefill")
    for t in range(P, P + N):
        # whisper's decode runs the encoder over the frames again, in
        # both packages
        jl, jc, jidx = jm.decode_step(params, _jax(_span(inp, t, t + 1)),
                                      jc, jidx)
        pl, pc, idx = model.decode_step(_torch(_span(inp, t, t + 1)), pc,
                                        idx)
        _close(pl, jl, f"{arch}: decode step {t - P}")
    _close_caches(pc, jc, f"{arch} decode")


def _close_caches(pc, jc, what):
    """Every cache tensor of the port's layer ``g * len(jc) + s`` against
    index ``g`` of the reference's group slot ``s``: K and V (GQA),
    ``c_kv`` and ``k_rope`` (MLA), ``conv`` and ``state`` (Mamba), RWKV's
    shifts and states."""
    def walk(c, j, g, at):
        for key, v in c.items():
            if isinstance(v, dict):
                walk(v, j[key], g, f"{at} {key}")
            else:
                _close(v, j[key][g], f"{at} {key}")
    for layer, c in enumerate(pc):
        g, s = divmod(layer, len(jc))
        assert set(c) == set(jc[s]), (layer, set(c), set(jc[s]))
        walk(c, jc[s], g, f"{what}: layer {layer}")


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
    """The reference's ``test_decode_matches_prefill`` contract inside the
    port; Whisper's decode steps read the encoder memory that
    ``encode`` made once, Qwen2-VL's their own embeddings and streams."""
    arch, _, _, model = pair
    B, S = 2, 16
    inp = _torch(_inputs(model.cfg, B, S, seed=1))
    full, _, _ = model.prefill(inp, cache_len=S)
    lo, caches, idx = model.prefill(_span(inp, 0, S // 2), cache_len=S)
    if model.cfg.encoder_layers:
        inp = dict(inp, enc_memory=model.encode(inp.pop("enc_frames")))
    for t in range(S // 2, S):
        lo, caches, idx = model.decode_step(_span(inp, t, t + 1), caches,
                                            idx)
    _close(lo, full, f"{arch}: prefill(S/2) + decodes vs prefill(S)")


def _left_padded(cfg, lengths, seed=2):
    """(batch dict, pads) of seeded prompts of ``lengths``, left-padded;
    for Qwen2-VL with embeddings and pad-shifted M-RoPE streams, for
    Whisper with frames."""
    P = max(lengths)
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), P), np.int64)
    for i, n in enumerate(lengths):
        toks[i, P - n:] = rng.integers(0, cfg.vocab_size, n)
    pads = torch.tensor([P - n for n in lengths])
    valid = torch.arange(P)[None, :] >= pads[:, None]
    positions = (torch.arange(P)[None, :] - pads[:, None]).clamp_min(0).to(
        torch.int32)
    batch = {"tokens": torch.from_numpy(toks), "valid": valid,
             "positions": positions}
    if cfg.embed_inputs:
        batch["embeds"] = torch.from_numpy(rng.normal(
            size=(len(lengths), P, cfg.d_model)).astype(np.float32))
    if cfg.mrope:
        batch["mrope_positions"] = torch.from_numpy(
            _mrope_of(positions.numpy()))
    if cfg.encoder_layers:
        batch["enc_frames"] = torch.from_numpy(rng.normal(
            size=(len(lengths), cfg.encoder_seq, cfg.d_model)).astype(
                np.float32))
    return batch, pads


def _step(model, tok, pos, valid, enc=None):
    """A decode step's batch: the token (B, 1) at per-row positions (B,
    1), its embedding through the table and its three streams for
    Qwen2-VL, the carried encoder memory for Whisper."""
    b = {"tokens": tok, "valid": valid, "positions": pos}
    if model.cfg.embed_inputs:
        with torch.no_grad():
            b["embeds"] = model.embed["table"][tok]
    if model.cfg.mrope:
        b["mrope_positions"] = torch.from_numpy(_mrope_of(pos.numpy()))
    if enc is not None:
        b["enc_memory"] = enc
    return b


def _enc(model, batch):
    return (model.encode(batch["enc_frames"]) if model.cfg.encoder_layers
            else None)


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
    enc = _enc(model, batch)
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
                _step(model, tok, pos, batch["valid"], enc), caches, idx)
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
        enc = _enc(model, batch)
        logits, caches, idx = model.prefill(batch, cache_len=cache_len)
        cur = logits[:, -1].argmax(-1)
        graph.start(caches, batch["valid"], enc_memory=enc)
        logits, caches, idx = model.prefill(batch, cache_len=cache_len)
        want, got = [], []
        gcur, gidx = cur, idx
        for _ in range(4):
            pos = (idx - pads)[:, None].to(torch.int32)
            logits, caches, idx = model.decode_step(
                _step(model, cur[:, None], pos, batch["valid"], enc),
                caches, idx)
            cur = logits[:, -1].argmax(-1)
            want.append((logits.clone(), cur))
            gpos = (gidx - pads)[:, None].to(torch.int32)
            extra = _step(model, gcur[:, None], gpos, None)
            glog, gcur = graph(gcur[:, None], gpos, gidx,
                               embeds=extra.get("embeds"),
                               mrope_positions=extra.get("mrope_positions"))
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


def test_batch_server_serves_a_config_as_given():
    """A name goes through ``reduced``; an ``ArchConfig`` is served as it
    is, so a cut (here reduced Jamba's experts cut to 2) is the caller's
    ``cfg.replace``. The same config by name or by value serves the same
    tokens."""
    import dataclasses
    _, red = _cfgs("jamba-1.5-large-398b")
    cut = red.replace(moe=dataclasses.replace(red.moe, num_experts=2))
    assert red.moe.num_experts > 2
    srv = serve.BatchServer(cut, batch_size=1, cache_len=40, device="cpu")
    assert srv.cfg is cut and len(srv.model.blocks) == 2
    assert srv.model.blocks[1]["ffn"]["router"].shape[-1] == 2
    prompt = np.arange(16, dtype=np.int32)
    outs = []
    for arch in ("jamba-1.5-large-398b", red):
        s = serve.BatchServer(arch, batch_size=1, cache_len=40,
                              device="cpu", seed=4)
        assert s.cfg == red
        r = serve.Request(0, prompt, 3)
        s.run([r])
        outs.append(r.out)
    assert outs[0] == outs[1] and len(outs[0]) == 3


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
    """``moe_impl="ep"`` without a mesh runs dense dispatch, bit for bit,
    as the reference's ``_ffn_apply`` does (ROADMAP A.13's refusal went
    with the port of ``moe_ffn_ep``). Whisper
    and Qwen2-VL, and a LayerNorm config, build (A.12a lifted their
    refusals); ``BatchServer`` refuses configs with embedding inputs or
    an encoder by name, since its requests carry tokens only, as the
    reference's do."""
    for arch in ENCDEC:
        cfg = get_arch_config(arch).reduced().replace(dtype="float32")
        model = build_model(cfg)
        assert ("encoder" in dict(model.named_children())) == (
            arch == "whisper-base")
        with pytest.raises(ValueError, match=f"{arch}.*embedding inputs "
                           "or an encoder"):
            serve.BatchServer(arch, batch_size=1, cache_len=8, device="cpu")
    moe_cfg = get_arch_config("mixtral-8x7b").reduced().replace(
        dtype="float32")
    dense = build_model(moe_cfg)
    ep = build_model(moe_cfg, moe_impl="ep")
    ep.load_state_dict(dense.state_dict())
    toks = {"tokens": torch.arange(3)[None]}
    assert torch.equal(ep.prefill(toks, cache_len=4)[0],
                       dense.prefill(toks, cache_len=4)[0])
    cfg = get_arch_config("qwen3-4b").reduced().replace(dtype="float32")
    ln = build_model(cfg.replace(norm_type="layernorm"))
    assert "bias" in ln.blocks[0]["norm1"] and "wi" in ln.blocks[0]["ffn"]
    with pytest.raises(ValueError, match="unknown architecture"):
        get_arch_config("no-such-arch")
    p = build_model(cfg).blocks[0]["attn"]
    x = torch.zeros((1, 2, cfg.d_model))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim)
    with pytest.raises(ValueError, match="cross-attention takes no cache"):
        attention_apply(p, x, kv_x=x, cache={}, **kw)


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


@pytest.mark.parametrize("arch", HYBRID)
def test_serve_cli_runs_the_hybrid_archs_on_the_cpu(arch, capsys):
    """Jamba and MiniCPM3 through the CLI, reduced: Jamba's prompts at or
    past its chunk (16) are cut to whole chunks, so every batch's padded
    length is at most one chunk or a multiple of it."""
    assert serve.main(["--arch", arch, "--device", "cpu", "--requests",
                       "4", "--batch", "2", "--new-tokens", "2",
                       "--prompt-len", "40", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert f"[cpu] {arch} (2 layers" in out
    if arch.startswith("jamba"):
        lens = [int(line.split("prompt[")[1].split("]")[0])
                for line in out.splitlines() if "prompt[" in line]
        assert lens and all(n < 16 or n % 16 == 0 for n in lens), lens


def test_jamba_moe_interleave():
    """Twin of the reference's ``test_jamba_moe_interleave`` for the
    published layout, without building the 398B model: 9 attention and
    63 Mamba layers in groups of 8, MoE on every second layer (slot 1 of
    a group, not slot 0). The layout is built in the port at toy widths
    (72 layers, d 32); the reference's params of two such groups load
    into the port by name and shape; the reduced model's group is [attn,
    mamba] with MoE on the Mamba slot only."""
    cfg = get_arch_config("jamba-1.5-large-398b")
    assert cfg.moe_every == 2 and cfg.attn_every == 8
    kinds = layer_kinds(cfg)
    assert kinds.count("attn") == 9 and kinds.count("mamba") == 63
    toy = dict(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
               d_ff=16, vocab_size=32, dtype="float32")
    import dataclasses
    tcfg = cfg.replace(mamba=dataclasses.replace(cfg.mamba, head_dim=16,
                                                 d_state=4, chunk=8),
                       moe=dataclasses.replace(cfg.moe, num_experts=2),
                       **toy)
    model = build_model(tcfg)
    assert model._group_structure() == (["attn"] + ["mamba"] * 7, 9)
    assert len(model.blocks) == 72
    for i, b in enumerate(model.blocks):
        assert ("attn" in b) == (i % 8 == 0) and ("mixer" in b) == (
            i % 8 != 0), i
        assert ("router" in b["ffn"]) == (i % 2 == 1), i
    jcfg = jax_arch_config("jamba-1.5-large-398b")
    jtoy = jcfg.replace(mamba=dataclasses.replace(jcfg.mamba, head_dim=16,
                                                  d_state=4, chunk=8),
                        moe=dataclasses.replace(jcfg.moe, num_experts=2),
                        num_layers=16, **toy)
    jparams = jax_build_model(jtoy, remat=False).init(jax.random.PRNGKey(0))
    assert ["router" in b["ffn"] for b in jparams["blocks"]] == [
        s % 2 == 1 for s in range(8)]
    two = tcfg.replace(num_layers=16)
    build_model(two).load_state_dict(lm_params_from_jax(
        two, jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    red = build_model(cfg.reduced().replace(dtype="float32"))
    assert "router" not in red.blocks[0]["ffn"]
    assert "router" in red.blocks[1]["ffn"]
    # the reference's refusals: layers not a whole number of groups, and
    # a group size that moe_every does not divide
    with pytest.raises(ValueError, match="attn_every"):
        build_model(tcfg.replace(num_layers=12))
    with pytest.raises(ValueError, match="moe_every"):
        build_model(cfg.reduced().replace(dtype="float32", moe_every=3))


def test_jamba_server_over_two_chunks_matches_jax():
    """Reduced Jamba (chunk 16) served by both servers on one left-padded
    batch two chunks long (prompts of 32, 19 and 5 tokens): the same
    greedy tokens for every request. ``valid`` never reaches the Mamba
    mixer in either package, so a short prompt's left pads enter its
    state (ROADMAP C.11): batched behind 27 pads, its Mamba state parts
    from its solo prefill's by more than a tenth of max|S|, and its
    logits by more than 1e-5 of max|logit| (a GQA model's batched and
    solo logits part by under 1e-6 here)."""
    arch = "jamba-1.5-large-398b"
    jsrv = JaxBatchServer(arch, batch_size=3, cache_len=40, reduced=True,
                          rolling=False)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jsrv.cfg.vocab_size, n).astype(np.int32)
               for n in (32, 19, 5)]
    jreqs = [JaxRequest(i, p, 5) for i, p in enumerate(prompts)]
    jsrv.run(jreqs)
    cfg = get_arch_config(arch).reduced().replace(dtype="float32")
    sd = lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                        jsrv.params))
    srv = serve.BatchServer(arch, batch_size=3, cache_len=40,
                            device="cpu", state_dict=sd)
    reqs = [serve.Request(i, p, 5) for i, p in enumerate(prompts)]
    srv.run(reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    # C.11: the 5-token prompt, batched behind 27 pads, against solo
    batch, _ = _left_padded(cfg, (32, 19, 5), seed=9)
    batched, bc, _ = srv.model.prefill(batch, cache_len=40)
    solo, sc, _ = srv.model.prefill(
        {"tokens": batch["tokens"][2:, -5:]}, cache_len=40)
    state_gap = _rel(bc[1]["state"][2], sc[1]["state"][0])
    logit_gap = _rel(batched[2], solo[0])
    assert state_gap > 0.1 and logit_gap > 1e-5, (state_gap, logit_gap)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())
