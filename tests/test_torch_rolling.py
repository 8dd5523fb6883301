"""The port's rolling sliding-window cache against the JAX package's.

Reduced Mixtral (2 layers, d 256, 4 experts top-2) in float32 with
windows 8 and 16, the JAX model's params loaded into the port through
``lm_params_from_jax``, both models rolling (O(window) cache slots):

- prefill of prompts shorter and longer than the window, then decode
  across the wrap: logits, the cache's K, V and slot positions ``pos``
  within rtol 1e-4 / atol 1e-5 of the reference's (prefill goes through
  the ``flash_attention`` kernel's plain version on the CPU, the
  reference through ``_sdpa``);
- a left-padded batch, as the server feeds it (per-row positions and
  the pad mask through prefill and decode);
- decode from an empty cache, token by token (the reference's contract
  test, ``tests/test_arch_consistency.py:102``), and the port's rolling
  cache against its full cache within the reference's 2e-3;
- ``DecodeGraph``'s (B, cache_len) mask, True past the prompt, gives the
  bias of the reference's (B, P) mask, and its rounds eager decode's bits;
- a rolling prefill at ``cache_index`` 5 (attention within the new tokens
  only, as the reference's) against the reference's ``attention_apply``.

The tests marked ``cuda`` hold the card's rolling decode, its window
prefill through the kernel, and its captured rounds to the CPU's:

    python -m pytest -m cuda tests/test_torch_rolling.py
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.arch import build_model as jax_build_model
    from repro.config import get_arch_config as jax_arch_config
    from repro.nn import attention as jattn
except ImportError:      # a machine without the JAX package: only the
    jax = None           # card-side tests below can run there

from repro_torch.arch import build_model
from repro_torch.config import get_arch_config
from repro_torch.launch import serve
from repro_torch.nn import attention
from repro_torch.weights import lm_params_from_jax

RTOL, ATOL = 1e-4, 1e-5
ARCH = "mixtral-8x7b"
WINDOWS = [8, 16]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfg(window):
    return get_arch_config(ARCH).reduced().replace(dtype="float32",
                                                    sliding_window=window)


@pytest.fixture(scope="module", params=WINDOWS)
def pair(request):
    """(window, JAX rolling model, its params, port rolling model with
    those params)."""
    if jax is None:
        pytest.skip("the JAX package (the oracle) is not installed")
    W = request.param
    jcfg = jax_arch_config(ARCH).reduced().replace(dtype="float32",
                                                   sliding_window=W)
    jm = jax_build_model(jcfg, remat=False, rolling_window_decode=True)
    params = jm.init(jax.random.PRNGKey(1))
    cfg = _cfg(W)
    model = build_model(cfg, rolling_window_decode=True)
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return W, jm, params, model


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_caches(pc, jc, what, valid_slots=None):
    """Each layer's K, V (on the slots ``valid_slots`` (B, W) marks, all
    when None) and its slot positions ``pos``."""
    for layer, c in enumerate(pc):
        np.testing.assert_array_equal(c["pos"].numpy(),
                                      np.asarray(jc[0]["pos"][layer]),
                                      err_msg=f"{what}: layer {layer} pos")
        for key in ("k", "v"):
            got = c[key].numpy()
            want = np.asarray(jc[0][key][layer])
            if valid_slots is not None:
                got, want = got[valid_slots], want[valid_slots]
            _close(got, want, f"{what}: layer {layer} {key}")


@pytest.mark.parametrize("prompt", ["short", "long"])
def test_rolling_prefill_and_decode_match_jax(pair, prompt):
    W, jm, params, model = pair
    B = 2
    P = W // 2 + 1 if prompt == "short" else 2 * W + 4
    N = W + 3                              # decode crosses the wrap
    toks = _tokens(model.cfg, B, P + N, seed=W + P)
    jl, jc, jidx = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P])},
                              cache_len=P + N)
    pl, pc, idx = model.prefill({"tokens": torch.from_numpy(toks[:, :P])
                                 .long()}, cache_len=P + N)
    assert pc[0]["k"].shape[1] == min(W, P + N)
    _close(pl, jl, f"W {W} P {P}: prefill logits")
    _close_caches(pc, jc, f"W {W} P {P} prefill")
    for t in range(P, P + N):
        jl, jc, jidx = jm.decode_step(
            params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc, jidx)
        pl, pc, idx = model.decode_step(
            {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, pc, idx)
        _close(pl, jl, f"W {W} P {P}: decode step {t - P}")
    assert idx == int(jidx) == P + N
    _close_caches(pc, jc, f"W {W} P {P} after decode")


def _left_padded(cfg, lengths, seed=2):
    P = max(lengths)
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), P), np.int32)
    for i, n in enumerate(lengths):
        toks[i, P - n:] = rng.integers(0, cfg.vocab_size, n)
    pads = np.array([P - n for n in lengths])
    valid = np.arange(P)[None, :] >= pads[:, None]
    positions = np.maximum(np.arange(P)[None] - pads[:, None], 0).astype(
        np.int32)
    return toks, pads, valid, positions


def test_left_padded_rolling_batch_matches_jax(pair):
    """Prompts of 2W+3, 5 and W+1 tokens left-padded into one batch: the
    prefill keeps the last W slots (the longest prompt's pad has left
    them, the others' pads are in them and masked through ``pos``), then
    decode across the wrap; the logits match the reference's."""
    W, jm, params, model = pair
    toks, pads, valid, positions = _left_padded(model.cfg,
                                                (2 * W + 3, 5, W + 1))
    P, N = toks.shape[1], W + 2
    jl, jc, jidx = jm.prefill(
        params, {"tokens": jnp.asarray(toks), "valid": jnp.asarray(valid),
                 "positions": jnp.asarray(positions)}, cache_len=P + N)
    pl, pc, idx = model.prefill(
        {"tokens": torch.from_numpy(toks).long(),
         "valid": torch.from_numpy(valid),
         "positions": torch.from_numpy(positions)}, cache_len=P + N)
    _close(pl, jl, f"W {W}: left-padded prefill logits")
    cur = np.array(jnp.argmax(jl[:, -1], -1))
    for step in range(N):
        spos = (P + step - pads)[:, None].astype(np.int32)
        jl, jc, jidx = jm.decode_step(
            params, {"tokens": jnp.asarray(cur[:, None]),
                     "valid": jnp.asarray(valid),
                     "positions": jnp.asarray(spos)}, jc, jidx)
        pl, pc, idx = model.decode_step(
            {"tokens": torch.from_numpy(cur[:, None]).long(),
             "valid": torch.from_numpy(valid),
             "positions": torch.from_numpy(spos)}, pc, idx)
        _close(pl, jl, f"W {W}: left-padded decode step {step}")
        cur = np.array(jnp.argmax(jl[:, -1], -1))
    # the real slots hold the reference's K and V; pad slots (whose
    # rows the kernel leaves at 0, ROADMAP C.8) are masked, not compared
    pos = pc[0]["pos"].numpy()
    real = (pos >= P) | valid[:, np.clip(pos, 0, P - 1)]
    _close_caches(pc, jc, f"W {W} left-padded", valid_slots=real)


def test_decode_from_an_empty_cache_matches_jax(pair):
    """The reference's contract test's run: token by token from an empty
    rolling cache, 2W + 4 steps (the slots wrap twice), no prefill."""
    W, jm, params, model = pair
    B, S = 2, 2 * W + 4
    toks = _tokens(model.cfg, B, S, seed=5)
    jc = jm.init_cache(B, S)
    pc = model.init_cache(B, S)
    jidx, idx = jnp.zeros((), jnp.int32), 0
    for t in range(S):
        jl, jc, jidx = jm.decode_step(
            params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jc, jidx)
        pl, pc, idx = model.decode_step(
            {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()}, pc, idx)
        _close(pl, jl, f"W {W}: decode from empty, step {t}")
    _close_caches(pc, jc, f"W {W} from empty")


def _full_and_rolling(cfg, seed=1):
    """Two port models on the same weights: full cache, rolling cache."""
    full = build_model(cfg, torch.Generator().manual_seed(seed))
    roll = build_model(cfg, torch.Generator().manual_seed(seed),
                       rolling_window_decode=True)
    roll.load_state_dict(full.state_dict())
    return full, roll


@pytest.mark.parametrize("W", WINDOWS)
def test_rolling_matches_the_full_cache_in_the_port(W):
    """The reference's two contract tests in the port, at their bound
    2e-3: prefill of a prompt longer than the window then decode
    (``tests/test_serving_extensions.py:11``), and decode from an empty
    cache (``tests/test_arch_consistency.py:102``)."""
    cfg = _cfg(W)
    full, roll = _full_and_rolling(cfg)
    B, P, N = 2, 2 * W + 4, 6
    toks = torch.from_numpy(_tokens(cfg, B, P + N, seed=W)).long()
    outs = {}
    for name, model in (("full", full), ("rolling", roll)):
        lo, caches, idx = model.prefill({"tokens": toks[:, :P]},
                                        cache_len=P + N)
        run = [lo]
        for t in range(P, P + N):
            lo, caches, idx = model.decode_step({"tokens": toks[:, t:t + 1]},
                                                caches, idx)
            run.append(lo)
        caches = model.init_cache(B, P + N)
        idx = 0
        for t in range(P + N):
            lo, caches, idx = model.decode_step({"tokens": toks[:, t:t + 1]},
                                                caches, idx)
            run.append(lo)
        outs[name] = torch.cat(run, 1)
    err = float((outs["full"] - outs["rolling"]).abs().max())
    assert err < 2e-3, err


def test_decode_graph_mask_gives_the_references_bias():
    """A decode step's bias over the rolling slots from the prompt's (B,
    P) pad mask (the reference's decode input) and from ``DecodeGraph``'s
    (B, cache_len) mask, True past the prompt, is the same tensor: the
    slots' positions map through ``pos < P`` either way. Checked at every
    step of a decode across the wrap."""
    W = 8
    cfg = _cfg(W)
    model = build_model(cfg, rolling_window_decode=True)
    toks, pads, valid, positions = _left_padded(cfg, (2 * W + 3, 5, W + 1))
    P, N = toks.shape[1], 2 * W
    cache_len = P + N
    valid = torch.from_numpy(valid)
    wide = torch.ones((3, cache_len), dtype=torch.bool)
    wide[:, :P] = valid
    _, caches, idx = model.prefill(
        {"tokens": torch.from_numpy(toks).long(), "valid": valid,
         "positions": torch.from_numpy(positions)}, cache_len=cache_len)
    c = caches[0]
    kv = torch.zeros((3, 1) + tuple(c["k"].shape[2:]))
    masked = []
    for step in range(N):
        a = {k: v.clone() for k, v in c.items()}
        b = {k: v.clone() for k, v in c.items()}
        ba = attention._rolling_decode_bias(kv, kv, a, idx + step, W, valid)
        bb = attention._rolling_decode_bias(kv, kv, b,
                                            torch.tensor(idx + step), W,
                                            wide)
        assert torch.equal(ba, bb), step
        assert torch.equal(a["pos"], b["pos"])
        masked.append(bool((ba != 0).any()))
        c = a
    # a slot holds a pad position at the first step, none at the last
    assert masked[0] and not masked[-1]


@pytest.mark.parametrize("W", WINDOWS)
def test_decode_graph_rounds_are_eager_rolling_decode(W):
    """``DecodeGraph``'s rounds (eager on the CPU) over its fixed rolling
    buffers give eager decode's logits and tokens bit for bit, for two
    batches in turn, each decoding across the wrap."""
    cfg = _cfg(W)
    model = build_model(cfg, rolling_window_decode=True)
    cache_len = 3 * W + 6
    graph = serve.DecodeGraph(model, 3, cache_len)
    assert graph.static["caches"][0]["pos"].shape == (W,)
    for lengths in ((W + 3, 4, 2 * W), (5, 2 * W + 1, 7)):
        toks, pads, valid, positions = _left_padded(cfg, lengths,
                                                    seed=len(lengths))
        batch = {"tokens": torch.from_numpy(toks).long(),
                 "valid": torch.from_numpy(valid),
                 "positions": torch.from_numpy(positions)}
        pads = torch.from_numpy(pads)
        logits, caches, idx = model.prefill(batch, cache_len=cache_len)
        cur = logits[:, -1].argmax(-1)
        graph.start(caches, batch["valid"])
        logits, caches, idx = model.prefill(batch, cache_len=cache_len)
        gcur, gidx = cur, idx
        for _ in range(W + 2):
            pos = (idx - pads)[:, None].to(torch.int32)
            logits, caches, idx = model.decode_step(
                {"tokens": cur[:, None], "valid": batch["valid"],
                 "positions": pos}, caches, idx)
            cur = logits[:, -1].argmax(-1)
            glog, gcur = graph(gcur[:, None],
                               (gidx - pads)[:, None].to(torch.int32), gidx)
            gidx += 1
            assert torch.equal(logits, glog) and torch.equal(cur, gcur)
        assert torch.equal(graph.static["caches"][1]["pos"],
                           caches[1]["pos"])
    assert graph.captures == 0


@pytest.mark.parametrize("Sq", [6, 12])
@pytest.mark.parametrize("padded", [False, True])
def test_rolling_prefill_at_a_nonzero_cache_index_matches_jax(Sq, padded):
    """``attention_apply`` on a rolling cache of 8 slots that already
    holds positions 0..4, prefilling Sq tokens at ``cache_index`` 5: the
    reference attends within the new tokens only and stores the last
    ``min(8, Sq)``; so must the port. With a left pad, the rows that see
    no key are left out of the comparison (ROADMAP C.8)."""
    if jax is None:
        pytest.skip("the JAX package (the oracle) is not installed")
    W, idx, D, H, Hkv, hd = 8, 5, 64, 4, 2, 16
    rng = np.random.default_rng(Sq + 10 * padded)
    jp = jattn.attention_init(jax.random.PRNGKey(3), D, H, Hkv, hd,
                              jnp.float32, qk_norm=True)
    tp = {k: torch.from_numpy(np.asarray(v).copy()) if k not in
          ("q_norm", "k_norm") else {"scale": torch.from_numpy(
              np.asarray(v["scale"]).copy())} for k, v in jp.items()}
    x = rng.normal(size=(2, Sq, D)).astype(np.float32)
    pos = np.full(W, -1, np.int32)
    pos[:idx] = np.arange(idx)
    ck = rng.normal(size=(2, W, Hkv, hd)).astype(np.float32)
    cv = rng.normal(size=(2, W, Hkv, hd)).astype(np.float32)
    positions = (idx + np.arange(Sq, dtype=np.int32))[None]
    valid = None
    if padded:
        valid = np.ones((2, Sq), bool)
        valid[1, :3] = False
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=hd, rope_theta=1e4,
              qk_norm=True, sliding_window=W)
    jout, jc = jattn.attention_apply(
        jp, jnp.asarray(x), positions=jnp.asarray(positions),
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
               "pos": jnp.asarray(pos)},
        cache_index=jnp.asarray(idx, jnp.int32),
        valid=None if valid is None else jnp.asarray(valid), **kw)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(
        cv.copy()), "pos": torch.from_numpy(pos.copy())}
    tout, tc = attention.attention_apply(
        tp, torch.from_numpy(x), positions=torch.from_numpy(positions),
        cache=cache, cache_index=idx,
        valid=None if valid is None else torch.from_numpy(valid), **kw)
    rows = np.ones((2, Sq), bool) if valid is None else valid
    _close(tout.numpy()[rows], np.asarray(jout)[rows], "output")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["k"], jc["k"], "cache k")
    _close(tc["v"], jc["v"], "cache v")


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _served(model, lengths, new, cache_len, seed=3):
    """Left-padded prefill then ``new`` greedy decode steps: every step's
    logits (float32, on the CPU) and the fed tokens."""
    toks, pads, valid, positions = _left_padded(model.cfg, lengths, seed)
    dev = model.device
    batch = {"tokens": torch.from_numpy(toks).long().to(dev),
             "valid": torch.from_numpy(valid).to(dev),
             "positions": torch.from_numpy(positions).to(dev)}
    logits, caches, idx = model.prefill(batch, cache_len=cache_len)
    out = [logits.float().cpu()]
    pads = torch.from_numpy(pads).to(dev)
    for _ in range(new):
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, caches, idx = model.decode_step(
            {"tokens": tok, "valid": batch["valid"],
             "positions": (idx - pads)[:, None].to(torch.int32)}, caches, idx)
        out.append(logits.float().cpu())
    return torch.cat(out, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("W", WINDOWS)
def test_cuda_rolling_serving_matches_the_cpu(W, cuda):
    """Reduced Mixtral, float32, rolling: the card (the window prefill
    through the ``flash_attention`` kernel, one launch a layer) against
    the CPU on the same weights, decode across the wrap, within 1e-4 of
    max|logit|; and the card's rolling cache against its full cache."""
    from repro_torch.kernels import ops
    cfg = _cfg(W)
    full, cpu = _full_and_rolling(cfg)
    lengths, new = (2 * W + 3, 5, W + 1), W + 4
    cache_len = 2 * W + 3 + new
    want = _served(cpu, lengths, new, cache_len)
    card = cpu.to(cuda)
    before = ops.launches["flash_attention"]
    got = _served(card, lengths, new, cache_len)
    assert ops.launches["flash_attention"] == before + cfg.num_layers
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    got_full = _served(full.to(cuda), lengths, new, cache_len)
    assert float((got_full - got).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_rolling_decode_captured_once_replays_eager(cuda, monkeypatch):
    """The reduced Mixtral server with window 8 on the card: the captured
    rolling decode round gives eager decode's tokens and logits bit for
    bit across the wrap, one capture for two batches."""
    from repro_torch.launch.serve import BatchServer, Request
    monkeypatch.setattr(serve, "get_arch_config", lambda arch: (
        get_arch_config(arch).replace(sliding_window=8)))
    runs = {}
    for graphs in (False, True):
        srv = BatchServer(ARCH, batch_size=2, cache_len=40, seed=0,
                          device=cuda, cuda_graphs=graphs)
        assert srv.cfg.sliding_window == 8
        srv.round_logits = []
        prompts = [np.random.default_rng(n).integers(0, 1024, n)
                   .astype(np.int32) for n in (19, 4, 3, 12)]
        reqs = [Request(i, p, 12) for i, p in enumerate(prompts)]
        srv.run(reqs[:2])
        srv.run(reqs[2:])
        srv.assert_compiled_per_bucket()
        runs[graphs] = ([r.out for r in reqs], srv.round_logits, srv)
    assert runs[True][2].captures == {(2, 40): 1}
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
