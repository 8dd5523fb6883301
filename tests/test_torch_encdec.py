"""Whisper's and Qwen2-VL's building blocks in the port against the JAX
package's, on the CPU, in float32 within rtol 1e-4 / atol 1e-5:
LayerNorm and the GELU MLP (the tanh form, as ``jax.nn.gelu``'s
default), M-RoPE over three distinct position streams at head dims 32,
64 and 128, cross-attention over an encoder memory, and the encoder
itself, served (the kernel's plain version with ``causal=False``) and
trained (``_sdpa``). A Whisper decode step reads the carried encoder
memory and gives the recomputed one's logits, as the reference's
``test_whisper_decode_uses_cached_encoder_memory``. The forward-only
kernels refuse to be recorded by autograd.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import build_model as jax_build_model  # noqa: E402
from repro.config import get_arch_config as jax_arch_config  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402

from repro_torch.arch import build_model  # noqa: E402
from repro_torch.config import get_arch_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn import attention, layers  # noqa: E402
from repro_torch.weights import lm_params_from_jax  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 7, 96, scale=3.0) + 1.5
    p = {"scale": _normal(rng, 96) + 1.0, "bias": _normal(rng, 96)}
    want = jlayers.layernorm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), 1e-5)
    got = layers.layernorm_apply({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x), 1e-5)
    _close(got, want, "layernorm")
    # bf16 in, statistics in float32, one rounding back to bf16
    want = jlayers.layernorm_apply(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(x, jnp.bfloat16), 1e-5)
    got = layers.layernorm_apply(
        {k: torch.from_numpy(v).bfloat16() for k, v in p.items()},
        torch.from_numpy(x).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_gelu_mlp_matches_jax_tanh_form():
    rng = np.random.default_rng(1)
    D, F = 48, 96
    p = {"wi": {"w": _normal(rng, D, F, scale=D ** -0.5),
                "b": _normal(rng, F, scale=0.1)},
         "wo": {"w": _normal(rng, F, D, scale=F ** -0.5),
                "b": _normal(rng, D, scale=0.1)}}
    x = _normal(rng, 3, 5, D, scale=2.0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    want = jlayers.gelu_mlp_apply(jp, jnp.asarray(x))
    _close(layers.gelu_mlp_apply(tp, torch.from_numpy(x)), want, "gelu mlp")
    # the erf form parts from the reference by more than the tolerance
    h = layers.dense_apply(tp["wi"], torch.from_numpy(x))
    exact = layers.dense_apply(tp["wo"], torch.nn.functional.gelu(h))
    assert not np.allclose(exact.numpy(), np.asarray(want), rtol=RTOL,
                           atol=ATOL)
    # init: the reference's names and shapes, biases zero
    init = layers.gelu_mlp_init(torch.Generator().manual_seed(0), D, F)
    jinit = jlayers.gelu_mlp_init(jax.random.PRNGKey(0), D, F)
    for k in ("wi", "wo"):
        for kk in ("w", "b"):
            assert tuple(init[k][kk].shape) == jinit[k][kk].shape
    assert not init["wi"]["b"].any()


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_mrope_matches_jax_with_distinct_streams(hd):
    rng = np.random.default_rng(hd)
    B, S, H = 2, 9, 3
    x = _normal(rng, B, S, H, hd)
    pos = np.stack([rng.integers(0, 50, (B, S)) for _ in range(3)]).astype(
        np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    for theta in (10000.0, 1e6):
        want = jattn.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = attention.apply_mrope(torch.from_numpy(x),
                                    torch.from_numpy(pos), theta)
        _close(got, want, f"mrope hd {hd} theta {theta}")
    # each stream rotates its own section: moving one stream moves only
    # its section of each half
    half = hd // 2
    s0, s1 = int(round(0.25 * half)), int(round(0.375 * half))
    base = attention.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos))
    for i, (lo, hi) in enumerate(((0, s0), (s0, s0 + s1),
                                  (s0 + s1, half))):
        moved = pos.copy()
        moved[i] += 7
        out = attention.apply_mrope(torch.from_numpy(x),
                                    torch.from_numpy(moved))
        changed = (out != base).any(0).any(0).any(0).numpy()
        want_changed = np.zeros(hd, bool)
        want_changed[lo:hi] = want_changed[half + lo:half + hi] = True
        assert (changed == want_changed).all(), (hd, i)


def _attn_params(rng, D, Hq, Hkv, hd):
    return {"wq": _normal(rng, D, Hq * hd, scale=D ** -0.5),
            "wk": _normal(rng, D, Hkv * hd, scale=D ** -0.5),
            "wv": _normal(rng, D, Hkv * hd, scale=D ** -0.5),
            "wo": _normal(rng, Hq * hd, D, scale=(Hq * hd) ** -0.5)}


@pytest.mark.parametrize("heads", [(4, 4), (6, 2)])
def test_cross_attention_matches_jax(heads):
    """Queries from the decoder's 5 tokens, K/V from 23 encoder frames: no
    RoPE on q or k (positions are ignored), no mask, no cache."""
    Hq, Hkv = heads
    rng = np.random.default_rng(Hq)
    D, hd = 32, 16
    p = _attn_params(rng, D, Hq, Hkv, hd)
    x, mem = _normal(rng, 2, 5, D), _normal(rng, 2, 23, D)
    kw = dict(num_heads=Hq, num_kv_heads=Hkv, head_dim=hd, causal=False)
    want = jattn.attention_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), kv_x=jnp.asarray(mem), **kw)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = attention.attention_apply(tp, torch.from_numpy(x),
                                    kv_x=torch.from_numpy(mem), **kw)
    _close(got, want, "cross-attention")
    shifted = attention.attention_apply(
        tp, torch.from_numpy(x), kv_x=torch.from_numpy(mem),
        positions=torch.arange(5)[None] + 11, **kw)
    torch.testing.assert_close(shifted, got, rtol=0, atol=0)


@pytest.fixture(scope="module")
def whisper():
    """(JAX model, JAX params, port model with those params), reduced
    Whisper-base in float32."""
    jcfg = jax_arch_config("whisper-base").reduced().replace(dtype="float32")
    cfg = get_arch_config("whisper-base").reduced().replace(dtype="float32")
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jm, params, model.requires_grad_(False)


def test_encoder_matches_jax_served_and_trained(whisper):
    """The bidirectional encoder (RoPE at positions 0..T-1, no causal
    mask, then ``enc_norm``): served through the kernel's plain version,
    and on the training path through ``_sdpa``, both the reference's."""
    jm, params, model = whisper
    cfg = model.cfg
    frames = _normal(np.random.default_rng(3), 2, cfg.encoder_seq,
                     cfg.d_model)
    want = jm._encoder(params, jnp.asarray(frames))
    ops.reset_launches()
    _close(model.encode(torch.from_numpy(frames)), want, "encoder, served")
    _close(model._encoder(torch.from_numpy(frames), train=True), want,
           "encoder, trained")
    assert not any(ops.launches.values())       # the CPU launches nothing


def test_encoder_takes_the_kernel_bidirectionally(whisper, monkeypatch):
    """Served, every encoder layer calls ``flash_attention_op`` once with
    ``causal=False`` over all T frames; trained, none does."""
    _, _, model = whisper
    calls = []
    real = ops.flash_attention_op

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention_op", spy)
    cfg = model.cfg
    frames = torch.zeros((2, cfg.encoder_seq, cfg.d_model))
    model.encode(frames)
    shape = (2, cfg.encoder_seq, cfg.num_heads, cfg.resolved_head_dim)
    assert calls == [(shape, False)] * cfg.encoder_layers
    calls.clear()
    model._encoder(frames, train=True)
    assert calls == []


def test_whisper_decode_uses_cached_encoder_memory(whisper):
    """Twin of the reference's test: a decode step that recomputes the
    encoder from the frames and one that reads the carried memory give
    the same logits (and the reference's)."""
    jm, params, model = whisper
    cfg = model.cfg
    rng = np.random.default_rng(0)
    B = 2
    frames = _normal(rng, B, cfg.encoder_seq, cfg.d_model)
    toks = rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    lo, caches, idx = model.prefill(
        {"tokens": torch.from_numpy(toks).long(),
         "enc_frames": torch.from_numpy(frames)}, cache_len=8)
    enc = model.encode(torch.from_numpy(frames))
    step = torch.from_numpy(toks[:, :1]).long()
    a, _, _ = model.decode_step({"tokens": step,
                                 "enc_frames": torch.from_numpy(frames)},
                                [{k: v.clone() for k, v in c.items()}
                                 for c in caches], idx)
    b, _, _ = model.decode_step({"tokens": step, "enc_memory": enc}, caches,
                                idx)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    jl, jc, jidx = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                       "enc_frames": jnp.asarray(frames)},
                              cache_len=8)
    want, _, _ = jm.decode_step(
        params, {"tokens": jnp.asarray(toks[:, :1]),
                 "enc_memory": jm._encoder(params, jnp.asarray(frames))},
        jc, jidx)
    _close(b, want, "decode over the carried memory")
    # the memory given to prefill in place of the frames: the same logits
    lo2, _, _ = model.prefill({"tokens": torch.from_numpy(toks).long(),
                               "enc_memory": enc}, cache_len=8)
    torch.testing.assert_close(lo2, lo, rtol=0, atol=0)


def test_forward_only_kernels_refuse_autograd():
    """``flash_attention_op`` and ``wkv6_op`` raise a ``RuntimeError``
    naming the kernel when autograd would record the call; under
    ``no_grad`` (or on inputs that need no gradient) they run."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 8, 2, 32)) for _ in range(3))
    with pytest.raises(RuntimeError, match="flash_attention.*forward-only"):
        ops.flash_attention_op(q.requires_grad_(), k, v)
    with torch.no_grad():
        ops.flash_attention_op(q, k, v)
    r, kk, vv = (torch.from_numpy(_normal(rng, 1, 4, 2, 32))
                 for _ in range(3))
    w = torch.full((1, 4, 2, 32), 0.9)
    u = torch.zeros((2, 32), requires_grad=True)
    with pytest.raises(RuntimeError, match="wkv6.*forward-only"):
        ops.wkv6_op(r, kk, vv, w, u)
    ops.wkv6_op(r, kk, vv, w, u.detach())
