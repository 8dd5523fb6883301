"""The port's multi-head latent attention (``repro_torch/nn/attention.py``
``mla_apply``) against the JAX package's (``repro/nn/attention.py``).

Seeded float32 weights (the reference's ``mla_init``) at the reduced
MiniCPM3's widths (4 heads, q/kv ranks 64/32, nope/rope/v 16/16/16):

- the decompressed path (no cache, what ``loss`` will use) against the
  reference's, with RoPE positions;
- the absorbed path (a cache): a left-padded prefill at slot 0 over all
  ``cache_len`` slots, as the model's prefill runs it, then decode
  steps; outputs and the compressed cache within rtol 1e-4 / atol 1e-5;
- twin of the reference's ``test_mla_absorbed_decode_equals_prefill``
  (1e-4);
- decode at a 0-d tensor index gives the int index's bits.

The tests marked ``cuda`` hold the card's two paths to the CPU's:

    python -m pytest -m cuda tests/test_torch_mla.py
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.config import MLAConfig as JaxMLAConfig
    from repro.nn import attention as jattn
except ImportError:      # a machine without the JAX package: only the
    jattn = None         # card-side tests below can run there

from repro_torch.config import MLAConfig, get_arch_config
from repro_torch.nn import attention

RTOL, ATOL = 1e-4, 1e-5
CFG = get_arch_config("minicpm3-4b").reduced().replace(dtype="float32")
MLA, H, D = CFG.mla, CFG.num_heads, CFG.d_model
KW = dict(num_heads=H, mla=MLA, rope_theta=CFG.rope_theta,
          norm_eps=CFG.norm_eps)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def oracle():
    if jattn is None:
        pytest.skip("the JAX package (the oracle) is not installed")


def _weights(seed=0):
    """The reference's ``mla_init`` weights (JAX), and the port's tensors
    of the same values."""
    jp = jattn.mla_init(jax.random.PRNGKey(seed), D, H,
                        JaxMLAConfig(**dataclasses.asdict(MLA)))
    return jp, jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jp)


def _x(B, S, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _cache(B, S, lib):
    shapes = {"c_kv": (B, S, MLA.kv_lora_rank),
              "k_rope": (B, S, MLA.qk_rope_head_dim)}
    if lib == "jax":
        return {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    return {k: torch.zeros(s) for k, s in shapes.items()}


def test_decompressed_path_matches_jax(oracle):
    jp, p = _weights()
    x = _x(2, 12)
    pos = np.arange(12, dtype=np.int32)[None] + 3
    want = jattn.mla_apply(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                           **KW)
    got = attention.mla_apply(p, torch.from_numpy(x),
                              positions=torch.from_numpy(pos), **KW)
    _close(got, want, "no-cache MLA")
    # without positions (no RoPE), as the reference allows
    _close(attention.mla_apply(p, torch.from_numpy(x), **KW),
           jattn.mla_apply(jp, jnp.asarray(x), **KW), "no positions")


def _left_pad(lengths):
    P = max(lengths)
    pads = np.array([P - n for n in lengths])
    valid = np.arange(P)[None, :] >= pads[:, None]
    pos = np.maximum(np.arange(P)[None, :] - pads[:, None], 0).astype(
        np.int32)
    return P, pads, valid, pos


def test_absorbed_prefill_and_decode_match_jax(oracle):
    """A left-padded prefill of 3 prompts (9, 4, 6 tokens) into a cache
    of 15 slots at index 0, then 6 decode steps with the pad mask and
    pad-shifted positions, as the server runs them: outputs of the real
    rows, and the compressed cache."""
    jp, p = _weights(seed=2)
    P, pads, valid, pos = _left_pad((9, 4, 6))
    B, N = len(pads), 6
    S = P + N
    x = _x(B, S, seed=3)
    jc, tc = _cache(B, S, "jax"), _cache(B, S, "torch")
    jout, jc = jattn.mla_apply(
        jp, jnp.asarray(x[:, :P]), positions=jnp.asarray(pos), cache=jc,
        cache_index=jnp.asarray(0, jnp.int32), valid=jnp.asarray(valid),
        **KW)
    out, tc2 = attention.mla_apply(
        p, torch.from_numpy(x[:, :P]), positions=torch.from_numpy(pos),
        cache=tc, cache_index=0, valid=torch.from_numpy(valid), **KW)
    assert tc2 is tc                        # written in place
    _close(out.numpy()[valid], np.asarray(jout)[valid], "prefill rows")
    for key in ("c_kv", "k_rope"):
        _close(tc[key], jc[key], f"prefill cache {key}")
    for t in range(P, S):
        step_pos = (t - pads)[:, None].astype(np.int32)
        jout, jc = jattn.mla_apply(
            jp, jnp.asarray(x[:, t:t + 1]), positions=jnp.asarray(step_pos),
            cache=jc, cache_index=jnp.asarray(t, jnp.int32),
            valid=jnp.asarray(valid), **KW)
        out, tc = attention.mla_apply(
            p, torch.from_numpy(x[:, t:t + 1]),
            positions=torch.from_numpy(step_pos), cache=tc, cache_index=t,
            valid=torch.from_numpy(valid), **KW)
        _close(out, jout, f"decode step {t - P}")
    for key in ("c_kv", "k_rope"):
        _close(tc[key], jc[key], f"decode cache {key}")


def test_absorbed_decode_equals_prefill():
    """Twin of the reference's ``test_mla_absorbed_decode_equals_prefill``:
    the absorbed form, one token at a time, against the decompressed
    path over all 8 tokens."""
    mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                    qk_rope_head_dim=8, v_head_dim=8)
    p = attention.mla_init(torch.Generator().manual_seed(0), 64, 4, mla)
    x = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(1))
    full = attention.mla_apply(p, x, num_heads=4, mla=mla,
                               positions=torch.arange(8)[None])
    cache = {"c_kv": torch.zeros((2, 8, 16)),
             "k_rope": torch.zeros((2, 8, 8))}
    outs = []
    for t in range(8):
        o, cache = attention.mla_apply(
            p, x[:, t:t + 1], num_heads=4, mla=mla,
            positions=torch.full((1, 1), t, dtype=torch.int32), cache=cache,
            cache_index=torch.tensor(t))
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_decode_at_a_device_index_is_the_int_index():
    """Decode steps at a 0-d int64 tensor index (what a captured round
    reads) give the int index's outputs and caches bit for bit."""
    p = attention.mla_init(torch.Generator().manual_seed(4), D, H, MLA)
    P, pads, valid, pos = _left_pad((5, 2))
    x = torch.from_numpy(_x(2, P + 4, seed=5))
    valid = torch.from_numpy(valid)
    runs = []
    for on_device in (False, True):
        cache = _cache(2, P + 4, "torch")
        out, cache = attention.mla_apply(
            p, x[:, :P], positions=torch.from_numpy(pos), cache=cache,
            cache_index=0, valid=valid, **KW)
        got = [out]
        for t in range(P, P + 4):
            idx = torch.tensor(t) if on_device else t
            out, cache = attention.mla_apply(
                p, x[:, t:t + 1],
                positions=torch.from_numpy((t - pads)[:, None]).int(),
                cache=cache, cache_index=idx, valid=valid, **KW)
            got.append(out)
        runs.append(got + [cache["c_kv"], cache["k_rope"]])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_mla_matches_the_cpu(cuda):
    """Both paths on the card against the CPU, float32, the same weights:
    the decompressed path, a left-padded absorbed prefill and 4 decode
    steps at a device index, within 1e-4 of max|out|."""
    p = attention.mla_init(torch.Generator().manual_seed(6), D, H, MLA)
    P, pads, valid, pos = _left_pad((9, 4, 6))
    x = torch.from_numpy(_x(3, P + 4, seed=7))
    runs = []
    for dev in ("cpu", cuda):
        pd = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in p.items()}
        got = [attention.mla_apply(pd, x.to(dev),
                                   positions=torch.arange(P + 4)[None]
                                   .to(dev), **KW)]
        cache = {k: v.to(dev) for k, v in _cache(3, P + 4, "torch").items()}
        vd = torch.from_numpy(valid).to(dev)
        out, cache = attention.mla_apply(
            pd, x[:, :P].to(dev), positions=torch.from_numpy(pos).to(dev),
            cache=cache, cache_index=0, valid=vd, **KW)
        got.append(out[vd])
        for t in range(P, P + 4):
            out, cache = attention.mla_apply(
                pd, x[:, t:t + 1].to(dev),
                positions=torch.from_numpy((t - pads)[:, None]).int().to(
                    dev),
                cache=cache, cache_index=torch.tensor(t, device=dev),
                valid=vd, **KW)
            got.append(out)
        runs.append([g.cpu() for g in got])
    for a, b in zip(*runs):
        assert float((b - a).abs().max()) <= 1e-4 * float(a.abs().max())
