"""The port's ``flash_attention`` against the JAX package's.

On the CPU the wrapper runs the kernel's plain version
(``repro_torch.kernels.ref.flash_attention_ref``); it is held against
the JAX ``flash_attention_op`` (the Pallas kernel in interpret mode) and
``mha_ref`` at rtol/atol 1e-5 in float32 (the softmax sums run in
another order). The per-row ``kv_start`` the serving path adds is held
against the reference's ``_sdpa`` with a ``k_valid`` bias on the rows
that see a key; the rows that see none must be 0. The tests marked
``cuda`` hold the CUDA kernel against its plain version on the card and
skip where there is none:

    python -m pytest -m cuda tests/test_torch_flash.py
"""
import math

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro.kernels.ref import mha_ref
    from repro.nn.attention import _sdpa, make_attention_bias
except ImportError:      # a machine without the JAX package: only the
    jops = None          # card-side tests below can run there

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

RTOL = ATOL = 1e-5

# name -> (B, T, Hq, Hkv, D, causal, sliding_window)
CASES = {
    "causal_d32": (2, 32, 2, 2, 32, True, 0),
    "noncausal_d64": (1, 24, 2, 2, 64, False, 0),
    "window_d32": (2, 32, 2, 2, 32, True, 8),
    "odd_t": (1, 37, 2, 2, 32, True, 0),
    "gqa_4": (1, 32, 4, 1, 32, True, 0),
    "d128": (1, 16, 2, 1, 128, True, 0),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oracle():
    if jops is None:
        pytest.skip("the JAX package (the oracle) is not installed")
    return jops


def _qkv(B, T, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return ops.flash_attention_op(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_the_pallas_kernel_and_mha_ref(name, oracle):
    B, T, Hq, Hkv, D, causal, window = CASES[name]
    q, k, v = _qkv(B, T, Hq, Hkv, D)
    got = _port(q, k, v, causal=causal, sliding_window=window)
    # blocks of 16: several key tiles, so the band skipping is exercised
    want = oracle.flash_attention_op(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sliding_window=window, block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    rep = Hq // Hkv
    ref = mha_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
                  jnp.asarray(np.repeat(v, rep, axis=2)), causal=causal,
                  sliding_window=window)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_seq_len_masks_trailing_keys_as_the_pallas_kernel(causal, oracle):
    q, k, v = _qkv(2, 32, 2, 2, 32, seed=1)
    got = _port(q, k, v, causal=causal, seq_len=21)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=16, block_k=16, seq_len=21,
                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [0, 4])
def test_kv_start_matches_sdpa_with_a_pad_mask(window, oracle):
    """A left-padded batch (pads 0, 3 and 7 of 12): the rows that see a
    key equal the reference's ``_sdpa`` over a ``k_valid`` bias; the pad
    rows, which see no key, are exactly 0."""
    B, T, Hkv, G, D = 3, 12, 2, 2, 32
    q, k, v = _qkv(B, T, Hkv * G, Hkv, D, seed=2)
    pads = np.array([0, 3, 7], np.int32)
    valid = np.arange(T)[None, :] >= pads[:, None]
    got = _port(q, k, v, causal=True, sliding_window=window,
                kv_start=torch.from_numpy(pads))
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    bias = make_attention_bias(pos, pos, causal=True, sliding_window=window,
                               k_valid=jnp.asarray(valid))[:, None]
    want = np.asarray(_sdpa(jnp.asarray(q).reshape(B, T, Hkv, G, D),
                            jnp.asarray(k), jnp.asarray(v), bias)
                      ).reshape(B, T, Hkv * G, D)
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL,
                               atol=ATOL)
    assert not got[~valid].any()


def test_rows_with_no_visible_key_are_zero():
    q, k, v = _qkv(2, 10, 2, 2, 32, seed=3)
    start = torch.tensor([10, 4], dtype=torch.int32)    # row 0: no key
    out = _port(q, k, v, causal=True, kv_start=start)
    assert not out[0].any() and not out[1, :4].any()
    assert np.abs(out[1, 4:]).min() > 0


def test_gqa_by_index_equals_repeated_heads():
    q, k, v = _qkv(1, 16, 8, 2, 32, seed=4)
    got = _port(q, k, v)
    want = _port(q, np.repeat(k, 4, axis=2), np.repeat(v, 4, axis=2))
    np.testing.assert_array_equal(got, want)


def test_bfloat16_in_bfloat16_out():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 16, 2, 1, 32, seed=5))
    out = ops.flash_attention_op(q, k, v)
    assert out.dtype == torch.bfloat16
    want = flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)


# the element gate of the bf16 kernels (chip_smoke.py's _bf16_check):
# |got - want| <= BF16_RTOL * |want| + BF16_ATOL * rms(want), one bf16 ulp
# of the output plus float32 sum-order noise near 0
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3


def _bf16_share(got, want) -> float:
    """The worst element's share of the bf16 element gate (<= 1 passes)."""
    g, w = got.float(), want.float()
    atol = BF16_ATOL * float(w.square().mean().sqrt())
    return float(((g - w).abs() / (atol + BF16_RTOL * w.abs())).max())


def _tensor_core_emulation(q, k, v, p_mode: str, kv_start=None,
                           bk: int = 64):
    """The bf16 kernel's arithmetic in plain torch (causal, GQA by
    index, left pads): S = q k^T exactly from bf16 operands, an online
    softmax over tiles of ``bk`` keys with float32 p, and PV with float32
    sums, p entering it as ``p_mode``: "split" bf16(p) + bf16(p -
    bf16(p)) (the kernel), "bf16" bf16(p) alone (the library kernels'
    way) or "fp16" fp16(p) against fp16 V."""
    B, T, Hq, D = q.shape
    rep = Hq // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = q.float().transpose(1, 2)
    kf, vf = (a.float().repeat_interleave(rep, 2).transpose(1, 2)
              for a in (k, v))
    if p_mode == "fp16":
        vf = vf.half().float()
    s = (qf @ kf.transpose(-1, -2)) * scale
    i = torch.arange(T)
    ok = (i[None, :] <= i[:, None])[None, None]
    if kv_start is not None:
        ok = ok & (i[None, None, None, :] >= kv_start[:, None, None, None])
    s = torch.where(ok, s, torch.full_like(s, -math.inf))
    m = torch.full((B, Hq, T, 1), -math.inf)
    l = torch.zeros((B, Hq, T, 1))
    acc = torch.zeros((B, Hq, T, D))
    for k0 in range(0, T, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(st - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vf[..., k0:k0 + bk, :]
        if p_mode == "fp16":
            pv = p.half().float() @ vt
        else:
            hi = p.bfloat16().float()
            pv = hi @ vt
            if p_mode == "split":
                pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-20)).transpose(1, 2).bfloat16()


# name -> (B, T, Hq, Hkv, D, left pads): the Qwen3-4B prefill of a served
# batch, and a small causal case
P_CASES = {"qwen3_prefill": (4, 512, 32, 8, 128, (0, 37, 300, 448)),
           "causal_d64": (2, 256, 4, 4, 64, None)}


@pytest.mark.parametrize("name", sorted(P_CASES))
def test_split_p_passes_the_bf16_gate_where_bf16_p_fails(name):
    """Why the tensor-core kernel splits p: PV with p = p_hi + p_lo stays
    inside the element gate against the float32-p plain version;
    rounding p to bf16 alone does not. Prints each way's worst share."""
    B, T, Hq, Hkv, D, pads = P_CASES[name]
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(B, T, Hq, Hkv, D, seed=6))
    start = None if pads is None else torch.tensor(pads)
    want = flash_attention_ref(q, k, v, kv_start=start)
    share = {mode: _bf16_share(_tensor_core_emulation(q, k, v, mode, start),
                               want)
             for mode in ("split", "bf16", "fp16")}
    print(f"{name}: worst element's share of the bf16 gate by p: {share}")
    assert share["split"] <= 1.0, share
    assert share["bf16"] > 1.0, share


def test_shape_errors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 3, 2, 32))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention_op(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 2, 32))
    with pytest.raises(ValueError, match="seq_len"):
        ops.flash_attention_op(q, k, v, seq_len=9)
    with pytest.raises(ValueError, match="kv_start"):
        ops.flash_attention_op(q, k, v, kv_start=torch.zeros(2))


def test_cpu_wrapper_launches_nothing():
    before = dict(ops.launches)
    _port(*_qkv(1, 8, 2, 2, 32))
    assert ops.launches == before


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_version(name, dtype, cuda):
    B, T, Hq, Hkv, D, causal, window = CASES[name]
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(B, T, Hq, Hkv, D))
    start = torch.arange(B, dtype=torch.int32, device=cuda) * 3
    before = ops.launches["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=causal,
                                 sliding_window=window, kv_start=start,
                                 seq_len=T - 1)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    assert got.dtype == dtype
    want = flash_attention_ref(q, k, v, causal=causal, sliding_window=window,
                               kv_start=start, seq_len=T - 1)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert _bf16_share(got, want) <= 1.0


# lengths that cross the bf16 kernel's 128-row query and 64-key tiles,
# D 32, a kv_start and a window edge inside a tile: name -> (B, T, Hq,
# Hkv, D, causal, window, kv_start)
TILE_CASES = {
    "t129": (1, 129, 4, 2, 128, True, 0, (0,)),
    "t255_noncausal": (2, 255, 4, 2, 64, False, 0, (0, 0)),
    "d32_pad": (2, 200, 4, 2, 32, True, 0, (0, 50)),
    "kv_start_mid_tile": (2, 300, 4, 2, 128, True, 0, (70, 201)),
    "window_crosses_tile": (2, 400, 4, 2, 64, True, 100, (0, 30)),
    "all_masked_row": (2, 150, 4, 1, 64, True, 0, (150, 5)),
    # Whisper's encoder: bidirectional over 1,500 frames (no multiple of
    # a tile), 8/8 heads of 64
    "whisper_encoder": (4, 1500, 8, 8, 64, False, 0, (0, 0, 0, 0)),
    # Qwen2-VL's served prefill: a GQA group of 6, D 128, left pads
    "qwen2vl_prefill_g6": (4, 2048, 12, 2, 128, True, 0, (0, 37, 300, 448)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_cuda_kernel_at_tile_edges(name, dtype, cuda):
    B, T, Hq, Hkv, D, causal, window, start = TILE_CASES[name]
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(B, T, Hq, Hkv, D, seed=7))
    start = torch.tensor(start, dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, sliding_window=window, kv_start=start)
    got = ops.flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert _bf16_share(got, want) <= 1.0
    for b in range(B):        # the rows before kv_start see no key
        assert not got[b, :int(start[b])].any()


@pytest.mark.cuda
def test_cuda_kernels_refuse_inputs_that_require_grad(cuda):
    """The forward-only kernels raise, naming themselves, when autograd
    would record the call, and launch nothing."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(1, 8, 2, 2, 32))
    before = dict(ops.launches)
    with pytest.raises(RuntimeError, match="flash_attention.*forward-only"):
        ops.flash_attention_op(q, k.requires_grad_(), v)
    r = torch.randn((1, 4, 2, 32), device=cuda)
    w = torch.full((1, 4, 2, 32), 0.9, device=cuda)
    u = torch.zeros((2, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="wkv6.*forward-only"):
        ops.wkv6_op(r, r, r, w, u)
    assert ops.launches == before
    with torch.no_grad():
        ops.flash_attention_op(q, k, v)
        ops.wkv6_op(r, r, r, w, u)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before["flash_attention"] + 1
    assert ops.launches["wkv6"] == before["wkv6"] + 1


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(1, 8, 2, 2, 48))
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention_op(q, k, v)
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(1, 8, 2, 2, 32))
    with pytest.raises(TypeError, match="operands in"):
        ops.flash_attention_op(q, k.half(), v)
