"""The port's ``wkv6`` against the JAX package's.

On the CPU the wrapper runs the kernel's plain version, the sequential
recurrence (``repro_torch.kernels.ref.wkv6_ref``); its output is held
against the JAX ``wkv6_op`` (the chunked Pallas kernel in interpret
mode), and its output and final state against the JAX ``wkv6_ref`` and
the model path's ``wkv_chunked``, at rtol/atol 1e-4 in float32 (the
chunked forms sum in the log domain). The tests marked ``cuda`` hold the
CUDA kernel against its plain version on the card and skip where there
is none:

    python -m pytest -m cuda tests/test_torch_wkv6.py
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from repro.arch.rwkv6_block import wkv_chunked
    from repro.kernels import ops as jops
    from repro.kernels.ref import wkv6_ref as jwkv6_ref
except ImportError:      # a machine without the JAX package: only the
    jops = None          # card-side tests below can run there

from repro_torch.kernels import ops
from repro_torch.kernels.ref import wkv6_ref

RTOL = ATOL = 1e-4

# name -> (B, T, H, K)
CASES = {
    "t32_k32": (2, 32, 2, 32),
    "t37_ragged": (2, 37, 2, 32),
    "t16_k64": (1, 16, 2, 64),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oracle():
    if jops is None:
        pytest.skip("the JAX package (the oracle) is not installed")
    return jops


def _inputs(B, T, H, K, seed=0):
    """r, k, v, w, u as the model makes them: w = exp(-exp(dd)) in
    (0, 1), u small."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, K)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2.0, 0.7, size=(B, T, H, K)))
               ).astype(np.float32)
    u = (rng.normal(size=(H, K)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _port(*arrays):
    o, s = ops.wkv6_op(*(torch.from_numpy(a) for a in arrays))
    return o.numpy(), s.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_the_pallas_kernel_and_wkv6_ref(name, oracle):
    arrays = _inputs(*CASES[name])
    o, s = _port(*arrays)
    jarr = [jnp.asarray(a) for a in arrays]
    want = oracle.wkv6_op(*jarr, chunk=16, interpret=True)
    np.testing.assert_allclose(o, np.asarray(want), rtol=RTOL, atol=ATOL)
    w_o, w_s = jwkv6_ref(*jarr)
    np.testing.assert_allclose(o, np.asarray(w_o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s, np.asarray(w_s), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["t32_k32", "t16_k64"])
def test_plain_matches_the_model_paths_wkv_chunked(name, oracle):
    arrays = _inputs(*CASES[name], seed=1)
    o, s = _port(*arrays)
    w_o, w_s = wkv_chunked(*(jnp.asarray(a) for a in arrays), chunk=8)
    np.testing.assert_allclose(o, np.asarray(w_o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s, np.asarray(w_s), rtol=RTOL, atol=ATOL)


def test_state_carries_across_a_split():
    """Running T steps equals running the first half, then continuing
    the recurrence from its final state by hand for the rest."""
    r, k, v, w, u = _inputs(1, 12, 2, 32, seed=2)
    o, s = _port(r, k, v, w, u)
    o1, s1 = _port(r[:, :6], k[:, :6], v[:, :6], w[:, :6], u)
    np.testing.assert_allclose(o[:, :6], o1, rtol=1e-6, atol=1e-6)
    S = s1.astype(np.float64)
    for t in range(6, 12):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ot = np.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv)
        np.testing.assert_allclose(o[:, t], ot, rtol=1e-5, atol=1e-5)
        S = w[:, t, :, :, None] * S + kv
    np.testing.assert_allclose(s, S, rtol=1e-5, atol=1e-5)


def test_bfloat16_output_in_r_dtype():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 8, 1, 32))
    o, s = ops.wkv6_op(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32


def test_float32_output_on_bf16_inputs_matches_wkv_chunked(oracle):
    """``out_dtype=torch.float32`` on bf16 inputs: the o that the model's
    ``wkv_chunked`` returns from the same bf16 inputs (it computes and
    returns float32), within 1e-4."""
    arrays = _inputs(2, 32, 2, 32, seed=3)
    r, k, v = (torch.from_numpy(a).bfloat16() for a in arrays[:3])
    w, u = (torch.from_numpy(a) for a in arrays[3:])
    o, s = ops.wkv6_op(r, k, v, w, u, out_dtype=torch.float32)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    jr, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                  for a in (r, k, v))
    w_o, w_s = wkv_chunked(jr, jk, jv, jnp.asarray(arrays[3]),
                           jnp.asarray(arrays[4]), chunk=8)
    assert w_o.dtype == jnp.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(w_o), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(w_s), rtol=RTOL,
                               atol=ATOL)


def test_float32_output_is_the_unrounded_bf16_one():
    """The float32 o rounds to the bf16 o: one recurrence, two output
    types."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 12, 2, 32))
    r, k, v = r.bfloat16(), k.bfloat16(), v.bfloat16()
    o32, s32 = ops.wkv6_op(r, k, v, w, u, out_dtype=torch.float32)
    o16, s16 = ops.wkv6_op(r, k, v, w, u)
    assert o16.dtype == torch.bfloat16
    torch.testing.assert_close(o32.bfloat16(), o16, rtol=0, atol=0)
    torch.testing.assert_close(s32, s16, rtol=0, atol=0)


def test_out_dtype_is_none_or_float32():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 4, 1, 32))
    with pytest.raises(ValueError, match="out_dtype"):
        ops.wkv6_op(r, k, v, w, u, out_dtype=torch.bfloat16)


def test_bf16_model_hands_ln_x_a_float32_o(monkeypatch):
    """ROADMAP C.10: in bf16 the port's RWKV-6 time mixing normalises the
    recurrence's float32 o with ``ln_x`` and rounds once after it, as the
    reference does (``repro/arch/rwkv6_block.py``: ``wkv_chunked``
    returns float32); the prefill asks ``wkv6`` for float32 o."""
    from repro_torch.arch import rwkv6_block as blk
    from repro_torch.config import get_arch_config
    cfg = get_arch_config("rwkv6-1.6b").reduced()
    assert cfg.dtype == "bfloat16"
    gen = torch.Generator().manual_seed(0)
    p = blk.rwkv_time_init(gen, cfg.d_model, cfg.rwkv, torch.bfloat16)
    seen = []
    real = blk.rmsnorm_apply
    monkeypatch.setattr(blk, "rmsnorm_apply",
                        lambda q, x, eps: seen.append(x.dtype)
                        or real(q, x, eps))
    x = torch.randn((2, 16, cfg.d_model), generator=gen).bfloat16()
    out, _ = blk.rwkv_time_apply(p, x, cfg.rwkv, cfg.norm_eps)
    cache = blk.rwkv_init_cache(2, cfg.d_model, cfg.rwkv, torch.bfloat16)
    out_c, cache = blk.rwkv_time_apply(p, x, cfg.rwkv, cfg.norm_eps,
                                       cache["time"])
    step, _ = blk.rwkv_time_apply(p, x[:, :1], cfg.rwkv, cfg.norm_eps,
                                  cache)
    assert seen == [torch.float32] * 3
    assert out.dtype == out_c.dtype == step.dtype == torch.bfloat16
    torch.testing.assert_close(out, out_c, rtol=0, atol=0)


def test_shape_errors_and_no_launch_on_the_cpu():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 32))
    with pytest.raises(ValueError, match="do not fit"):
        ops.wkv6_op(r, k, v, w, u[:1])
    before = dict(ops.launches)
    ops.wkv6_op(r, k, v, w, u)
    assert ops.launches == before


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


# the element gate of the bf16 kernels (chip_smoke.py's _bf16_check):
# |got - want| <= BF16_RTOL * |want| + BF16_ATOL * rms(want), one bf16 ulp
# of the output plus float32 sum-order noise near 0
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3

# one step, two 16-step tiles and one more step, B*H of 4, and more
# (b, h) blocks than an H100's 132 SMs: name -> (B, T, H, K)
CARD_CASES = dict(CASES, t1=(2, 1, 4, 64), t33=(1, 33, 8, 64),
                  bh4=(1, 200, 4, 64), bh4_k32=(2, 70, 2, 32),
                  bh160_ragged=(5, 77, 32, 64), bh144_k32=(9, 40, 16, 32))


def _bf16_share(got, want) -> float:
    g, w = got.float(), want.float()
    atol = BF16_ATOL * float(w.square().mean().sqrt())
    return float(((g - w).abs() / (atol + BF16_RTOL * w.abs())).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype",
                         [(torch.float32, None), (torch.bfloat16, None),
                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_cuda_kernel_matches_plain_version(name, dtype, out_dtype, cuda):
    r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(*CARD_CASES[name]))
    r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    before = ops.launches["wkv6"]
    o, s = ops.wkv6_op(r, k, v, w, u, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ops.launches["wkv6"] == before + 1
    w_o, w_s = wkv6_ref(r, k, v, w, u, out_dtype=out_dtype)
    assert o.dtype == w_o.dtype == (out_dtype or dtype)
    torch.testing.assert_close(s, w_s, rtol=RTOL, atol=ATOL)
    if o.dtype == torch.float32:
        torch.testing.assert_close(o, w_o, rtol=RTOL, atol=ATOL)
    else:
        assert _bf16_share(o, w_o) <= 1.0


@pytest.mark.cuda
def test_cuda_kernel_repeats_bitwise(cuda):
    """The K-slices' partial outputs are summed in a fixed order: two
    identical calls give the same bits."""
    r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(2, 100, 4, 64, seed=4))
    a = ops.wkv6_op(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u,
                    out_dtype=torch.float32)
    b = ops.wkv6_op(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u,
                    out_dtype=torch.float32)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(1, 8, 2, 16))
    with pytest.raises(ValueError, match="K = V"):
        ops.wkv6_op(r, k, v, w, u)
    r, k, v, w, u = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(1, 8, 2, 32))
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6_op(r, k, v, w.bfloat16(), u)
