"""The port's Mamba mixer (``repro_torch/arch/mamba.py``) against the JAX
package's (``repro/arch/mamba.py``).

Seeded float32 weights (the reference's ``mamba_init``, carried over as
numpy) and inputs at the reduced Jamba mixer's widths (d_state 8, head
dim 32, chunk 16): the prefill's output, final state and conv tail, then
decode steps, within rtol 1e-4 / atol 1e-5 of the reference's, at T of
one chunk, of several chunks and under K - 1. The chunk-boundary
recurrence is a loop over chunks where the reference runs an
``associative_scan``: their float32 gap on 8 chunks is printed and held
under 1e-5 of max|S|. The reference's own invariants hold on the port at
its tolerances: the output does not depend on the chunk (2e-4), and the
chunked scan equals the one-step recurrence (3e-4). A T over one chunk
that the chunk does not divide is refused, as the reference refuses it,
and a bf16 model keeps ``dt_proj``, ``dt_bias``, ``A_log`` and ``D``
float32 through ``lm_params_from_jax``. The tests marked ``cuda`` hold
the card's mixer to the CPU's:

    python -m pytest -m cuda tests/test_torch_mamba.py
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.arch import build_model as jax_build_model
    from repro.arch import mamba as jmamba
    from repro.config import MambaConfig as JaxMambaConfig
    from repro.config import get_arch_config as jax_arch_config
except ImportError:      # a machine without the JAX package: only the
    jmamba = None        # card-side tests below can run there

from repro_torch.arch import build_model, mamba
from repro_torch.config import MambaConfig, get_arch_config
from repro_torch.weights import lm_params_from_jax

RTOL, ATOL = 1e-4, 1e-5
D_MODEL = 64
MC = MambaConfig(d_state=8, head_dim=32, chunk=16)   # the reduced Jamba's
SCAN_TOL = 1e-5          # loop vs associative scan, * max|S|


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def oracle():
    if jmamba is None:
        pytest.skip("the JAX package (the oracle) is not installed")


def _jmc(mc):
    return JaxMambaConfig(**dataclasses.asdict(mc))


def _weights(mc=MC, d=D_MODEL, seed=0):
    """The reference's ``mamba_init`` weights as numpy, and the port's
    tensors of the same values."""
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), d, _jmc(mc),
                           jnp.float32)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}


def _x(B, T, d=D_MODEL, seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, d)).astype(
        np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def test_init_follows_the_reference(oracle):
    """Shapes and dtypes of every weight, and the deterministic ones
    (``dt_bias`` from ``default_rng(0)``, ``A_log``, ``D``, ``conv_b``)
    bit for bit, whatever the generator: every layer's ``dt_bias`` is
    the same."""
    jp, _ = _weights()
    assert MC.dt_rank == 0
    for seed in (0, 7):
        p = mamba.mamba_init(torch.Generator().manual_seed(seed), D_MODEL,
                             MC, torch.bfloat16)
        assert set(p) == set(jp)
        for k, v in p.items():
            assert tuple(v.shape) == jp[k].shape, k
            want = (torch.float32 if k in ("dt_proj", "dt_bias", "A_log",
                                           "D") else torch.bfloat16)
            assert v.dtype == want, k
        for k in ("dt_bias", "A_log", "D"):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
        assert not p["conv_b"].float().any()
    # dt_rank floors d_model / 16, as the reference's code does
    assert jp["dt_proj"].shape[0] == D_MODEL // 16
    assert mamba.mamba_init(torch.Generator(), 72, MC, torch.float32)[
        "dt_proj"].shape[0] == 72 // 16


@pytest.mark.parametrize("T", [16, 48, 2], ids=["one_chunk", "chunks",
                                                "under_K"])
def test_prefill_and_decode_match_jax(oracle, T):
    """Prefill with a zero cache: output, final state and the conv
    window's tail (left-padded when T < K - 1); then 6 decode steps
    from that cache."""
    jp, p = _weights()
    B, N = 2, 6
    x = _x(B, T + N)
    jmc = _jmc(MC)
    jcache = jmamba.mamba_init_cache(jp, B, jmc, D_MODEL, jnp.float32)
    cache = mamba.mamba_init_cache(B, MC, D_MODEL, torch.float32)
    jout, jcache = jmamba.mamba_apply(jp, jnp.asarray(x[:, :T]), jmc,
                                      cache=jcache)
    out, cache = mamba.mamba_apply(p, torch.from_numpy(x[:, :T]), MC,
                                   cache=cache)
    _close(out, jout, f"T {T}: prefill output")
    _close(cache["state"], jcache["state"], f"T {T}: final state")
    np.testing.assert_array_equal(cache["conv"].numpy(),
                                  np.asarray(jcache["conv"]))
    assert cache["conv"].shape == (B, MC.d_conv - 1, MC.expand * D_MODEL)
    if T < MC.d_conv - 1:
        assert not cache["conv"][:, :MC.d_conv - 1 - T].any()
    for t in range(T, T + N):
        jout, jcache = jmamba.mamba_apply(jp, jnp.asarray(x[:, t:t + 1]),
                                          jmc, cache=jcache)
        out, cache = mamba.mamba_apply(p, torch.from_numpy(x[:, t:t + 1]),
                                       MC, cache=cache)
        _close(out, jout, f"T {T}: decode step {t - T}")
        _close(cache["state"], jcache["state"], f"decode {t - T} state")
        _close(cache["conv"], jcache["conv"], f"decode {t - T} conv")


def test_no_cache_prefill_matches_jax(oracle):
    jp, p = _weights(seed=3)
    x = _x(2, 32, seed=4)
    jout, jc = jmamba.mamba_apply(jp, jnp.asarray(x), _jmc(MC))
    out, c = mamba.mamba_apply(p, torch.from_numpy(x), MC)
    assert jc is None and c is None
    _close(out, jout, "no-cache prefill")


def test_loop_scan_against_the_associative_scan(oracle):
    """``_ssd_chunked`` on 8 chunks of seeded inputs: y and the final
    state against the reference's (its chunk-boundary recurrence is an
    ``associative_scan``, the port's a loop over chunks)."""
    rng = np.random.default_rng(6)
    B, T, H, P, N, L = 2, 128, 4, 8, 8, 16
    xh = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.3, size=(B, T, H)).astype(np.float32)
    log_a = -dt * np.linspace(1, 16, H, dtype=np.float32)
    la = np.cumsum(log_a.reshape(B, T // L, L, H), axis=2).reshape(B, T, H)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    jy, jS = jmamba._ssd_chunked(*map(jnp.asarray, (xh, dt, la, Bm, Cm)), L)
    y, S = mamba._ssd_chunked(*map(torch.from_numpy, (xh, dt, la, Bm, Cm)),
                              L)
    gap = float(np.abs(S.numpy() - np.asarray(jS)).max()
                / np.abs(np.asarray(jS)).max())
    print(f"loop vs associative scan, 8 chunks: final state max diff "
          f"{gap:.3e} of max|S|")
    assert gap <= SCAN_TOL
    _close(y, jy, "y")


def test_chunk_size_invariance():
    """Twin of the reference's ``test_chunk_size_invariance_mamba``."""
    mc16 = MambaConfig(d_state=8, head_dim=16, chunk=16)
    mc4 = MambaConfig(d_state=8, head_dim=16, chunk=4)
    p = mamba.mamba_init(torch.Generator().manual_seed(0), 32, mc16,
                         torch.float32)
    x = torch.from_numpy(_x(2, 32, d=32, seed=0))
    y16, _ = mamba.mamba_apply(p, x, mc16)
    y4, _ = mamba.mamba_apply(p, x, mc4)
    np.testing.assert_allclose(y16.numpy(), y4.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_parallel_scan_vs_naive_recurrence():
    """Twin of the reference's
    ``test_mamba_parallel_scan_vs_naive_recurrence``: the chunked scan
    against decode token by token from a zero cache."""
    mc = MambaConfig(d_state=8, head_dim=16, chunk=8)
    d = 32
    p = mamba.mamba_init(torch.Generator().manual_seed(5), d, mc,
                         torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 16, d))
                         .astype(np.float32))
    y_par, _ = mamba.mamba_apply(p, x, mc)
    cache = mamba.mamba_init_cache(1, mc, d, torch.float32)
    outs = []
    for t in range(16):
        o, cache = mamba.mamba_apply(p, x[:, t:t + 1], mc, cache=cache)
        outs.append(o)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=3e-4, atol=3e-4)


def test_a_length_the_chunk_does_not_divide_is_refused():
    p = mamba.mamba_init(torch.Generator(), D_MODEL, MC, torch.float32)
    for T in (24, 17):
        with pytest.raises(ValueError, match="multiple of chunk"):
            mamba.mamba_apply(p, torch.zeros((1, T, D_MODEL)), MC)
    # at most one chunk, or whole chunks, runs
    for T in (9, 16, 32):
        out, _ = mamba.mamba_apply(p, torch.zeros((1, T, D_MODEL)), MC)
        assert out.shape == (1, T, D_MODEL)


def test_bf16_model_keeps_the_float32_leaves(oracle):
    """Reduced Jamba in bf16 (group: attention then Mamba): the
    reference's float32 Mamba leaves stay float32 in the port through
    ``lm_params_from_jax``, bit for bit, and the bf16 ones match the
    reference's bf16 values."""
    jcfg = jax_arch_config("jamba-1.5-large-398b").reduced()
    cfg = get_arch_config("jamba-1.5-large-398b").reduced()
    assert cfg.dtype == "bfloat16"
    params = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(2))
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_jax(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params)), strict=True)
    jmix = params["blocks"][1]["mixer"]
    mix = model.blocks[1]["mixer"]
    for name in ("dt_proj", "dt_bias", "A_log", "D"):
        assert jmix[name].dtype == jnp.float32
        assert mix[name].dtype == torch.float32, name
        np.testing.assert_array_equal(mix[name].detach().numpy(),
                                      np.asarray(jmix[name][0]))
    for name in ("in_proj", "conv_w", "x_proj", "out_proj"):
        assert mix[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            mix[name].detach().float().numpy(),
            np.asarray(jmix[name][0], np.float32))
    assert model.init_cache(2, 8)[1]["state"].dtype == torch.float32
    assert model.init_cache(2, 8)[1]["conv"].dtype == torch.bfloat16


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 64])
def test_cuda_mixer_matches_the_cpu(cuda, T):
    """The mixer on the card against the CPU, float32, the same weights:
    prefill output, final state and conv tail, then 6 decode steps,
    within 1e-4 of max|out|."""
    p = mamba.mamba_init(torch.Generator().manual_seed(1), D_MODEL, MC,
                         torch.float32)
    x = torch.from_numpy(_x(2, T + 6, seed=T))
    runs = []
    for dev in ("cpu", cuda):
        pd = {k: v.to(dev) for k, v in p.items()}
        cache = mamba.mamba_init_cache(2, MC, D_MODEL, torch.float32, dev)
        out, cache = mamba.mamba_apply(pd, x[:, :T].to(dev), MC,
                                       cache=cache)
        got = [out, cache["state"], cache["conv"]]
        for t in range(T, T + 6):
            out, cache = mamba.mamba_apply(pd, x[:, t:t + 1].to(dev), MC,
                                           cache=cache)
            got += [out, cache["state"]]
        runs.append([g.cpu() for g in got])
    for a, b in zip(*runs):
        assert float((b - a).abs().max()) <= 1e-4 * float(a.abs().max())
