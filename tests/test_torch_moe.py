"""The port's MoE FFN (``repro_torch/arch/moe.py``) against the JAX
package's (``repro/arch/moe.py``).

On seeded float32 inputs the router's renormalized top-k gates, the
load-balance aux loss and ``moe_ffn_dense`` match the reference at
rtol/atol 1e-5 (the products sum in another order). The top-k pick breaks
ties as ``jax.lax.top_k`` does, lowest index first: a zero router
(uniform probabilities) picks experts 0..k-1, as the reference does. A
bf16 model's router stays float32 through ``lm_params_from_jax``;
``moe_impl="ep"`` without a mesh is dense dispatch, as in the reference
(``tests/test_torch_moe_ep.py`` holds the expert-parallel dispatch).
The tests marked ``cuda`` hold the card's pick, FFN and expert-parallel
dispatch to the CPU's and skip where there is none:

    python -m pytest -m cuda tests/test_torch_moe.py
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.arch import build_model as jax_build_model
    from repro.arch import moe as jmoe
    from repro.config import MoEConfig as JaxMoEConfig
    from repro.config import get_arch_config as jax_arch_config
except ImportError:      # a machine without the JAX package: only the
    jmoe = None          # card-side tests below can run there

from repro_torch.arch import build_model
from repro_torch.arch import moe
from repro_torch.config import MoEConfig, get_arch_config
from repro_torch.weights import lm_params_from_jax

RTOL = ATOL = 1e-5
# (experts, top_k): the reduced configs' (4, 2), Mixtral's (8, 2),
# DBRX's (16, 4), and a single pick
ROUTINGS = [(4, 2), (8, 2), (16, 4), (2, 1)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def oracle():
    if jmoe is None:
        pytest.skip("the JAX package (the oracle) is not installed")


def _params(E, D=32, F=48, seed=0, router_scale=1.0):
    """Seeded float32 MoE weights as numpy, in the reference's layout."""
    rng = np.random.default_rng(seed)
    return {"router": (rng.normal(size=(D, E)) * router_scale
                       / np.sqrt(D)).astype(np.float32),
            "wi_gate": (rng.normal(size=(E, D, F)) / np.sqrt(D))
            .astype(np.float32),
            "wi_up": (rng.normal(size=(E, D, F)) / np.sqrt(D))
            .astype(np.float32),
            "wo": (rng.normal(size=(E, F, D)) / np.sqrt(F))
            .astype(np.float32)}


def _x(B=2, S=12, D=32, seed=1):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("E,k", ROUTINGS)
def test_router_gates_and_aux_match_jax(E, k, oracle):
    jp, jx, p, x = _both(_params(E, seed=E), _x(seed=E + 1))
    want_g, want_aux = jmoe.router_gates(jp, jx,
                                         JaxMoEConfig(num_experts=E,
                                                      top_k=k))
    got_g, got_aux = moe.router_gates(p, x, MoEConfig(num_experts=E,
                                                      top_k=k))
    assert got_g.dtype == torch.float32
    _close(got_g, want_g, f"gates E={E} k={k}")
    _close(got_aux, want_aux, f"aux E={E} k={k}")
    # the same experts picked, k of them per token
    np.testing.assert_array_equal(np.asarray(got_g) > 0,
                                  np.asarray(want_g) > 0)
    assert ((got_g > 0).sum(-1) == k).all()


@pytest.mark.parametrize("E,k", ROUTINGS)
def test_a_zero_router_picks_experts_0_to_k_minus_1(E, k, oracle):
    """Zero router weights give every expert the probability 1/E: the
    reference's ``jax.lax.top_k`` keeps the first k, and so must the
    port (``torch.topk`` promises no order on ties)."""
    p = _params(E, seed=3)
    p["router"][:] = 0.0
    jp, jx, tp, x = _both(p, _x(seed=4))
    cfg = dict(num_experts=E, top_k=k)
    want_g, want_aux = jmoe.router_gates(jp, jx, JaxMoEConfig(**cfg))
    got_g, got_aux = moe.router_gates(tp, x, MoEConfig(**cfg))
    expect = np.zeros(E, np.float32)
    expect[:k] = 1.0 / k
    np.testing.assert_array_equal(np.asarray(want_g)[0, 0], expect)
    _close(got_g, want_g, "tied gates")
    _close(got_aux, want_aux, "tied aux")
    jout, _ = jmoe.moe_ffn_dense(jp, jx, JaxMoEConfig(**cfg))
    out, _ = moe.moe_ffn_dense(tp, x, MoEConfig(**cfg))
    _close(out, jout, "tied FFN")


@pytest.mark.parametrize("probs,k", [
    ([0.125] * 8, 2),                      # torch.topk picks [6, 5] here
    ([0.1, 0.3, 0.3, 0.3], 2),             # and [2, 3] here
    ([0.3, 0.1, 0.3, 0.3], 1),
    ([0.2, 0.2, 0.1, 0.2, 0.2, 0.1], 3),
    ([0.4, 0.1, 0.4, 0.1], 2),
])
def test_top_k_mask_breaks_ties_as_jax_top_k(probs, k, oracle):
    p = np.asarray(probs, np.float32)[None]
    _, idx = jax.lax.top_k(jnp.asarray(p), k)
    want = np.zeros_like(p)
    want[0, np.asarray(idx)[0]] = 1.0
    got = moe.top_k_mask(torch.from_numpy(p), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_mask_matches_jax_on_quantized_probabilities(oracle):
    """Many ties at once: probabilities rounded to 1/8 over (B, S, 16)."""
    rng = np.random.default_rng(7)
    p = (np.round(rng.random((3, 40, 16)) * 8) / 8).astype(np.float32)
    for k in (1, 2, 4):
        _, idx = jax.lax.top_k(jnp.asarray(p), k)
        want = np.asarray(jax.nn.one_hot(idx, 16).sum(-2))
        got = moe.top_k_mask(torch.from_numpy(p), k)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("E,k", ROUTINGS)
def test_moe_ffn_dense_matches_jax(E, k, oracle):
    jp, jx, p, x = _both(_params(E, seed=10 + E), _x(seed=20 + E))
    want, want_aux = jmoe.moe_ffn_dense(jp, jx, JaxMoEConfig(num_experts=E,
                                                             top_k=k))
    got, got_aux = moe.moe_ffn_dense(p, x, MoEConfig(num_experts=E,
                                                     top_k=k))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want, f"moe_ffn_dense E={E} k={k}")
    _close(got_aux, want_aux, f"aux E={E} k={k}")


def test_moe_init_keeps_the_references_router_and_fan_in():
    """The router is float32 in a bf16 block; the expert stacks are
    drawn with fan_in = E (``shape[0]``), as ``_fan_in_init`` draws them
    in the reference."""
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 64, 96, 4, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (64, 4)
    for name, shape in (("wi_gate", (4, 64, 96)), ("wi_up", (4, 64, 96)),
                        ("wo", (4, 96, 64))):
        w = p[name]
        assert w.dtype == torch.bfloat16 and w.shape == shape
        assert abs(float(w.float().std()) - 0.5) < 0.01, name
    assert abs(float(p["router"].std()) - 1 / 8) < 0.01


def test_bf16_router_stays_float32_through_lm_params_from_jax(oracle):
    """Reduced Mixtral in bf16: the JAX params load into the port with
    the router float32 and equal to the reference's bit for bit, and the
    expert stacks bf16 and equal too."""
    jcfg = jax_arch_config("mixtral-8x7b").reduced()
    cfg = get_arch_config("mixtral-8x7b").reduced()
    assert cfg.dtype == jcfg.dtype == "bfloat16"
    params = jax_build_model(jcfg, remat=False).init(jax.random.PRNGKey(1))
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_jax(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params)), strict=True)
    for layer in range(cfg.num_layers):
        ffn = model.blocks[layer]["ffn"]
        jffn = params["blocks"][0]["ffn"]
        assert ffn["router"].dtype == torch.float32
        np.testing.assert_array_equal(
            ffn["router"].detach().numpy(),
            np.asarray(jffn["router"][layer]))
        for name in ("wi_gate", "wi_up", "wo"):
            assert ffn[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                ffn[name].detach().float().numpy(),
                np.asarray(jffn[name][layer], np.float32))


def test_moe_impl_ep_is_refused_naming_a13():
    """``moe_impl="ep"`` without a mesh is dense dispatch bit for bit, as
    the reference's ``_ffn_apply`` runs it (the refusal of ROADMAP A.13
    went with the port of ``moe_ffn_ep``); an unknown ``moe_impl`` is
    still refused."""
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(
        dtype="float32")
    dense = build_model(cfg)
    model = build_model(cfg, moe_impl="ep")
    model.load_state_dict(dense.state_dict())
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    want, _, _ = dense.prefill({"tokens": toks}, cache_len=12)
    got, _, _ = model.prefill({"tokens": toks}, cache_len=12)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="moe_impl"):
        build_model(cfg, moe_impl="sparse")


def test_moe_every_follows_the_reference(oracle):
    """moe_every 1: every layer MoE. moe_every 2 on a dense model (groups
    of one layer) is refused, as the reference's ``init`` refuses it;
    jamba's hybrid groups of 2 and 8 layers take it
    (``tests/test_torch_lm.py::test_jamba_moe_interleave``)."""
    cfg = get_arch_config("dbrx-132b").reduced().replace(dtype="float32")
    model = build_model(cfg)
    assert all("router" in b["ffn"] for b in model.blocks)
    with pytest.raises(ValueError, match="moe_every"):
        jax_build_model(jax_arch_config("dbrx-132b").reduced().replace(
            moe_every=2), remat=False).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="moe_every"):
        build_model(cfg.replace(moe_every=2))


def test_the_model_sums_the_aux_losses(oracle):
    """The backbone's aux loss is the sum over the MoE layers of each
    layer's router aux, as the reference's backbone sums it."""
    jcfg = jax_arch_config("mixtral-8x7b").reduced().replace(
        dtype="float32")
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(dtype="float32")
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(2))
    model = build_model(cfg)
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10))
    x = jm._embed(params, {"tokens": jnp.asarray(toks)})
    pos = jnp.arange(10, dtype=jnp.int32)[None]
    _, _, want = jm._backbone(params, x, positions=pos)
    with torch.no_grad():
        xt = model._embed({"tokens": torch.from_numpy(toks)})
        _, _, got = model._backbone(xt, positions=torch.arange(10)[None])
    assert float(got) > 0
    _close(got, want, "summed aux")


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_top_k_mask_breaks_ties_lowest_index_first(cuda):
    rng = np.random.default_rng(7)
    p = torch.from_numpy((np.round(rng.random((3, 40, 16)) * 8) / 8)
                         .astype(np.float32))
    for k in (1, 2, 4):
        want = moe.top_k_mask(p, k)
        got = moe.top_k_mask(p.to(cuda), k)
        assert torch.equal(got.cpu(), want)
    uniform = torch.full((1, 1, 8), 0.125, device=cuda)
    assert moe.top_k_mask(uniform, 2).nonzero()[:, -1].tolist() == [0, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("E,k", ROUTINGS)
def test_cuda_moe_ffn_dense_matches_the_cpu(E, k, cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    p = {n: torch.from_numpy(v) for n, v in _params(E, seed=E).items()}
    x = torch.from_numpy(_x(seed=E + 1))
    cfg = MoEConfig(num_experts=E, top_k=k)
    want, want_aux = moe.moe_ffn_dense(p, x, cfg)
    got, got_aux = moe.moe_ffn_dense({n: v.to(cuda) for n, v in p.items()},
                                     x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("E,k", ROUTINGS)
def test_cuda_moe_ffn_ep_matches_the_cpu(E, k, shape, cuda):
    """Expert parallelism on the card (every rank through ``LocalComm``)
    against the CPU at capacity 1.0, where pairs drop: the same outputs,
    aux and dropped-pair count, and two card runs bitwise equal."""
    from repro_torch.launch.mesh import ExpertMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    p = {n: torch.from_numpy(v) for n, v in _params(E, seed=E).items()}
    x = torch.from_numpy(_x(B=4, S=8, seed=E + 1) + 2.0)
    cfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=1.0)
    runs = []
    for dev in ("cpu", cuda, cuda):
        with moe.count_drops() as log:
            out, aux = moe.moe_ffn_ep({n: v.to(dev) for n, v in p.items()},
                                      x.to(dev), cfg, ExpertMesh(*shape),
                                      dp_axis="data")
        runs.append((out.cpu(), aux.cpu(), int(log[0][0])))
    (want, want_aux, want_d), (got, got_aux, got_d), again = runs
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_aux, want_aux, rtol=RTOL, atol=ATOL)
    assert got_d == want_d
    assert torch.equal(again[0], got) and again[2] == got_d
