"""The JAX package's remaining helpers against their ports, on the CPU:
the pre-fusion softmax backward oracle, the float32 attention oracle,
the binary loss, dropout and the Glorot init, the embedding lookups, the
named-tensor tree helpers, and the legacy ``train_gnn`` entry point."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.tree as jtree
from repro.config import GNNConfig as JaxConfig
from repro.core.aggregate import reference_edge_softmax_bwd as jax_es_bwd
from repro.kernels.ref import mha_ref as jax_mha_ref
from repro.launch.train import train_gnn as jax_train_gnn
from repro.models import make_gnn as jax_make_gnn
from repro.nn import layers as jlayers
import repro_torch.models as port_models
import repro_torch.utils as tu
from repro_torch.core.aggregate import reference_edge_softmax_bwd
from repro_torch.kernels import ops
from repro_torch.kernels.plan import build_csc_plan
from repro_torch.kernels.ref import (NEG, edge_softmax_bwd_ref,
                                     flash_attention_ref, mha_ref)
from repro_torch.launch.train import train_gnn
from repro_torch.nn import (binary_cross_entropy, dropout, embedding_apply,
                            embedding_init)
from repro_torch.nn.layers import glorot, unembed_apply
from repro_torch.weights import load_jax_params

RTOL, ATOL = 1e-5, 1e-6
TRAIN_TOL = 1e-4                      # tests/test_torch_train.py's


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the pre-fusion softmax backward ------------------------------------------


def _softmax_case(seed=0, E=80, N=13, H=3, D=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N - 2, E).astype(np.int32)    # two empty rows
    logits = rng.normal(size=(E, H)).astype(np.float32) * 3
    logits[rng.random(E) < 0.25] = NEG                  # masked edges
    logits[ids == 1] = NEG                              # an all-masked row
    values = rng.normal(size=(E, H, D)).astype(np.float32)
    values[logits[:, 0] <= NEG / 2] = 0.0
    g = rng.normal(size=(N, H, D)).astype(np.float32)
    return ids, N, logits, values, g


def test_reference_edge_softmax_bwd_matches_jax_and_the_kernels_oracle():
    """Line for line the reference's (``repro/core/aggregate.py:257``);
    and, off all-masked rows, the kernels' own plain backward
    (``edge_softmax_bwd_ref``, from the forward's saved statistics),
    which differs there by the clamp (1e-9 against 1e-20, ROADMAP C.3)
    and the all-masked row's weights."""
    ids, N, lg, v, g = _softmax_case()
    plan = build_csc_plan(ids, N)
    out, m, den = ops.edge_softmax_fwd_op(_t(lg), _t(v), plan)
    want = jax_es_bwd(g, lg, v, out.numpy(), ids, N)
    got = reference_edge_softmax_bwd(_t(g), _t(lg), _t(v), out, _t(ids), N)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    fused = edge_softmax_bwd_ref(_t(g), _t(lg), _t(v), m, den,
                                 (out * _t(g)).sum(-1), plan.edge_dst)
    live = ids != 1
    for a, b in zip(got, fused):
        np.testing.assert_allclose(a.numpy()[live], b.numpy()[live],
                                   rtol=RTOL, atol=ATOL)


# -- attention oracle ---------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_mha_ref_matches_jax(causal, window):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 17, 3, 8)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_mha_ref(q, k, v, causal=causal,
                                  sliding_window=window))
    got = mha_ref(_t(q), _t(k), _t(v), causal=causal, sliding_window=window)
    assert got.dtype == torch.float32 and got.shape == (2, 17, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the kernels' plain version agrees where every row sees a key
    np.testing.assert_allclose(
        flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                            sliding_window=window).numpy(),
        want, rtol=RTOL, atol=ATOL)


def test_mha_ref_keeps_the_input_dtype():
    q = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    assert mha_ref(q, q, q).dtype == torch.bfloat16


# -- losses, dropout, init, embeddings ----------------------------------------


@pytest.mark.parametrize("masked", ["mask", "none", "empty_mask"])
def test_binary_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(60,)).astype(np.float32) * 30   # |x| large
    labels = rng.integers(0, 2, 60).astype(np.int32)
    mask = {"mask": (rng.random(60) < 0.5).astype(np.float32),
            "none": None, "empty_mask": np.zeros(60, np.float32)}[masked]
    want = float(jlayers.binary_cross_entropy(logits, labels, mask))
    got = binary_cross_entropy(_t(logits), _t(labels),
                               None if mask is None else _t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)


def test_dropout_properties():
    """The JAX key's bits cannot be matched; what carries over: the keep
    rate, the 1/keep scale, the identity when deterministic or at rate
    0, and the same mask from the same generator state."""
    x = torch.ones(400, 250)
    assert dropout(x, 0.3, deterministic=True) is x
    assert dropout(x, 0.0, torch.Generator()) is x
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    y = dropout(x, 0.3, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    gen.set_state(state)
    assert torch.equal(dropout(x, 0.3, gen), y)
    assert not torch.equal(dropout(x, 0.3, gen), y)   # the state moved on
    assert dropout(x.to(torch.bfloat16), 0.5, gen).dtype == torch.bfloat16


def test_glorot_bounds_and_determinism():
    shape = (64, 3, 48)
    limit = np.sqrt(6.0 / (64 + 48))
    w = glorot(shape, torch.float32, torch.Generator().manual_seed(0))
    assert w.shape == shape and w.dtype == torch.float32
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.01 * limit
    assert torch.equal(w, glorot(shape, torch.float32,
                                 torch.Generator().manual_seed(0)))
    jw = np.asarray(jlayers.glorot(jax.random.PRNGKey(0), shape,
                                   jnp.float32))
    assert np.abs(jw).max() <= limit          # the same bound as JAX's
    assert glorot(shape, torch.bfloat16).dtype == torch.bfloat16


def test_embedding_apply_and_unembed_match_jax():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    p, jp = {"table": _t(table)}, {"table": table}
    np.testing.assert_array_equal(
        embedding_apply(p, _t(ids).long()).numpy(),
        np.asarray(jlayers.embedding_apply(jp, ids)))
    np.testing.assert_allclose(unembed_apply(p, _t(x)).numpy(),
                               np.asarray(jlayers.unembed_apply(jp, x)),
                               rtol=RTOL, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert embedding_init(gen, 50, 16)["table"].shape == (50, 16)


# -- tree helpers -------------------------------------------------------------


def _trees():
    rng = np.random.default_rng(4)
    a = {"w": rng.normal(size=(4, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32),
         "h": rng.normal(size=(2, 3)).astype(np.float16)}
    b = {k: (v * 2 + 1).astype(v.dtype) for k, v in a.items()}
    return a, b


def test_tree_helpers_match_jax():
    a, b = _trees()
    ta, tb = ({k: _t(v) for k, v in t.items()} for t in (a, b))
    assert tu.tree_size_bytes(ta) == jtree.tree_size_bytes(a) == 112
    assert tu.tree_count_params(ta) == jtree.tree_count_params(a) == 31
    for name, args, jargs in (
            ("tree_add", (ta, tb), (a, b)),
            ("tree_scale", (ta, 0.5), (a, 0.5)),
            ("tree_cast", (ta, torch.float16), (a, jnp.float16)),
            ("tree_zeros_like", (ta,), (a,)),
            ("tree_zeros_like", (ta, torch.float64), None)):
        got = getattr(tu, name)(*args)
        assert sorted(got) == sorted(a)
        if jargs is None:
            assert all(v.dtype == torch.float64 and not v.any()
                       for v in got.values())
            continue
        want = getattr(jtree, name)(*jargs)
        for k in a:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(want[k], np.float32),
                                       rtol=1e-3 if k == "h" else RTOL)
    np.testing.assert_allclose(float(tu.tree_global_norm(ta)),
                               float(jtree.tree_global_norm(a)), rtol=RTOL)


# -- the legacy entry point ---------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_train_gnn_matches_jax(monkeypatch):
    """``train_gnn("cora", "gcn", "global", steps=30, hidden=32)`` in both
    packages (the JAX one of ``tests/test_system.py:119``), evaluated at
    every step: the same dict keys, every step's loss within
    ``TRAIN_TOL`` and the test accuracy within 1e-6, from the JAX
    package's initial weights, loaded into the port's model."""
    make = port_models.make_gnn

    def jax_initialised(cfg, seed=0, **kw):
        jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(JaxConfig)
                            if f.name != "aggregate_backend"})
        params = jax_make_gnn(jcfg).init(jax.random.PRNGKey(seed),
                                         cfg.feature_dim)
        return load_jax_params(make(cfg, seed=seed, **kw), _np(params))

    monkeypatch.setattr(port_models, "make_gnn", jax_initialised)
    kw = dict(steps=30, hidden=32, eval_every=1)
    want = jax_train_gnn("cora", "gcn", "global", **kw)
    got = train_gnn("cora", "gcn", "global", device="cpu", **kw)
    assert sorted(got) == sorted(want) == ["final_acc", "graph", "history",
                                           "model", "params", "wall_s"]
    assert [h["step"] for h in got["history"]] == \
        [h["step"] for h in want["history"]] == list(range(1, 31))
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    np.testing.assert_allclose([h["test_acc"] for h in got["history"]],
                               [h["test_acc"] for h in want["history"]],
                               atol=1e-6)
    assert got["final_acc"] == pytest.approx(want["final_acc"], abs=1e-6)
    assert got["final_acc"] > 0.6
    assert next(got["model"].parameters()).device.type == "cpu"
