"""The port's expert-parallel MoE dispatch (``repro_torch/arch/moe.py:
moe_ffn_ep`` over ``repro_torch/launch/mesh.py:ExpertMesh``) against the
JAX package's ``moe_ffn_ep`` over a ``jax.sharding.Mesh``.

- On a 1 x 1 mesh in this process, and on 2 x 2 (the batch split over
  ``data``) and 1 x 4 meshes from one subprocess with four host devices,
  for E in {2, 4, 8, 16} and top-k in {1, 2, 4}, at capacity factors
  8.0 (nothing drops: EP equals the port's dense dispatch too), 1.25 and
  1.0: outputs within 1e-4 of max(|y|, 1) and aux within 1e-5, the
  reference's own tolerances (``tests/test_arch_consistency.py``). At
  1.25 and 1.0 the dropped (token, expert) pairs are counted in both
  packages (the reference's by its capacity rule, ``repro/arch/moe.py:
  86-93``, over its own gates) and must be equal and above 0, and EP
  must part from dense by more than 1e-2 of max|y|, so the drops are
  exercised.
- ``dp_axis=None`` (the reference's default: every data row holds the
  whole batch) at 2 x 2 against the reference.
- Gradients of ``sum(out * r) + aux`` with respect to x and the four
  weights against ``jax.grad`` at 2 x 2, within 1e-4 of each max.
- The model: reduced Jamba's loss with EP at 1 x 1 (capacity 8.0)
  against the reference's, as ``tests/test_serving_extensions.py``
  holds the reference's to its dense loss; reduced Mixtral's prefill and
  8 decode steps with EP at 1 x 1 against the reference's (the default
  capacity 1.25, so its prefill drops pairs).
- ``ValueError`` where the reference raises: S or B not evenly divisible
  by the mesh (decode at S = 1 over two model ranks), E_pad not a
  multiple of the model axis.
- ``ProcessGroupComm`` over gloo at 2 and 4 processes against
  ``LocalComm``: the outputs and the gradients of x bitwise equal; aux
  and the weight gradients, which the processes sum in another order,
  within 1e-6 of max(1, each one's max).
- A model over a mesh split over processes holds its rank's experts and
  refuses a sequence that does not split, before any exchange.
- An EP prefill and an EP loss's backward, recorded by
  ``repro_torch.analysis``: no host sync, no float64 and no
  accumulating scatter.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from conftest import run_with_devices
from repro.arch import build_model as jax_build_model
from repro.arch import moe as jmoe
from repro.config import MoEConfig as JaxMoEConfig
from repro.config import get_arch_config as jax_arch_config
from repro_torch.analysis.oplog import OpContext, record_ops, run_rules
from repro_torch.arch import build_model
from repro_torch.arch import moe
from repro_torch.config import MoEConfig, get_arch_config
from repro_torch.core.comm import LocalComm
from repro_torch.launch.mesh import ExpertMesh, make_host_mesh
from repro_torch.weights import lm_params_from_jax, params_from_jax

import test_torch_moe_ep_workers as workers

TOL = 1e-4          # outputs, * max(|y|, 1): the reference's own
AUX_TOL = 1e-5
GLOO_TOL = 1e-6
# (experts, top_k): every E in {2, 4, 8, 16}, every k in {1, 2, 4};
# 2 experts pad two dead ones at 4 model ranks, 16 pad none
ROUTINGS = [(2, 1), (4, 1), (4, 2), (8, 2), (8, 4), (16, 4)]
FACTORS = [8.0, 1.25, 1.0]
MESHES = [(2, 2), (1, 4)]
# (experts, top_k, capacity_factor) of the gradient checks at 2 x 2
GRAD_CASES = [(4, 2, 1.25), (2, 1, 8.0), (8, 2, 1.0)]
# (experts, top_k, capacity_factor) at 2 x 2 with ``dp_axis=None``: each
# data row holds the whole batch
WHOLE_BATCH = [(4, 2, 1.25), (8, 2, 1.0)]
# where the reference raises: (name, mesh, experts, B, S) of x
RAISES = [("seq", (1, 2), 4, 4, 3),          # S = 3 over 2 model ranks
          ("batch", (2, 2), 4, 3, 8),        # B = 3 over 2 data rows
          ("decode", (1, 2), 4, 4, 1),       # a decode step's S = 1
          ("experts", (1, 4), 6, 4, 8)]      # E_pad = 6 over 4 ranks


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _seed(E, k, cf):
    return 1000 * E + 10 * k + int(4 * cf)


def _case(E, k, cf):
    return dict(workers.ep_case(E, _seed(E, k, cf)), top_k=k,
                capacity_factor=cf)


def _weights(case):
    """The weights through ``params_from_jax``, as the model's load."""
    return dict(params_from_jax({k: case[k] for k in workers.WEIGHTS}))


def _port(case, mesh, dp_axis="data"):
    """The port's EP output, aux and (dropped, routed) pair counts."""
    cfg = MoEConfig(num_experts=case["router"].shape[1],
                    top_k=case["top_k"],
                    capacity_factor=case["capacity_factor"])
    with moe.count_drops() as log:
        out, aux = moe.moe_ffn_ep(_weights(case), torch.from_numpy(case["x"]),
                                  cfg, mesh, dp_axis=dp_axis)
    (dropped, routed), = log
    return out, aux, int(dropped), int(routed)


def _dense(case):
    cfg = MoEConfig(num_experts=case["router"].shape[1],
                    top_k=case["top_k"])
    return moe.moe_ffn_dense(_weights(case), torch.from_numpy(case["x"]),
                             cfg)[0]


def _check(case, got, aux, dropped, want, want_aux, want_dropped, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got.numpy() - want).max())
    assert err < TOL * scale, (what, err, scale)
    assert abs(float(aux) - float(want_aux)) < AUX_TOL, what
    assert dropped == want_dropped, (what, dropped, want_dropped)
    gap = float((got - _dense(case)).abs().max())
    if case["capacity_factor"] >= 8.0:
        assert dropped == 0 and gap < TOL * scale, (what, gap)
    else:
        assert dropped > 0 and gap > 1e-2 * scale, (what, dropped, gap)


# -- the JAX oracle -----------------------------------------------------------

_ORACLE = r"""
import sys
sys.path.insert(0, TESTS)
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.arch import moe as jmoe
from repro.config import MoEConfig
import test_torch_moe_ep_workers as workers

WEIGHTS = workers.WEIGHTS


def ref_dropped(gates, x, shape, E, k, cf):
    # the reference's capacity rule (repro/arch/moe.py:86-93) over its own
    # gates, cast to x's dtype as it casts them, block by block
    g = np.asarray(gates.astype(x.dtype))
    Dp, M = shape
    B, S, _ = g.shape
    b, s = B // Dp, S // M
    T = b * s
    cap = max(1, int(np.ceil(T * k / E * cf)))
    n = 0
    for d in range(Dp):
        for m in range(M):
            gl = g[d * b:(d + 1) * b, m * s:(m + 1) * s].reshape(T, E)
            sel = gl > 0
            pos = np.cumsum(sel, axis=0) - 1
            n += int(sel.sum() - (sel & (pos < cap)).sum())
    return n


out = {}
devs = jax.devices()
for shape in MESHES:
    mesh = Mesh(np.array(devs[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    for E, k in ROUTINGS:
        for cf in FACTORS:
            c = workers.ep_case(E, 1000 * E + 10 * k + int(4 * cf))
            p = {n: jnp.asarray(c[n]) for n in WEIGHTS}
            x = jnp.asarray(c["x"])
            cfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
            y, aux = jax.jit(lambda p, x: jmoe.moe_ffn_ep(
                p, x, cfg, mesh, axis="model", dp_axis="data"))(p, x)
            g, _ = jmoe.router_gates(p, x, cfg)
            tag = f"{shape[0]}x{shape[1]}/{E}/{k}/{cf}"
            out[tag + "/y"] = np.asarray(y)
            out[tag + "/aux"] = np.asarray(aux)
            out[tag + "/dropped"] = np.asarray(ref_dropped(g, x, shape, E,
                                                           k, cf))

mesh = Mesh(np.array(devs[:4]).reshape(2, 2), ("data", "model"))
for E, k, cf in WHOLE_BATCH:
    c = workers.ep_case(E, 1000 * E + 10 * k + int(4 * cf))
    cfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    y, aux = jax.jit(lambda p, x: jmoe.moe_ffn_ep(p, x, cfg, mesh,
                                                  axis="model"))(
        {n: jnp.asarray(c[n]) for n in WEIGHTS}, jnp.asarray(c["x"]))
    out[f"whole/{E}/{k}/{cf}/y"] = np.asarray(y)
    out[f"whole/{E}/{k}/{cf}/aux"] = np.asarray(aux)

for E, k, cf in GRAD_CASES:
    c = workers.ep_case(E, 1000 * E + 10 * k + int(4 * cf))
    cfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    r = jnp.asarray(c["r"])

    def f(x, p):
        y, aux = jmoe.moe_ffn_ep(p, x, cfg, mesh, axis="model",
                                 dp_axis="data")
        return jnp.sum(y * r) + aux

    gx, gp = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(c["x"]), {n: jnp.asarray(c[n]) for n in WEIGHTS})
    tag = f"grad/{E}/{k}/{cf}"
    out[tag + "/x"] = np.asarray(gx)
    for n in WEIGHTS:
        out[tag + "/" + n] = np.asarray(gp[n])

# where the reference raises
for name, shape, E, rows, cols in RAISES:
    c = workers.ep_case(E, 0)
    mesh = Mesh(np.array(devs[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    try:
        jmoe.moe_ffn_ep({n: jnp.asarray(c[n]) for n in WEIGHTS},
                        jnp.asarray(c["x"][:rows, :cols]),
                        MoEConfig(num_experts=E, top_k=2), mesh,
                        axis="model", dp_axis="data")
        print("RAISED", name, "nothing")
    except ValueError:
        print("RAISED", name, "ValueError")
np.savez(OUT, **out)
print("ALL_OK")
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's results on the 2 x 2 and 1 x 4 meshes, from one
    subprocess with four host devices, and what it raised."""
    path = tmp_path_factory.mktemp("jax_ep") / "out.npz"
    head = (f"TESTS = {str(Path(__file__).parent)!r}\nOUT = {str(path)!r}\n"
            f"MESHES = {MESHES!r}\nROUTINGS = {ROUTINGS!r}\n"
            f"FACTORS = {FACTORS!r}\nGRAD_CASES = {GRAD_CASES!r}\n"
            f"WHOLE_BATCH = {WHOLE_BATCH!r}\nRAISES = {RAISES!r}\n")
    out = run_with_devices(head + _ORACLE, n_devices=4, timeout=600)
    assert "ALL_OK" in out
    raised = dict(line.split()[1:] for line in out.splitlines()
                  if line.startswith("RAISED"))
    return dict(np.load(path)), raised


# -- one rank, in this process ------------------------------------------------


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("E,k", ROUTINGS)
def test_ep_on_one_rank_matches_jax(E, k, cf):
    case = _case(E, k, cf)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jp = {n: jnp.asarray(case[n]) for n in workers.WEIGHTS}
    jx = jnp.asarray(case["x"])
    jcfg = JaxMoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_ffn_ep(
        p, x, jcfg, mesh, axis="model", dp_axis="data"))(jp, jx)
    g, _ = jmoe.router_gates(jp, jx, jcfg)
    sel = np.asarray(g) > 0
    cap = max(1, int(np.ceil(4 * 8 * k / E * cf)))
    want_dropped = int((sel & (np.cumsum(sel.reshape(-1, E), 0) - 1 >= cap)
                        .reshape(sel.shape)).sum())
    got, aux, dropped, routed = _port(case, ExpertMesh(1, 1))
    assert routed == 4 * 8 * k
    _check(case, got, aux, dropped, np.asarray(want), want_aux,
           want_dropped, f"1x1 E={E} k={k} cf={cf}")


# -- 2 x 2 and 1 x 4, against the subprocess ----------------------------------


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("E,k", ROUTINGS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_on_a_mesh_matches_jax(oracle, shape, E, k, cf):
    res, _ = oracle
    case = _case(E, k, cf)
    got, aux, dropped, _ = _port(case, ExpertMesh(*shape))
    tag = f"{shape[0]}x{shape[1]}/{E}/{k}/{cf}"
    _check(case, got, aux, dropped, res[tag + "/y"], res[tag + "/aux"],
           int(res[tag + "/dropped"]), tag)


@pytest.mark.parametrize("E,k,cf", WHOLE_BATCH)
def test_ep_without_a_data_split_matches_jax(oracle, E, k, cf):
    """``dp_axis=None`` on a 2 x 2 mesh: each data row routes the whole
    batch, so the result is the 1 x 2 mesh's."""
    res, _ = oracle
    case = _case(E, k, cf)
    got, aux, dropped, _ = _port(case, ExpertMesh(2, 2), dp_axis=None)
    want = res[f"whole/{E}/{k}/{cf}/y"]
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got.numpy() - want).max()) < TOL * scale
    assert abs(float(aux) - float(res[f"whole/{E}/{k}/{cf}/aux"])) < AUX_TOL
    assert dropped > 0
    one_row = _port(case, ExpertMesh(1, 2))
    assert torch.equal(got, one_row[0]) and dropped == one_row[2]


@pytest.mark.parametrize("E,k,cf", GRAD_CASES)
def test_ep_gradients_match_jax_grad(oracle, E, k, cf):
    res, _ = oracle
    case = _case(E, k, cf)
    got = workers.ep_step(case, ExpertMesh(2, 2), 0, case["x"].shape[1])
    tag = f"grad/{E}/{k}/{cf}"
    for name in ("x",) + workers.WEIGHTS:
        want = res[f"{tag}/{name}"]
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got["grad/" + name] - want).max())
        assert err < TOL * scale, (tag, name, err, scale)
    assert np.abs(got["grad/wo"]).max() > 0


# -- where the reference raises -----------------------------------------------


@pytest.mark.parametrize("name,shape,E,rows,cols", RAISES,
                         ids=[r[0] for r in RAISES])
def test_ep_raises_where_the_reference_raises(oracle, name, shape, E, rows,
                                              cols):
    _, raised = oracle
    assert raised[name] == "ValueError"
    c = workers.ep_case(E, 0)
    p = _weights(c)
    x = torch.from_numpy(c["x"][:rows, :cols].copy())
    with pytest.raises(ValueError, match="evenly divisible|multiple"):
        moe.moe_ffn_ep(p, x, MoEConfig(num_experts=E, top_k=2),
                       ExpertMesh(*shape), dp_axis="data")


def test_model_decode_over_two_model_ranks_raises():
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(dtype="float32")
    model = build_model(cfg, moe_impl="ep", mesh=ExpertMesh(1, 2))
    toks = torch.zeros((2, 4), dtype=torch.long)
    _, caches, idx = model.prefill({"tokens": toks}, cache_len=8)
    with pytest.raises(ValueError, match="evenly divisible"):
        model.decode_step({"tokens": toks[:, :1]}, caches, idx)


def test_the_mesh_follows_make_host_mesh():
    """One data row of one model rank on a host without a card, as the
    reference's ``make_host_mesh`` over one host device."""
    mesh = make_host_mesh()
    assert (mesh.data, mesh.model) == (1, 1)
    assert isinstance(mesh.comm, LocalComm) and mesh.comm.P == 1
    with pytest.raises(ValueError, match="multiple of model_parallel"):
        make_host_mesh(2)
    two = ExpertMesh(2, 2)
    assert isinstance(two.comm, LocalComm) and two.comm.P == 2
    with pytest.raises(ValueError, match="ranks, the model axis"):
        ExpertMesh(1, 2, LocalComm(4))


# -- the model ----------------------------------------------------------------


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _load(cfg, params):
    model = build_model(cfg, moe_impl="ep", mesh=ExpertMesh(1, 1))
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return model


def test_reduced_jamba_ep_loss_matches_jax():
    """Capacity 8.0, as the reference's
    ``test_reduced_jamba_ep_equals_dense_train_loss``: the port's EP loss
    against the reference's EP loss and the port's dense loss."""
    import dataclasses
    arch = "jamba-1.5-large-398b"
    jcfg = jax_arch_config(arch).reduced().replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=8.0))
    cfg = get_arch_config(arch).reduced().replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    jm = jax_build_model(jcfg, moe_impl="ep", mesh=_jax_mesh(), remat=False)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 16))}
    want = float(jm.loss(params, {k: jnp.asarray(v, jnp.int32)
                                  for k, v in batch.items()}))
    model = _load(cfg, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = model.loss(tb, chunk=16)
    got.backward()
    got = float(got.detach())
    assert abs(got - want) < 1e-4 * max(1.0, abs(want)), (
        float(got), want)
    ep_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    dense = build_model(cfg)
    dense.load_state_dict(model.state_dict())
    want_dense = dense.loss(tb, chunk=16)
    want_dense.backward()
    assert abs(got - float(want_dense.detach())) < 1e-5
    for n, p in dense.named_parameters():
        torch.testing.assert_close(ep_grads[n], p.grad, rtol=1e-4,
                                   atol=1e-6, msg=n)


def test_reduced_mixtral_ep_prefill_and_decode_match_jax():
    """Mesh (1, 1) at the default capacity 1.25: the prefill drops pairs
    in both packages; its last logits and 8 decode steps' against the
    reference's within rtol 1e-4 / atol 1e-5."""
    arch = "mixtral-8x7b"
    jcfg = jax_arch_config(arch).reduced().replace(dtype="float32")
    cfg = get_arch_config(arch).reduced().replace(dtype="float32")
    jm = jax_build_model(jcfg, moe_impl="ep", mesh=_jax_mesh(), remat=False)
    params = jm.init(jax.random.PRNGKey(3))
    model = _load(cfg, params)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    P, steps = 16, 8
    jl, jc, jidx = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P],
                                                             jnp.int32)},
                              cache_len=P + steps)
    with moe.count_drops() as log:
        tl, tc, tidx = model.prefill({"tokens": torch.from_numpy(
            toks[:, :P])}, cache_len=P + steps)
    assert sum(int(d) for d, _ in log) > 0
    dense = build_model(cfg)
    dense.load_state_dict(model.state_dict())
    dl, _, _ = dense.prefill({"tokens": torch.from_numpy(toks[:, :P])},
                             cache_len=P + steps)
    assert float((dl - tl).abs().max()) > 1e-3
    close = functools.partial(np.testing.assert_allclose, rtol=1e-4,
                              atol=1e-5)
    close(tl.numpy(), np.asarray(jl), err_msg="prefill")
    for t in range(P, P + steps):
        jl, jc, jidx = jm.decode_step(
            params, {"tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32)},
            jc, jidx)
        tl, tc, tidx = model.decode_step(
            {"tokens": torch.from_numpy(toks[:, t:t + 1])}, tc, tidx)
        close(tl.numpy(), np.asarray(jl), err_msg=f"decode {t}")


# -- ProcessGroupComm over gloo -----------------------------------------------


@pytest.fixture(scope="module", params=[2, 4])
def gloo_ep(request, tmp_path_factory):
    """Every rank's results at ``request.param`` processes (the worker is
    :func:`test_torch_moe_ep_workers.gloo_ep_worker`)."""
    import torch.multiprocessing as mp
    world = request.param
    d = tmp_path_factory.mktemp(f"gloo_ep{world}")
    mp.spawn(workers.gloo_ep_worker, args=(world, str(d / "init"), str(d)),
             nprocs=world, join=True)
    return world, [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


def test_gloo_ep_matches_local_comm(gloo_ep):
    """Each process's block of the output and of x's gradient bitwise
    LocalComm's; aux and the weight gradients (summed over the processes)
    within 1e-6 of max(1, each one's max)."""
    world, ranks = gloo_ep
    for i, (Dp, M, E, k, cf) in enumerate(workers.GLOO_CASES[world]):
        case = dict(workers.ep_case(E, seed=40 + i), top_k=k,
                    capacity_factor=cf)
        want = workers.ep_step(case, ExpertMesh(Dp, M), 0,
                               case["x"].shape[1])
        s = case["x"].shape[1] // M
        for r, got in enumerate(ranks):
            blk = slice(r * s, (r + 1) * s)
            for name in ("out", "grad/x"):
                np.testing.assert_array_equal(
                    got[f"{i}/{name}"], want[name][:, blk],
                    err_msg=f"P={world} case {i} rank {r} {name}")
            for name in ("aux",) + tuple(f"grad/{w}"
                                         for w in workers.WEIGHTS):
                scale = max(float(np.abs(want[name]).max()), 1.0)
                np.testing.assert_allclose(
                    got[f"{i}/{name}"], want[name], rtol=0,
                    atol=GLOO_TOL * scale,
                    err_msg=f"P={world} case {i} rank {r} {name}")


# -- the analysis rules -------------------------------------------------------

_RULES = ["ops.host-transfer", "ops.segment-scatter", "ops.f64-promotion"]
_ACCUMULATING = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_"}


def _accumulating(log):
    return [e.name for e in log if e.name in _ACCUMULATING or (
        e.name in ("index_put", "index_put_", "_index_put_impl_")
        and e.arg("accumulate"))]


def test_ep_records_no_sync_scatter_or_f64():
    """A reduced Mixtral prefill and loss with EP over a 1 x 2 mesh: no
    host sync and no float64 (the embedding's and the cross-entropy's
    backwards are the model's own accumulating scatters); ``moe_ffn_ep``
    and its backward alone: no accumulating scatter either."""
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(dtype="float32")
    model = build_model(cfg, moe_impl="ep", mesh=ExpertMesh(1, 2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    _, log = record_ops(model.prefill, {"tokens": toks}, cache_len=16)
    assert run_rules(OpContext(log, label="ep prefill"), ids=_RULES) == []
    assert not _accumulating(log)
    names = {e.name for e in log}
    assert "searchsorted" in names and "gather" in names
    _, log = record_ops(lambda: model.loss({"tokens": toks, "labels": toks},
                                           chunk=16).backward())
    assert run_rules(OpContext(log, label="ep loss"), ids=_RULES) == []
    assert all(p.grad is not None for n, p in model.named_parameters()
               if "ffn" in n)
    case = _case(8, 2, 1.0)
    _, log = record_ops(workers.ep_step, case, ExpertMesh(2, 2), 0,
                        case["x"].shape[1])
    assert run_rules(OpContext(log, label="ep step"), ids=_RULES) == []
    assert not _accumulating(log)


# -- the model's mesh ---------------------------------------------------------


class _OneRankMesh:
    """A two-rank model axis whose communicator holds one rank, as a
    ``ProcessGroupComm`` of two processes does; it has no collective, so
    a call that reached the exchange would fail otherwise."""
    data, model = 1, 2

    class comm:
        P, start, count = 2, 0, 1


def test_the_model_refuses_a_mesh_split_over_processes():
    """A model whose mesh is split over processes (one model rank here)
    holds only its rank's experts, and refuses, with the reference's
    ``ValueError`` and before any exchange, a sequence that does not
    split over the model ranks: a decode step's S = 1, or an odd S. (The
    split itself runs over gloo in ``test_torch_ranks.py``.)"""
    cfg = get_arch_config("mixtral-8x7b").reduced().replace(dtype="float32")
    model = build_model(cfg, moe_impl="ep", mesh=_OneRankMesh())
    E = cfg.moe.num_experts
    assert model.blocks[0].ffn["wi_gate"].shape[0] == E // 2
    for S in (1, 3):
        toks = torch.zeros((2, S), dtype=torch.long)
        with pytest.raises(ValueError, match="evenly divisible"):
            model.prefill({"tokens": toks}, cache_len=S)
