"""The Sum stage's public segment primitives and ``combine_messages``
(``repro_torch.core.tgar``) against ``repro.core.tgar``'s, on the CPU.

The same numpy inputs go through both packages, forward and gradients
(``jax.grad`` against ``torch.autograd``), at rtol 1e-5, atol 1e-6; a
max exactly. Each case runs twice: the plain path that CPU tensors take,
and the kernels' route that CUDA tensors take (the plan built from the
ids, the kernel wrappers' plain versions standing in for the kernels on
CPU tensors), forced by patching ``tgar._on_card``. The inputs hold
unsorted ids, a negative id and ids at and past ``num_segments`` (JAX
drops them), empty segments (-inf under max), ROADMAP C.1's tie case,
(E, H, D) means with and without weights, and all-masked softmax rows.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tgar as jtgar
from repro.kernels.ops import build_csc_plan as jax_plan
from repro_torch.core import tgar
from repro_torch.kernels import ops
from repro_torch.kernels.plan import build_csc_plan

RTOL, ATOL = 1e-5, 1e-6
E, N, H, D = 64, 11, 3, 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["plain", "kernel route"])
def route(request, monkeypatch):
    if request.param == "kernel route":
        monkeypatch.setattr(tgar, "_on_card", lambda t: True)
    return request.param


def _ids(seed=0):
    """Unsorted ids over rows 0..N-3 (N-2 and N-1 stay empty), with a
    negative id and ids at and past N."""
    ids = np.random.default_rng(seed).integers(0, N - 2, E).astype(np.int32)
    ids[[3, 17, 40]] = [-1, N, N + 4]
    return ids


KEPT = (_ids() >= 0) & (_ids() < N)


def _rand(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _grads(jfn, tfn, arrays, g):
    """Forward and gradients of ``sum(f(*arrays) * g)`` in both packages,
    with -inf outputs read as 0 in the sum."""
    def jloss(*xs):
        out = jfn(*xs)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * g)
    jout = np.asarray(jfn(*map(jnp.asarray, arrays)))
    jgrad = [np.asarray(x) for x in jax.grad(
        jloss, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))]
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = tfn(*ts)
    (torch.where(torch.isfinite(out), out, torch.zeros_like(out))
     * torch.from_numpy(g)).sum().backward()
    return jout, jgrad, out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape", [(E,), (E, D), (E, H, D)])
def test_segment_sum_matches_jax(route, shape):
    ids = _ids()
    x = _rand(*shape)
    g = _rand(N, *shape[1:], seed=2)
    jout, (jg,), out, (grad,) = _grads(
        lambda a: jtgar.segment_sum(a, ids, N),
        lambda a: tgar.segment_sum(a, torch.from_numpy(ids), N), [x], g)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, jg, rtol=RTOL, atol=ATOL)
    assert not grad[~KEPT].any()          # dropped ids take no gradient


@pytest.mark.parametrize("shape,weighted", [((E, D), False),
                                            ((E, H, D), False),
                                            ((E, H, D), True)])
def test_segment_mean_matches_jax(route, shape, weighted):
    """The count broadcasts over every trailing axis ((N, 1, 1) for (E, H,
    D) messages, ``tests/test_tgar.py:131``); ``weights`` replace the
    ones and take their own gradient."""
    ids = _ids()
    x = _rand(*shape)
    g = _rand(N, *shape[1:], seed=2)
    arrays = [x] + ([np.abs(_rand(E, seed=3)) + 0.1] if weighted else [])
    jout, jg, out, grads = _grads(
        lambda a, *w: jtgar.segment_mean(a, ids, N, *w),
        lambda a, *w: tgar.segment_mean(a, torch.from_numpy(ids), N, *w),
        arrays, g)
    assert out.shape == (N,) + shape[1:]
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(E,), (E, D), (E, H, D)])
def test_segment_max_matches_jax_exactly(route, shape):
    """Forward and gradient exactly; empty segments are -inf. Data drawn
    from a few values, so that rows hold ties."""
    ids = _ids()
    x = np.round(_rand(*shape) * 2).astype(np.float32)
    g = _rand(N, *shape[1:], seed=2)
    jout, (jg,), out, (grad,) = _grads(
        lambda a: jtgar.segment_max(a, ids, N),
        lambda a: tgar.segment_max(a, torch.from_numpy(ids), N), [x], g)
    np.testing.assert_array_equal(out, jout)
    assert np.isneginf(out[N - 2:]).all()
    np.testing.assert_array_equal(grad, jg)


def test_segment_max_tie_rule_is_jaxs(route):
    """ROADMAP C.1: ids [0,0,0,1], data [1,3,3,2] -> [0,.5,.5,1] under
    ``jax.ops.segment_max``; the public op splits the tie on both routes
    (the ``csc`` backend's pair would give [0,1,1,1])."""
    ids = np.array([0, 0, 0, 1], np.int32)
    x = np.array([1, 3, 3, 2], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jtgar.segment_max(a, ids, 2)))(x))
    np.testing.assert_array_equal(want, [0, .5, .5, 1])
    t = torch.from_numpy(x).requires_grad_()
    tgar.segment_max(t, torch.from_numpy(ids), 2).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)


def _softmax_inputs():
    ids = _ids()
    lg = _rand(E, H) * 3
    v = _rand(E, H, D, seed=2)
    mask = (np.random.default_rng(4).random(E) > 0.3).astype(np.float32)
    mask[ids == 1] = 0.0                  # row 1 all masked
    mask[ids == 0] = 1.0                  # row 0 active
    mask[np.flatnonzero(ids == 0)[0]] = 0.5   # a fractional weight
    return ids, lg, v, mask


def test_segment_softmax_matches_jax(route):
    """Forward and the gradients of logits, values and the mask, on the
    kept edges: JAX's gradient of a dropped edge is NaN (its gather of
    the row max reads past the end), the port's 0. On the kernels' route
    the mask's gradient on an all-masked row is 0, where JAX's is a
    derivative through the 1e-9 clamp."""
    ids, lg, v, mask = _softmax_inputs()
    g = _rand(N, H, D, seed=5)
    jout, jg, out, grads = _grads(
        lambda a, b, m: jtgar.segment_softmax(a, b, ids, N, m),
        lambda a, b, m: tgar.segment_softmax(a, b, torch.from_numpy(ids),
                                             N, m), [lg, v, mask], g)
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    assert not out[1].any() and not out[N - 2:].any()
    kept = KEPT & ((ids != 1) if route == "kernel route" else True)
    for i, (a, b) in enumerate(zip(grads, jg)):
        rows = KEPT if i < 2 else kept
        np.testing.assert_allclose(a[rows], b[rows], rtol=RTOL, atol=ATOL)
        assert not a[~KEPT].any()


def test_segment_softmax_all_masked_rows_give_zero(route):
    """Every row all masked: 0 under the 1e-9 clamp and under the
    kernel's 1e-20 (ROADMAP C.3)."""
    ids, lg, v, _ = _softmax_inputs()
    zero = np.zeros(E, np.float32)
    want = np.asarray(jtgar.segment_softmax(lg, v, ids, N, zero))
    got = tgar.segment_softmax(torch.from_numpy(lg), torch.from_numpy(v),
                               torch.from_numpy(ids), N,
                               torch.from_numpy(zero))
    assert not want.any() and not got.numpy().any()


def test_kernel_route_plans_the_ids_and_counts_its_kernels(monkeypatch):
    """The kernels' route goes through the plan's wrappers: the forward
    and backward of each op name the kernels a CUDA call launches
    (``segment_sum`` + ``segment_sum_bwd``; ``segment_max`` forward and
    the tie split's ``segment_sum`` + ``segment_sum_bwd``;
    ``edge_softmax`` + ``edge_softmax_bwd``), never the ``csc``
    backend's ``segment_max_bwd``."""
    monkeypatch.setattr(tgar, "_on_card", lambda t: True)
    seen = []
    monkeypatch.setattr(ops, "kernel_scope", _recording(seen))
    ids, lg, v, mask = _softmax_inputs()
    tid = torch.from_numpy(ids)
    x = torch.from_numpy(_rand(E, D)).requires_grad_()
    tgar.segment_sum(x, tid, N).sum().backward()
    tgar.segment_max(x, tid, N).clamp_min(-1e3).sum().backward()
    lt = torch.from_numpy(lg).requires_grad_()
    tgar.segment_softmax(lt, torch.from_numpy(v), tid, N,
                         torch.from_numpy(mask)).sum().backward()
    assert seen == ["segment_sum", "segment_sum_bwd", "segment_max",
                    "segment_sum_bwd", "segment_sum", "segment_sum_bwd",
                    "edge_softmax", "edge_softmax_bwd"]


def _recording(seen):
    import contextlib

    @contextlib.contextmanager
    def scope(name, route, *operands):
        seen.append(name)
        yield
    return scope


def test_negative_ids_reach_the_plan_as_pad_edges():
    segs = tgar._segments(torch.from_numpy(_ids()), N, "cpu")
    assert segs.plan.num_real_edges == int(KEPT.sum())
    np.testing.assert_array_equal(segs.kept.numpy(), KEPT)
    assert tgar._segments(torch.arange(4), 4, "cpu").kept is None


# -- combine_messages ---------------------------------------------------------


def _msg(mode, seed=0):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N - 2, E).astype(np.int32)
    value = rng.normal(size=(E, H, D)).astype(np.float32)
    if mode == "max":
        value = np.round(value * 2).astype(np.float32)     # ties
    mask = (rng.random(E) > 0.25).astype(np.float32)
    msg = {"value": value}
    if mode == "softmax":
        msg["logit"] = rng.normal(size=(E, H)).astype(np.float32)
    return dst, msg, mask


# (backend, whether both packages are given the plan, the port's route):
# the first three on the plain route without a plan keep their names
COMBINE_CASES = [pytest.param(b, given, on_card, id=str(b) + (
    "" if not (given or on_card) else
    "-" + ("the same plan" if given else "no plan")
    + ("-kernel route" if on_card else "-plain")))
    for on_card in (False, True) for given in (False, True)
    for b in (None, "reference", "csc")]


@pytest.mark.parametrize("backend,given,on_card", COMBINE_CASES)
@pytest.mark.parametrize("mode", ["sum", "mean", "max", "softmax"])
def test_combine_messages_matches_jax(mode, backend, given, on_card,
                                      monkeypatch):
    """Both packages get the same plan, built from ``dst``, or none.
    ``backend=None`` is ``"reference"`` in both, and ``"csc"`` without
    a plan the reference's segment math (the JAX ``csc`` backend's
    fallback); with a plan the ``csc`` kernels run over it (the
    ``reference`` backend ignores one). Forward and the messages'
    gradients, on the plain route and on the kernels' (where the port
    plans ``dst`` itself); under ``max`` the forward and the gradients
    exactly: the even tie split where the reference's math runs (C.1),
    the whole cotangent to every tie where the ``csc`` kernel does."""
    if on_card:
        monkeypatch.setattr(tgar, "_on_card", lambda t: True)
    dst, msg, mask = _msg(mode)
    g = _rand(N, H, D, seed=7)
    layer = types.SimpleNamespace(combine=mode)
    jplan = jax_plan(dst, N) if given else None
    tplan = build_csc_plan(dst, N) if given else None
    keys = sorted(msg)

    def jfn(*xs):
        return jtgar.combine_messages(layer, dict(zip(keys, xs)), dst, N,
                                      mask, backend=backend, plan=jplan)

    def tfn(*xs):
        return tgar.combine_messages(layer, dict(zip(keys, xs)),
                                     torch.from_numpy(dst), N,
                                     torch.from_numpy(mask),
                                     backend=backend, plan=tplan)
    jout, jg, out, grads = _grads(jfn, tfn, [msg[k] for k in keys], g)
    if mode == "max":
        np.testing.assert_array_equal(out, jout)
    else:
        np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    for a, b in zip(grads, jg):
        if mode == "max":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_combine_messages_takes_a_given_plan(monkeypatch):
    """A plan passed in is used as it is, not rebuilt; without one the
    kernels' route plans ``dst`` once a call, whatever the mode's count
    of segment passes."""
    dst, msg, mask = _msg("softmax")
    plan = build_csc_plan(dst, N)
    built = []
    monkeypatch.setattr(tgar, "build_csc_plan",
                        lambda *a: built.append(a) or build_csc_plan(*a))
    t = {k: torch.from_numpy(v) for k, v in msg.items()}
    for mode in ("sum", "mean", "softmax"):
        layer = types.SimpleNamespace(combine=mode)
        got = tgar.combine_messages(layer, t, torch.from_numpy(dst), N,
                                    torch.from_numpy(mask), backend="csc",
                                    plan=plan)
        want = tgar.agg.combine(mode, t, torch.from_numpy(dst), N,
                                torch.from_numpy(mask), backend="csc",
                                plan=plan)
        assert not built
        assert torch.equal(got, want)
    monkeypatch.setattr(tgar, "_on_card", lambda t: True)
    for mode in ("sum", "mean", "max", "softmax"):
        layer = types.SimpleNamespace(combine=mode)
        tgar.combine_messages(layer, t, torch.from_numpy(dst), N,
                              torch.from_numpy(mask), backend="csc")
    assert len(built) == 4
