"""The port's segment-max kernel pair and its deterministic gather
backward against the JAX package.

On the CPU the wrappers run the kernels' plain versions
(``repro_torch.kernels.ref``); they are held against the JAX package's
Pallas kernels run in interpret mode: the forward exactly (a max is
exact, whatever the order), the backward within 1e-6. The cases cover
ties, empty and all-masked rows, a bucket's pad edges, NaN entries, no
edges, and widths 8, 130 and 256. ``gradcheck`` holds the autograd
Function to finite differences in float64, on tie-free data. The tests
marked ``cuda`` hold each CUDA kernel against its plain version on the
card and skip where there is none:

    python -m pytest -m cuda tests/test_torch_max.py
"""
import numpy as np
import pytest
import torch

try:
    import jax  # noqa: F401 — the oracle, kept on the CPU
    import jax.numpy as jnp
    from repro.core.aggregate import get_backend as jax_backend
    from repro.kernels import ops as jops
except ImportError:      # a machine without the JAX package: only the
    jops = None          # card-side tests below can run there

from repro_torch.core.aggregate import _CSCSegmentMax, get_backend
from repro_torch.core.tgar import _PlannedGather, tree_take
from repro_torch.kernels import ops
from repro_torch.kernels.plan import build_bucket_csc_plan, build_csc_plan
from repro_torch.kernels.ref import (NEG, segment_max_bwd_ref,
                                     segment_max_ref)

BWD_TOL = 1e-6

# name -> (nodes, edges, trailing shape, extra); extra: "ties" draws the
# data from {0, 1, 2}, "all_masked" sets every edge of rows 0..19 to NEG
# (the combine's mask), "bucket" pads the edge axis with garbage pad edges
# that join no row, "nan" puts NaN in a few entries
CASES = {
    "multihead": (150, 600, (4, 8), ""),
    "ties": (100, 800, (8,), "ties"),
    "empty_rows": (300, 100, (2, 8), ""),
    "all_masked_rows": (100, 400, (8,), "all_masked"),
    "bucket_pad": (100, 300, (4, 8), "bucket"),
    "nan": (80, 400, (8,), "nan"),
    "width_130": (120, 400, (130,), ""),
    "width_256": (60, 300, (256,), "ties"),
    "no_edges": (50, 0, (8,), ""),
}
LAYOUTS = ("contiguous", "transposed", "expanded")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oracle():
    if jops is None:
        pytest.skip("the JAX package (the oracle) is not installed")
    return jops


def _case(name: str, seed: int = 0):
    """numpy inputs: (ids (E_all,), n_rows, data (E_all, ...), g (n, ...),
    bucket (n_pad, e_pad) or None)."""
    n, e, trailing, extra = CASES[name]
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if extra != "bucket":
        ids = rng.permutation(ids).astype(np.int32)    # unsorted edge axis
    if extra == "ties":
        data = rng.integers(0, 3, (e,) + trailing).astype(np.float32)
    else:
        data = rng.normal(size=(e,) + trailing).astype(np.float32)
    if extra == "all_masked":
        data[ids < 20] = NEG
    elif extra == "nan":
        data.reshape(e, -1)[rng.choice(e, 6, replace=False),
                            rng.integers(0, 8, 6)] = np.nan
    bucket = None
    if extra == "bucket":
        n, e_pad = 128, 512
        data = np.concatenate(
            [data, rng.normal(size=(e_pad - e,) + trailing).astype(
                np.float32)])
        ids = np.concatenate([ids, np.full(e_pad - e, n, np.int32)])
        bucket = (n, e_pad)
    g = rng.normal(size=(n,) + trailing).astype(np.float32)
    return ids, n, data, g, bucket


def _plans(ids, n, bucket, jax_plans=True):
    if bucket is None:
        plan = build_csc_plan(ids, n)
        jplan = jops.build_csc_plan(ids, n) if jax_plans else None
    else:
        real = ids[ids < bucket[0]]
        plan = build_bucket_csc_plan(real, *bucket)
        jplan = (jops.build_bucket_csc_plan(real, *bucket) if jax_plans
                 else None)
    return plan, jplan


def _cotangent(g: np.ndarray, layout: str) -> torch.Tensor:
    """The same values, laid out as autograd might hand them over."""
    if layout == "transposed":
        t = torch.from_numpy(np.ascontiguousarray(g.T))
        return t.permute(*reversed(range(t.dim())))
    if layout == "expanded":
        return torch.from_numpy(g[:1].copy()).expand(g.shape)
    return torch.from_numpy(g)


def _jax_forward(oracle, data, jplan, n):
    if len(data):
        return np.asarray(oracle.segment_max_op(data, jplan, interpret=True))
    # the reference wrapper cannot fold an empty edge axis; its kernel
    # takes one
    from repro.kernels.segment_sum import segment_max_csc
    flat = data.reshape(0, int(np.prod(data.shape[1:])))
    return np.asarray(segment_max_csc(
        flat, jplan.gather_idx, jplan.local_ids, jplan.num_blocks,
        jplan.block_n, interpret=True))[:n].reshape((n,) + data.shape[1:])


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_max_matches_pallas_kernel(name, oracle):
    """Exactly: a max picks one of its inputs, in any order; NaN rows are
    NaN on both sides and empty rows NEG."""
    ids, n, data, _, bucket = _case(name)
    plan, jplan = _plans(ids, n, bucket)
    want = _jax_forward(oracle, data, jplan, n)
    got = ops.segment_max_op(torch.from_numpy(data), plan).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name == "nan":
        assert np.isnan(got).any()
    if name in ("empty_rows", "no_edges"):
        empty = np.bincount(ids, minlength=n) == 0
        assert (got[empty] == np.float32(NEG)).all()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_max_bwd_matches_pallas_kernel(name, layout, oracle):
    ids, n, data, g, bucket = _case(name)
    plan, jplan = _plans(ids, n, bucket)
    fwd = ops.segment_max_op(torch.from_numpy(data), plan)
    gt = _cotangent(g, layout)
    got = ops.segment_max_bwd_op(gt, fwd, torch.from_numpy(data), plan)
    if len(data):
        want = np.asarray(oracle.segment_max_bwd_op(
            gt.numpy(), fwd.numpy(), data, jplan, interpret=True))
    else:
        want = np.zeros_like(data)
    assert got.shape == want.shape == data.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=BWD_TOL, atol=BWD_TOL)
    if name == "ties":       # every tied maximum gets the row's cotangent
        hits = data == fwd.numpy()[ids]
        per_row = np.zeros(g.shape)
        np.add.at(per_row, ids, hits)
        assert (per_row > 1).any()
        np.testing.assert_array_equal(got.numpy(), gt.numpy()[ids] * hits)


def test_tie_rule_of_each_backend(oracle):
    """ROADMAP C.1's example: ids [0,0,0,1], data [1,3,3,2]. The csc
    kernel (and its plain version) give each tied maximum the full
    cotangent, as the JAX csc kernel does; the reference backend splits
    it evenly, as the JAX reference backend does."""
    ids = np.array([0, 0, 0, 1], np.int32)
    data = np.array([[1.0], [3.0], [3.0], [2.0]], np.float32)
    plan, jplan = build_csc_plan(ids, 2), jops.build_csc_plan(ids, 2)
    want = {}
    for be, kw in (("csc", dict(plan=jplan)), ("reference", {})):
        b = jax_backend(be)
        want[be] = np.asarray(jax.grad(lambda x: jnp.sum(
            b.segment_max(x, jnp.asarray(ids), 2, **kw)))(data))[:, 0]
    np.testing.assert_array_equal(want["csc"], [0, 1, 1, 1])
    np.testing.assert_array_equal(want["reference"], [0, .5, .5, 1])
    for be in ("csc", "reference"):
        x = torch.from_numpy(data).requires_grad_()
        get_backend(be).segment_max(x, torch.from_numpy(ids), 2,
                                    plan).sum().backward()
        np.testing.assert_array_equal(x.grad.numpy()[:, 0], want[be])


def test_no_rows_give_zero_gradients():
    plan = build_csc_plan(np.zeros(6, np.int32), 0)
    g = torch.zeros(0, 4)
    got = ops.segment_max_bwd_op(g, g, torch.randn(6, 4), plan)
    assert got.shape == (6, 4) and not got.any()
    assert ops.segment_max_op(torch.randn(6, 4), plan).shape == (0, 4)


def test_max_wrappers_validate_shapes():
    ids, n, data, g, _ = _case("multihead")
    plan = build_csc_plan(ids, n)
    d, gt = torch.from_numpy(data), torch.from_numpy(g)
    fwd = ops.segment_max_op(d, plan)
    with pytest.raises(ValueError, match="edge axis"):
        ops.segment_max_op(d[1:], plan)
    with pytest.raises(ValueError, match="segment axis"):
        ops.segment_max_bwd_op(gt[1:], fwd, d, plan)
    with pytest.raises(ValueError, match="edge axis"):
        ops.segment_max_bwd_op(gt, fwd, d[1:], plan)
    with pytest.raises(ValueError, match="do not fit"):
        ops.segment_max_bwd_op(gt, fwd[:, :2], d, plan)


def test_cpu_max_wrappers_launch_nothing():
    ids, n, data, g, _ = _case("multihead")
    plan = build_csc_plan(ids, n)
    before = dict(ops.launches)
    fwd = ops.segment_max_op(torch.from_numpy(data), plan)
    ops.segment_max_bwd_op(torch.from_numpy(g), fwd, torch.from_numpy(data),
                           plan)
    assert ops.launches == before


# -- the autograd Functions ---------------------------------------------------


def _tie_free(name: str):
    """A float64 case without ties: distinct values on every edge."""
    ids, n, data, _, _ = _case(name)
    ids, data = ids[:80], data[:80]
    n = min(n, 30)
    ids = ids % n
    rng = np.random.default_rng(1)
    vals = rng.permutation(data[..., :3].size).reshape(data[..., :3].shape)
    return build_csc_plan(ids, n), torch.from_numpy(
        vals.astype(np.float64) * 0.01).requires_grad_()


@pytest.mark.parametrize("name", ["multihead", "empty_rows", "width_130"])
def test_segment_max_function_passes_gradcheck_in_float64(name):
    plan, x = _tie_free(name)
    assert torch.autograd.gradcheck(
        lambda v: _CSCSegmentMax.apply(v, plan), (x,), eps=1e-6, atol=1e-6)


def test_segment_max_function_honours_needs_input_grad():
    plan, x = _tie_free("multihead")
    out = _CSCSegmentMax.apply(x.detach(), plan)
    assert not out.requires_grad
    # without ties the rule agrees with torch's own amax backward
    a = torch.autograd.grad(_CSCSegmentMax.apply(x, plan).sum(), x)[0]
    b = torch.autograd.grad(segment_max_ref(
        x.flatten(1), plan.perm, plan.indptr, plan.num_segments).sum(), x)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["src", "dst"])
@pytest.mark.parametrize("shape", [(7,), (4, 3), ()])
def test_planned_gather_grad_matches_index_select(which, shape):
    """The gather's segment-sum backward equals torch's ``index_select``
    backward, on real edges and on a bucket's pad edges (ids past the
    rows: they join no row of the plan, and their cotangent is 0 as the
    combine masks it)."""
    rng = np.random.default_rng(3)
    n, e, e_pad = 40, 150, 192
    ids = rng.integers(0, n, e).astype(np.int32)
    if which == "dst":
        ids = np.sort(ids)
    plan = build_bucket_csc_plan(ids, n, e_pad)
    idx = torch.from_numpy(np.concatenate([ids, np.zeros(e_pad - e,
                                                         np.int32)]))
    v = torch.from_numpy(rng.normal(size=(n,) + shape)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(e_pad,) + shape))
    g[e:] = 0.0
    got = torch.autograd.grad((tree_take({"v": v}, idx, plan)["v"] * g).sum(),
                              v)[0]
    want = torch.autograd.grad((v.index_select(0, idx) * g).sum(), v)[0]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda x: _PlannedGather.apply(x, idx[:e], build_csc_plan(ids, n)),
        (v,), eps=1e-6, atol=1e-6)
    # with no gradient to take it is index_select, whatever the plan
    with torch.no_grad():
        assert torch.equal(tree_take({"v": v}, idx, plan)["v"],
                           v.index_select(0, idx))


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_max_kernels_match_plain_versions(name, layout, cuda):
    ids, n, data, g, bucket = _case(name)
    plan, _ = _plans(ids, n, bucket, jax_plans=False)
    plan = plan.to(cuda)
    d = torch.from_numpy(data).to(cuda)
    gt = _cotangent(g, layout).to(cuda)
    before = dict(ops.launches)
    fwd = ops.segment_max_op(d, plan)
    got = ops.segment_max_bwd_op(gt, fwd, d, plan)
    torch.cuda.synchronize()
    flat = d.flatten(1)
    want = segment_max_ref(flat, plan.perm, plan.indptr, plan.num_segments)
    torch.testing.assert_close(fwd.flatten(1), want, rtol=0, atol=0,
                               equal_nan=True)
    gc = gt.contiguous().flatten(1)
    torch.testing.assert_close(
        got.flatten(1), segment_max_bwd_ref(gc, want, flat, plan.edge_dst),
        rtol=0, atol=0)
    assert ops.launches["segment_max"] == before["segment_max"] + 1
    assert ops.launches["segment_max_bwd"] == (before["segment_max_bwd"]
                                               + int(len(ids) > 0))


@pytest.mark.cuda
def test_cuda_max_kernels_are_deterministic(cuda):
    ids, n, data, g, _ = _case("ties")
    plan = build_csc_plan(ids, n).to(cuda)
    d = torch.from_numpy(data).to(cuda)
    gt = torch.from_numpy(g).to(cuda)
    a, b = ops.segment_max_op(d, plan), ops.segment_max_op(d, plan)
    assert torch.equal(a, b)
    assert torch.equal(ops.segment_max_bwd_op(gt, a, d, plan),
                       ops.segment_max_bwd_op(gt, a, d, plan))


@pytest.mark.cuda
def test_cuda_planned_gather_backward_is_deterministic(cuda):
    """The gather backward on the card: the segment_sum kernel over the
    source plan, the same bits on every run, within float32 rounding of
    index_select's atomic backward."""
    rng = np.random.default_rng(4)
    n, e = 2000, 60000
    ids = rng.integers(0, n, e).astype(np.int32)
    plan = build_csc_plan(ids, n).to(cuda)
    idx = torch.from_numpy(ids).to(cuda)
    v = torch.randn(n, 128, device=cuda, requires_grad=True)
    g = torch.randn(e, 128, device=cuda)
    before = ops.launches["segment_sum"]
    runs = [torch.autograd.grad((tree_take({"v": v}, idx, plan)["v"]
                                 * g).sum(), v)[0] for _ in range(2)]
    assert ops.launches["segment_sum"] == before + 2
    assert torch.equal(runs[0], runs[1])
    want = torch.autograd.grad((v.index_select(0, idx) * g).sum(), v)[0]
    torch.testing.assert_close(runs[0], want, rtol=1e-5, atol=1e-5)
