"""The port's Sum-stage backward kernels against the JAX package's.

On the CPU the backward wrappers run the kernels' plain versions
(``repro_torch.kernels.ref``); they are held, over every edge including a
bucket's pad edges, against the JAX package's Pallas backward kernels
run in interpret mode at rtol/atol 1e-5 (the sums are taken in another
order, so equality is not the bar). A CPU twin walks
``segment_sum_bwd.cu``'s two schedules with the kernel's own units and
gives the plain version's bits (a gather is a copy). ``gradcheck``
holds the two autograd Functions to finite differences in float64. The
tests marked ``cuda`` hold each CUDA kernel against its plain version
on the card (``segment_sum_bwd`` exactly, under both schedules) and
skip where there is none:

    python -m pytest -m cuda tests/test_torch_backward.py
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax  # noqa: F401 — the oracle, kept on the CPU
    from repro.kernels import ops as jops
except ImportError:      # a machine without the JAX package: only the
    jops = None          # card-side tests below can run there

from repro_torch.core.aggregate import _CSCEdgeSoftmax, _CSCSegmentSum
from repro_torch.kernels import ops
from repro_torch.kernels.plan import (PIECE, build_bucket_csc_plan,
                                      build_csc_plan)
from repro_torch.kernels.ref import (NEG, edge_softmax_bwd_ref,
                                     edge_softmax_ref, segment_sum_bwd_ref)

TOL = 1e-5

# name -> (nodes, edges, heads, dim, extra); extra: "mask" masks 30% of
# the edges, "all_masked" every edge of rows 0..19, "bucket" adds pad
# edges with garbage logits and values that read row N - 1
CASES = {
    "multihead": (150, 600, 4, 8, ""),
    "gat_e_width": (200, 900, 4, 8, "mask"),
    "heads_4x16": (120, 500, 4, 16, ""),
    "width_130": (120, 400, 1, 130, ""),
    "empty_rows": (300, 100, 2, 8, ""),
    "all_masked_rows": (100, 400, 4, 8, "all_masked"),
    "bucket_pad": (100, 300, 4, 8, "bucket"),
    "no_edges": (50, 0, 4, 8, ""),
}
# how the cotangent reaches the wrapper
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
    """numpy inputs: (ids (E_all,), n_rows, logits, values, g, bucket)."""
    n, e, h, d, extra = CASES[name]
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if extra != "bucket":
        ids = rng.permutation(ids).astype(np.int32)    # unsorted edge axis
    logits = rng.normal(size=(e, h)).astype(np.float32) * 3
    values = rng.normal(size=(e, h, d)).astype(np.float32)
    masked = np.zeros(e, bool)
    if extra == "mask":
        masked = rng.random(e) < 0.3
    elif extra == "all_masked":
        masked = ids < 20
    logits[masked] = NEG
    values[masked] = 0.0
    bucket = None
    if extra == "bucket":
        n, e_pad = 128, 512
        pad = e_pad - e
        logits = np.concatenate(
            [logits, rng.normal(size=(pad, h)).astype(np.float32)])
        values = np.concatenate(
            [values, rng.normal(size=(pad, h, d)).astype(np.float32)])
        ids = np.concatenate([ids, np.full(pad, n, np.int32)])
        bucket = (n, e_pad)
    g = rng.normal(size=(n, h, d)).astype(np.float32)
    return ids, n, logits, values, g, bucket


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
        t = torch.from_numpy(np.ascontiguousarray(g.transpose(1, 0, 2)))
        return t.transpose(0, 1)
    if layout == "expanded":
        return torch.from_numpy(g[:1].copy()).expand(g.shape)
    return torch.from_numpy(g)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_sum_bwd_matches_pallas_kernel(name, layout, oracle):
    ids, n, _, values, g, bucket = _case(name)
    plan, jplan = _plans(ids, n, bucket)
    gt = _cotangent(g, layout)
    got = ops.segment_sum_bwd_op(gt, plan)
    want = np.asarray(oracle.segment_sum_bwd_op(gt.numpy(), jplan,
                                                interpret=True))
    assert got.shape == want.shape == values.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if bucket is not None:        # pad edges read row N - 1
        pads = ids >= n
        np.testing.assert_array_equal(
            got.numpy()[pads], np.broadcast_to(gt.numpy()[n - 1],
                                               (pads.sum(),) + g.shape[1:]))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_edge_softmax_bwd_matches_pallas_kernel(name, layout, oracle):
    ids, n, logits, values, g, bucket = _case(name)
    plan, jplan = _plans(ids, n, bucket)
    lg, v = torch.from_numpy(logits), torch.from_numpy(values)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    gt = _cotangent(g, layout)
    d_lg, d_v = ops.edge_softmax_bwd_op(gt, lg, v, out, m, den, plan)
    # the JAX backward on the same saved operands and statistics
    w_lg, w_v = (np.asarray(a) for a in oracle.edge_softmax_bwd_op(
        gt.numpy(), logits, values, out.numpy(), m.numpy(), den.numpy(),
        jplan, interpret=True))
    assert d_lg.shape == w_lg.shape and d_v.shape == w_v.shape
    np.testing.assert_allclose(d_lg.numpy(), w_lg, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(d_v.numpy(), w_v, rtol=TOL, atol=TOL)
    if name == "all_masked_rows":      # masked edges get zero gradients
        masked = ids < 20
        assert not d_lg.numpy()[masked].any()
        assert not d_v.numpy()[masked].any()


def test_single_head_backward_matches_pallas_kernel(oracle):
    ids, n, logits, values, g, _ = _case("gat_e_width")
    plan, jplan = _plans(ids, n, None)
    lg, v = torch.from_numpy(logits[:, 0]), torch.from_numpy(values[:, 0])
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    d_lg, d_v = ops.edge_softmax_bwd_op(torch.from_numpy(g[:, 0]), lg, v,
                                        out, m, den, plan)
    w_lg, w_v = oracle.edge_softmax_bwd_op(
        g[:, 0], logits[:, 0], values[:, 0], out.numpy(), m.numpy(),
        den.numpy(), jplan, interpret=True)
    np.testing.assert_allclose(d_lg.numpy(), np.asarray(w_lg), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(d_v.numpy(), np.asarray(w_v), rtol=TOL,
                               atol=TOL)


def test_no_rows_give_zero_gradients():
    """N = 0: every edge is a pad edge with nothing to read."""
    plan = build_csc_plan(np.zeros(6, np.int32), 0)
    g = torch.zeros(0, 2, 4)
    assert not ops.segment_sum_bwd_op(g, plan).any()
    assert ops.segment_sum_bwd_op(g, plan).shape == (6, 2, 4)
    d_lg, d_v = ops.edge_softmax_bwd_op(
        g, torch.randn(6, 2), torch.randn(6, 2, 4), g, torch.zeros(0, 2),
        torch.zeros(0, 2), plan)
    assert d_lg.shape == (6, 2) and d_v.shape == (6, 2, 4)
    assert not d_lg.any() and not d_v.any()


def test_backward_wrappers_validate_shapes():
    ids, n, logits, values, g, _ = _case("multihead")
    plan = build_csc_plan(ids, n)
    lg, v = torch.from_numpy(logits), torch.from_numpy(values)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    with pytest.raises(ValueError, match="segment axis"):
        ops.segment_sum_bwd_op(torch.from_numpy(g[1:]), plan)
    with pytest.raises(ValueError, match="edge axis"):
        ops.edge_softmax_bwd_op(torch.from_numpy(g), lg[1:], v[1:], out, m,
                                den, plan)
    with pytest.raises(ValueError, match="do not fit"):
        ops.edge_softmax_bwd_op(torch.from_numpy(g[1:]), lg, v, out, m, den,
                                plan)


def test_cpu_backward_wrappers_launch_nothing():
    ids, n, logits, values, g, _ = _case("multihead")
    plan = build_csc_plan(ids, n)
    lg, v = torch.from_numpy(logits), torch.from_numpy(values)
    before = dict(ops.launches)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    ops.edge_softmax_bwd_op(torch.from_numpy(g), lg, v, out, m, den, plan)
    ops.segment_sum_bwd_op(torch.from_numpy(g), plan)
    assert ops.launches == before


def _edge_softmax_bwd_twin(g, logits, values, m, den, out, plan):
    """``edge_softmax_bwd.cu``'s walk in float32 numpy over its units:
    each row's first PIECE edges (several rows a warp), then one warp per
    piece p (its row found over piece_ptr, its edges PIECE at a time from
    the row's start), then one per PIECE pad edges past indptr[N], which
    read row N - 1 as the clip does. Each unit takes og = out . g of its
    row once and gives every edge of it p, d_values and d_logits; every
    edge is written once."""
    f = np.float32
    perm, indptr = plan.perm.numpy(), plan.indptr.numpy().astype(np.int64)
    ptr = plan.piece_ptr.numpy().astype(np.int64)
    n, E = plan.num_segments, plan.num_edges
    units = []
    for r in range(n):
        s, e = indptr[r], indptr[r + 1]
        units.append((r, s, min(e, s + PIECE)))
    for p in range(plan.num_pieces):
        r = int(np.searchsorted(ptr[1:], p, side="right"))
        a = indptr[r] + (p - ptr[r] + 1) * PIECE
        units.append((r, a, min(indptr[r + 1], a + PIECE)))
    units += [(n - 1, a, min(E, a + PIECE)) for a in range(indptr[n], E,
                                                           PIECE)]
    d_lg = np.full(logits.shape, np.nan, f)
    d_v = np.full(values.shape, np.nan, f)
    # a pad edge read against an empty last row (m = NEG, den = 0) gets
    # p = inf, as in the kernel, the plain version and the TPU kernel
    with np.errstate(over="ignore"):
        for r, a, b in units:
            _bwd_unit(g, logits, values, m, den, out, perm, r, a, b,
                      d_lg, d_v)
    assert not np.isnan(d_lg).any(), "an edge was never written"
    return d_lg, d_v


def _bwd_unit(g, logits, values, m, den, out, perm, r, a, b, d_lg, d_v):
    """One warp's unit: row r's og, then edges perm[a:b]."""
    f = np.float32
    og = (out[r] * g[r]).sum(-1)
    for e in perm[a:b]:
        assert np.isnan(d_lg[e]).all(), f"edge {e} written twice"
        p = np.where(logits[e] > f(NEG / 2), np.exp(logits[e] - m[r])
                     / np.maximum(den[r], f(1e-20)), f(0))
        d_v[e] = p[:, None] * g[r]
        d_lg[e] = p * ((values[e] * g[r]).sum(-1) - og)


@pytest.mark.parametrize("name", sorted(set(CASES) - {"no_edges"}))
def test_backward_kernel_walk_matches_plain_version(name):
    """The CUDA backward's walk over the destination plan's rows, pieces
    and pad units, run here on the CPU, agrees with the plain version
    (which the oracle tests hold against the JAX kernel) on every edge,
    pad edges with live logits included; a 300-edge hub is cut into
    pieces."""
    ids, n, logits, values, g, bucket = _case(name)
    if bucket is None:                  # a hub among the rows
        ids = np.concatenate([ids, np.full(300, n // 2, np.int32)])
        rng = np.random.default_rng(1)
        logits = np.concatenate([logits, rng.normal(size=(300,) + logits
                                                    .shape[1:]).astype(
                                                        np.float32) * 3])
        values = np.concatenate([values, rng.normal(
            size=(300,) + values.shape[1:]).astype(np.float32)])
    plan, _ = _plans(ids, n, bucket, jax_plans=False)
    lg, v = torch.from_numpy(logits), torch.from_numpy(values)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    got = _edge_softmax_bwd_twin(g, logits, values, m.numpy(), den.numpy(),
                                 out.numpy(), plan)
    want = ops.edge_softmax_bwd_op(torch.from_numpy(g), lg, v, out, m, den,
                                   plan)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=TOL, atol=TOL)
    if bucket is not None:      # pad edges with live logits read row N - 1
        pads = ids >= n
        assert np.abs(logits[pads]).min() < 1e3
        assert np.abs(got[1][pads]).max() > 0
    else:
        assert plan.num_pieces >= 4


def _kernel_piece() -> int:
    """``csrc/row_pieces.cuh``'s kPiece: the twin below walks the
    kernel's own unit size, not a copy of it."""
    src = (Path(ops.__file__).resolve().parent / "csrc" / "row_pieces.cuh")
    m = re.search(r"constexpr\s+int\s+kPiece\s*=\s*(\d+)\s*;",
                  src.read_text())
    assert m, "kPiece not found in row_pieces.cuh"
    return int(m.group(1))


def _segment_sum_bwd_twin(g, plan, schedule: str):
    """``segment_sum_bwd.cu`` in numpy, unit by unit. "rows": each row's
    row unit (its first kPiece edges, one sub-warp), then a warp per
    piece p (its row found over piece_ptr, its edges kPiece at a time
    from the row's start), then a warp per kPiece pad edges past
    indptr[N], which read row N - 1; a warp's S = 32 / L sub-warps (L the
    power of two >= ceil(D / 4), at most 32) take alternate edges of a
    piece or pad unit. "edges": each edge its clipped edge_dst row. Every
    edge is written once, with a copy of its row."""
    piece = _kernel_piece()
    n, E, d = plan.num_segments, plan.num_edges, g.shape[1]
    if n == 0:
        return np.zeros((E, d), np.float32)
    perm, dst = plan.perm.numpy(), plan.edge_dst.numpy()
    indptr = plan.indptr.numpy().astype(np.int64)
    ptr = plan.piece_ptr.numpy().astype(np.int64)
    lanes = 1
    while lanes < 32 and lanes < -(-d // 4):
        lanes *= 2
    subs = 32 // lanes
    out = np.full((E, d), np.nan, np.float32)

    def put(r, edges):
        for e in edges:
            assert np.isnan(out[e]).all(), f"edge {e} written twice"
            out[e] = g[r]

    def warp(r, a, b):
        for sub in range(subs):
            put(r, perm[a + sub:b:subs])

    if schedule == "edges":
        for e in range(E):
            put(min(int(dst[e]), n - 1), [e])
    else:
        for r in range(n):
            put(r, perm[indptr[r]:min(indptr[r + 1], indptr[r] + piece)])
        for p in range(plan.num_pieces):
            r = int(np.searchsorted(ptr[1:], p, side="right"))
            a = indptr[r] + (p - ptr[r] + 1) * piece
            warp(r, a, min(indptr[r + 1], a + piece))
        for a in range(indptr[n], E, piece):
            warp(n - 1, a, min(E, a + piece))
    assert not np.isnan(out).any(), "an edge was never written"
    return out


SUM_BWD_DIMS = (1, 3, 4, 8, 33, 128, 130)
SUM_BWD_HUBS = (130, 412, 2832)


def _sum_bwd_case(name: str, d: int, seed: int = 0):
    """(plan, g (N, d) float32): "hubs" has rows of 130, 412 and 2,832
    edges (the first and the last row among them), rows of 17, 40 and 64,
    short rows, empty rows and 70 pad edges, its edge axis unsorted;
    "no_rows" has N = 0 (every edge a pad edge); "no_edges" E = 0."""
    rng = np.random.default_rng(seed)
    n = 80
    if name == "no_rows":
        return build_csc_plan(np.zeros(6, np.int32), 0), np.zeros((0, d),
                                                                   np.float32)
    if name == "no_edges":
        ids = np.zeros(0, np.int32)
    else:
        ids = [rng.integers(8, n - 8, 300)]
        ids += [np.full(deg, r) for r, deg in zip((0, n - 1, 6),
                                                  SUM_BWD_HUBS)]
        ids += [np.full(deg, r) for r, deg in ((3, 17), (4, 40), (5, 64))]
        ids = np.concatenate(ids)
        ids = rng.permutation(ids[~np.isin(ids, (1, 2, n - 3, n - 2))])
    g = rng.normal(size=(n, d)).astype(np.float32)
    pads = 70 if len(ids) else 0
    return build_bucket_csc_plan(ids.astype(np.int32), n,
                                 len(ids) + pads), g


@pytest.mark.parametrize("schedule", ops.SUM_BWD_SCHEDULES)
@pytest.mark.parametrize("d", SUM_BWD_DIMS)
@pytest.mark.parametrize("name", ["hubs", "no_rows", "no_edges"])
def test_segment_sum_bwd_twin_is_the_plain_version_bitwise(name, d,
                                                          schedule):
    """Both schedules of ``segment_sum_bwd.cu``, walked on the CPU with
    the kernel's units, write every edge once and give the plain
    version's bits: hub rows cut into pieces, empty rows, pad edges
    (row N - 1), N = 0 and E = 0, at widths that give 32, 16, 4 and 1
    sub-warps a warp, ragged last groups (D 1, 3, 33) and a row of more
    groups than a warp has lanes (D 130, two passes)."""
    plan, g = _sum_bwd_case(name, d)
    got = _segment_sum_bwd_twin(g, plan, schedule)
    want = segment_sum_bwd_ref(torch.from_numpy(g), plan.edge_dst).numpy()
    assert got.shape == want.shape == (plan.num_edges, d)
    assert got.tobytes() == want.tobytes()
    if name == "hubs":
        assert plan.num_pieces == sum(-(-(deg - PIECE) // PIECE)
                                      for deg in SUM_BWD_HUBS)
        pads = plan.edge_dst.numpy() == plan.num_segments
        assert pads.sum() == 70 and (got[pads] == g[-1]).all()


# -- the autograd Functions ---------------------------------------------------


def _f64_case(name: str):
    ids, n, logits, values, _, _ = _case(name)
    ids, logits, values = ids[:60], logits[:60], values[:60]
    n = min(n, 40)
    ids = ids % n
    plan = build_csc_plan(ids, n)
    lg = torch.from_numpy(logits.astype(np.float64)).requires_grad_()
    v = torch.from_numpy(values[..., :3].astype(np.float64)).requires_grad_()
    return plan, lg, v


@pytest.mark.parametrize("name", ["multihead", "all_masked_rows",
                                  "empty_rows", "gat_e_width"])
def test_functions_pass_gradcheck_in_float64(name):
    """(A bucket's pad edges are left out: they join no row, so their
    true gradient is 0, while the backward reads row N - 1 for them as
    the TPU kernel does; the combine masks their values to 0.)"""
    plan, lg, v = _f64_case(name)
    assert torch.autograd.gradcheck(
        lambda x: _CSCSegmentSum.apply(x, plan), (v,), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda a, b: _CSCEdgeSoftmax.apply(a, b, plan), (lg, v), eps=1e-6,
        atol=1e-6)


def test_functions_honour_needs_input_grad():
    plan, lg, v = _f64_case("multihead")
    lg.requires_grad_(False)
    _CSCEdgeSoftmax.apply(lg, v, plan).sum().backward()
    assert lg.grad is None and v.grad is not None
    deg = _CSCSegmentSum.apply(torch.ones(plan.num_edges), plan)
    assert not deg.requires_grad


def test_edge_softmax_grad_through_function_matches_autograd_of_plain():
    """The Function's gradients equal torch autograd through the plain
    forward (which saves no statistics): same math, another route."""
    plan, lg, v = _f64_case("gat_e_width")
    g = torch.randn(plan.num_segments, lg.shape[1], v.shape[2],
                    dtype=torch.float64, generator=torch.Generator()
                    .manual_seed(0))
    a_lg, a_v = torch.autograd.grad(
        (_CSCEdgeSoftmax.apply(lg, v, plan) * g).sum(), (lg, v))
    out = edge_softmax_ref(lg, v, plan.perm, plan.indptr,
                           plan.num_segments)[0]
    b_lg, b_v = torch.autograd.grad((out * g).sum(), (lg, v))
    torch.testing.assert_close(a_lg, b_lg, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(a_v, b_v, rtol=1e-9, atol=1e-12)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_backward_kernels_match_plain_versions(name, layout, cuda):
    ids, n, logits, values, g, bucket = _case(name)
    plan, _ = _plans(ids, n, bucket, jax_plans=False)
    plan = plan.to(cuda)
    lg = torch.from_numpy(logits).to(cuda)
    v = torch.from_numpy(values).to(cuda)
    gt = _cotangent(g, layout).to(cuda)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    before = dict(ops.launches)
    got = ops.segment_sum_bwd_op(gt, plan)
    d_lg, d_v = ops.edge_softmax_bwd_op(gt, lg, v, out, m, den, plan)
    torch.cuda.synchronize()
    gc = gt.contiguous()
    torch.testing.assert_close(          # a gather is a copy
        got.flatten(1), segment_sum_bwd_ref(gc.flatten(1), plan.edge_dst),
        rtol=0, atol=0)
    w_lg, w_v = edge_softmax_bwd_ref(gc, lg, v, m, den, (out * gc).sum(-1),
                                     plan.edge_dst)
    torch.testing.assert_close(d_lg, w_lg, rtol=TOL, atol=TOL)
    torch.testing.assert_close(d_v, w_v, rtol=TOL, atol=TOL)
    launched = int(len(ids) > 0)
    assert ops.launches["segment_sum_bwd"] == (before["segment_sum_bwd"]
                                               + launched)
    assert ops.launches["edge_softmax_bwd"] == (before["edge_softmax_bwd"]
                                                + launched)


@pytest.mark.cuda
def test_cuda_backward_kernels_are_deterministic(cuda):
    ids, n, logits, values, g, _ = _case("gat_e_width")
    plan = build_csc_plan(ids, n).to(cuda)
    lg = torch.from_numpy(logits).to(cuda)
    v = torch.from_numpy(values).to(cuda)
    gt = torch.from_numpy(g).to(cuda)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    a = ops.edge_softmax_bwd_op(gt, lg, v, out, m, den, plan)
    b = ops.edge_softmax_bwd_op(gt, lg, v, out, m, den, plan)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ops.segment_sum_bwd_op(gt, plan),
                       ops.segment_sum_bwd_op(gt, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("heads,dim", [(4, 8), (4, 16), (8, 4), (40, 4),
                                       (4, 32), (1, 130), (2, 3)])
def test_cuda_backward_on_hub_rows(heads, dim, cuda):
    """``edge_softmax_bwd.cu`` over hub rows of 65, 412, 2,832 and 5,000
    edges (cut into pieces), empty rows, an all-masked hub and pad edges
    with live logits behind them: at the compile-time widths (D 8, 16 and
    4, with 4, 2 and 1 rows a row warp; 40 heads, more than a warp's
    lanes), a 16-byte one (D 32) and the scalar one (D 130, D 3); within
    rtol/atol 1e-5 of the plain version, the same bits twice."""
    rng = np.random.default_rng(3)
    n = 400
    ids = np.sort(np.concatenate(
        [rng.integers(10, n - 10, 3000)]
        + [np.full(deg, r) for r, deg in ((0, 65), (5, 412), (200, 2832),
                                          (n - 1, 5000), (7, 700))]))
    e, e_pad = len(ids), len(ids) + 150
    logits = (rng.normal(size=(e_pad, heads)) * 3).astype(np.float32)
    values = rng.normal(size=(e_pad, heads, dim)).astype(np.float32)
    logits[:e][ids == 7] = NEG                     # an all-masked hub
    values[:e][ids == 7] = 0.0
    plan = build_bucket_csc_plan(ids.astype(np.int32), n, e_pad).to(cuda)
    lg, v = (torch.from_numpy(a).to(cuda) for a in (logits, values))
    g = torch.from_numpy(rng.normal(size=(n, heads, dim)).astype(
        np.float32)).to(cuda)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    got = ops.edge_softmax_bwd_op(g, lg, v, out, m, den, plan)
    again = ops.edge_softmax_bwd_op(g, lg, v, out, m, den, plan)
    want = edge_softmax_bwd_ref(g, lg, v, m, den, (out * g).sum(-1),
                                plan.edge_dst)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        torch.testing.assert_close(a, w, rtol=TOL, atol=TOL)
        assert torch.equal(a, b)
    masked = torch.from_numpy(np.flatnonzero(ids == 7)).to(cuda)
    assert not got[0][masked].any() and not got[1][masked].any()


@pytest.mark.cuda
@pytest.mark.parametrize("heads,dim", [(4, 8), (3, 4), (1, 130)])
def test_cuda_backward_pads_logit_rows_past_the_l2(heads, dim, cuda):
    """Where the call's traffic exceeds the L2 cache, d_logits comes back
    as a view of rows padded to whole 32-byte sectors (zeros past the
    heads): the same values as the plain version, the same bits twice."""
    rng = np.random.default_rng(4)
    l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
    e = 2 * l2 // (4 * heads * (2 * dim + 2)) + 1
    n = e // 6
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    plan = build_csc_plan(ids, n).to(cuda)
    lg = torch.from_numpy((rng.normal(size=(e, heads)) * 3).astype(
        np.float32)).to(cuda)
    v = torch.from_numpy(rng.normal(size=(e, heads, dim)).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(n, heads, dim)).astype(
        np.float32)).to(cuda)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    d_lg, d_v = ops.edge_softmax_bwd_op(g, lg, v, out, m, den, plan)
    again = ops.edge_softmax_bwd_op(g, lg, v, out, m, den, plan)
    want = edge_softmax_bwd_ref(g, lg, v, m, den, (out * g).sum(-1),
                                plan.edge_dst)
    torch.cuda.synchronize()
    stride = -(-heads // 8) * 8
    assert d_lg.shape == (e, heads) and d_lg.stride() == (stride, 1)
    rows = torch.as_strided(d_lg, (e, stride), (stride, 1))
    assert not rows[:, heads:].any()
    for a, b, w in zip((d_lg, d_v), again, want):
        torch.testing.assert_close(a, w, rtol=TOL, atol=TOL)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ops.SUM_BWD_SCHEDULES)
@pytest.mark.parametrize("d", SUM_BWD_DIMS)
@pytest.mark.parametrize("name", ["hubs", "no_rows", "no_edges"])
def test_cuda_segment_sum_bwd_is_exact(name, d, schedule, cuda):
    """``segment_sum_bwd.cu`` under each schedule on the twin's cases:
    the plain version's bits and the twin's, the same bits on a second
    launch, one launch counted a call."""
    plan, g = _sum_bwd_case(name, d)
    cplan, gt = plan.to(cuda), torch.from_numpy(g).to(cuda)
    before = ops.launches["segment_sum_bwd"]
    got = ops._segment_sum_bwd_cuda(gt, cplan, schedule)
    again = ops._segment_sum_bwd_cuda(gt, cplan, schedule)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, segment_sum_bwd_ref(gt, cplan.edge_dst),
                               rtol=0, atol=0)
    assert torch.equal(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _segment_sum_bwd_twin(g, plan, schedule))
    launched = int(plan.num_segments > 0 and plan.num_edges > 0)
    assert ops.launches["segment_sum_bwd"] == before + 2 * launched


@pytest.mark.cuda
def test_cuda_sum_bwd_rule_is_the_kernels(cuda):
    """The schedule the kernel's entry point takes by its own rule, as
    ``ops.sum_bwd_schedule`` reports it, is the source's rule: rows from
    a row of kRowsMinRowBytes (64 bytes, D 16), edges below."""
    src = (Path(ops.__file__).resolve().parent / "csrc"
           / "segment_sum_bwd.cu").read_text()
    m = re.search(r"constexpr\s+int64_t\s+kRowsMinRowBytes\s*=\s*(\d+)\s*;",
                  src)
    assert m, "kRowsMinRowBytes not found in segment_sum_bwd.cu"
    for d in SUM_BWD_DIMS + (15, 16):
        want = "rows" if 4 * d >= int(m.group(1)) else "edges"
        assert ops.sum_bwd_schedule(d) == want, d


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 32, 128])
@pytest.mark.parametrize("schedule", ops.SUM_BWD_SCHEDULES)
def test_cuda_segment_sum_bwd_is_offset_invariant(schedule, d, cuda):
    """A row of 65, 130, 412 or 2,832 edges (row 1) behind a leading row
    of 0, 1, 17 or 63 edges: its edges get the same bits, its row of g,
    wherever the row's units and pieces fall in the plan."""
    for deg in (65, 130, 412, 2832):
        g = torch.from_numpy(np.random.default_rng(deg).normal(
            size=(3, d)).astype(np.float32)).to(cuda)
        rows = []
        for lead in (0, 1, 17, 63):
            plan = build_csc_plan(np.repeat(np.int32([0, 1, 2]),
                                            [lead, deg, 0]), 3).to(cuda)
            got = ops._segment_sum_bwd_cuda(g, plan, schedule)
            rows.append(got[lead:lead + deg].cpu())
        for lead, row in zip((1, 17, 63), rows[1:]):
            assert torch.equal(rows[0], row), f"{deg} edges behind {lead}"
        assert torch.equal(rows[0], g[1].cpu().expand(deg, d))
