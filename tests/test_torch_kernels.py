"""The port's Sum-stage kernels against the JAX package's.

On the CPU the wrappers run the kernels' plain versions
(``repro_torch.kernels.ref``); they are held against the JAX package's
Pallas kernels run in interpret mode, at rtol 1e-5 / atol 1e-6 (the sums
are taken in another order, so equality is not the bar). The tests
marked ``cuda`` hold each CUDA kernel against its plain version on the
card and skip where there is none:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax  # noqa: F401 — the oracle, kept on the CPU
    from repro.core.aggregate import ReferenceBackend as JaxReference
    from repro.kernels import ops as jops
except ImportError:      # a machine without the JAX package: only the
    jops = None          # card-side tests below can run there

from repro_torch.kernels import ops
from repro_torch.kernels.plan import build_bucket_csc_plan, build_csc_plan
from repro_torch.kernels.ref import (NEG, edge_softmax_ref, segment_max_ref,
                                     segment_sum_ref)

RTOL, ATOL = 1e-5, 1e-6

# name -> (nodes, edges, heads, dim, extra); extra: "mask" masks 30% of
# the edges, "all_masked" every edge of rows 0..19, "bucket" pads the
# edge axis with pad edges that join no row, "hub" gives row HUB[0]
# HUB[1] more edges (a hub among short rows), "hub_all_masked" masks
# every edge of that hub
HUB = (7, 700)
CASES = {
    "multihead": (150, 600, 4, 8, ""),
    "wide_d": (120, 400, 1, 130, ""),
    "empty_rows": (300, 100, 2, 8, ""),
    "masked": (150, 500, 4, 8, "mask"),
    "all_masked_rows": (100, 400, 4, 8, "all_masked"),
    "bucket_pad": (100, 300, 4, 8, "bucket"),
    "no_edges": (50, 0, 4, 8, ""),
    "hub": (150, 600, 4, 8, "hub"),
    "hub_all_masked": (150, 600, 4, 8, "hub_all_masked"),
}

CSRC = Path(ops.__file__).resolve().parent / "csrc"


def _constant(source: str, name: str) -> int:
    """The value of ``constexpr ... name = <n>;`` (or ``int64_t{a} << b``)
    in a kernel source under ``csrc/``: the CPU twins below run the
    kernels' own schedule sizes, not copies of them."""
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*"
                  rf"(?:int64_t\{{(\d+)\}}|(\d+))(?:\s*<<\s*(\d+))?\s*;",
                  text)
    assert m, f"{name} not found in {source}"
    return int(m.group(1) or m.group(2)) << int(m.group(3) or 0)


# the schedules of the kernels: csrc/row_pieces.cuh's, which
# segment_sum.cu, segment_max.cu, edge_softmax.cu and edge_softmax_bwd.cu
# use (a warp per row, pieces of PIECE edges past a row's first PIECE,
# counted from the row's start), and edge_softmax.cu's merge-path chunks
# over the same units, of CHUNK items (rows plus edges) from LARGE_PLAN
# on and of 2 * CHUNK from WIDE_CHUNKS on
PIECE = _constant("row_pieces.cuh", "kPiece")
CHUNK = _constant("edge_softmax.cu", "kChunk")
LARGE_PLAN = _constant("edge_softmax.cu", "kLargePlan")
WIDE_CHUNKS = _constant("edge_softmax.cu", "kWideChunks")

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oracle():
    if jops is None:
        pytest.skip("the JAX package (the oracle) is not installed")
    return jops


def _case(name: str, seed: int = 0):
    """numpy inputs of one case: (ids (E_all,), n, logits, values, masked
    row ids, bucket (n_pad, e_pad) or None)."""
    n, e, h, d, extra = CASES[name]
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    if extra.startswith("hub"):
        ids = np.sort(np.concatenate(
            [ids, np.full(HUB[1], HUB[0], np.int32)]))
        e = len(ids)
    if extra != "bucket":
        ids = rng.permutation(ids).astype(np.int32)    # unsorted edge axis
    logits = rng.normal(size=(e, h)).astype(np.float32) * 3
    values = rng.normal(size=(e, h, d)).astype(np.float32)
    masked = np.zeros(e, bool)
    if extra == "mask":
        masked = rng.random(e) < 0.3
    elif extra == "all_masked":
        masked = ids < 20
    elif extra == "hub_all_masked":
        masked = ids == HUB[0]
    logits[masked] = NEG
    values[masked] = 0.0
    masked_rows = np.unique(ids[masked])
    bucket = None
    if extra == "bucket":
        n_pad, e_pad = 128, 512
        pad = e_pad - e
        # pad edges carry garbage: they must join no row
        logits = np.concatenate(
            [logits, rng.normal(size=(pad, h)).astype(np.float32)])
        values = np.concatenate(
            [values, rng.normal(size=(pad, h, d)).astype(np.float32)])
        ids = np.concatenate([ids, np.full(pad, n_pad, np.int32)])
        bucket = (n_pad, e_pad)
    return ids, n, logits, values, masked_rows, bucket


def _plans(name: str, ids, n, bucket, jax_plans=True):
    if bucket is None:
        plan = build_csc_plan(ids, n)
        jplan = jops.build_csc_plan(ids, n) if jax_plans else None
    else:
        real = ids[ids < bucket[0]]
        plan = build_bucket_csc_plan(real, *bucket)
        jplan = (jops.build_bucket_csc_plan(real, *bucket) if jax_plans
                 else None)
    return plan, jplan


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_sum_matches_pallas_kernel(name, oracle):
    ids, n, _, values, _, bucket = _case(name)
    plan, jplan = _plans(name, ids, n, bucket)
    if len(ids):
        want = np.asarray(oracle.segment_sum_op(values, jplan,
                                                interpret=True))
    else:
        # the reference wrapper cannot fold an empty edge axis; its
        # kernel takes one
        from repro.kernels.segment_sum import segment_sum_csc
        flat = values.reshape(0, int(np.prod(values.shape[1:])))
        want = np.asarray(segment_sum_csc(
            flat, jplan.gather_idx, jplan.local_ids, jplan.num_blocks,
            jplan.block_n, interpret=True))[:n].reshape(
                (n,) + values.shape[1:])
    got = ops.segment_sum_op(torch.from_numpy(values), plan)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_edge_softmax_matches_pallas_kernel(name, oracle):
    ids, n, logits, values, masked_rows, bucket = _case(name)
    plan, jplan = _plans(name, ids, n, bucket)
    w_out, w_m, w_den = (np.asarray(a) for a in oracle.edge_softmax_fwd_op(
        logits, values, jplan, interpret=True))
    out, m, den = ops.edge_softmax_fwd_op(torch.from_numpy(logits),
                                          torch.from_numpy(values), plan)
    np.testing.assert_allclose(out.numpy(), w_out, rtol=RTOL, atol=ATOL)
    # the statistics on every row: live rows at the tolerance; on
    # all-masked rows m = NEG and den = the masked-edge count, empty rows
    # m = NEG and den = 0, as edge_softmax_csc gives them
    np.testing.assert_allclose(m.numpy(), w_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(den.numpy(), w_den, rtol=RTOL, atol=ATOL)
    if name in ("all_masked_rows", "hub_all_masked"):
        counts = np.bincount(ids, minlength=n)[masked_rows]
        np.testing.assert_array_equal(den.numpy()[masked_rows],
                                      np.repeat(counts[:, None], 4, 1))
        assert (m.numpy()[masked_rows] == np.float32(NEG)).all()
        assert not out.numpy()[masked_rows].any()
    # and out against the reference backend's segment math
    ref = np.asarray(JaxReference().edge_softmax(logits, values, ids,
                                                 plan.num_segments))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_single_head_lifting_and_mean_degrees(oracle):
    ids, n, logits, values, _, _ = _case("masked")
    plan, jplan = _plans("masked", ids, n, None)
    out = ops.edge_softmax_op(torch.from_numpy(logits[:, 0]),
                              torch.from_numpy(values[:, 0]), plan)
    want = oracle.edge_softmax_op(logits[:, 0], values[:, 0], jplan,
                                  interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # (E,) data folds to one feature column: the mean combine's degrees
    deg = ops.segment_sum_op(torch.ones(len(ids)), plan)
    np.testing.assert_array_equal(deg.numpy(), np.bincount(ids, minlength=n))


def test_segment_max_plain_version():
    ids, n, _, values, _, _ = _case("empty_rows")
    plan = build_csc_plan(ids, n)
    got = ops.segment_max_op(torch.from_numpy(values), plan).numpy()
    want = np.full((n,) + values.shape[1:], NEG, np.float32)
    np.maximum.at(want, ids, values)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        segment_max_ref(torch.from_numpy(values.reshape(len(ids), -1)),
                        plan.perm, plan.indptr, n).numpy(),
        want.reshape(n, -1))


def test_wrappers_validate_the_edge_axis():
    ids, n, logits, values, _, _ = _case("multihead")
    plan = build_csc_plan(ids, n)
    with pytest.raises(ValueError, match="edge axis"):
        ops.segment_sum_op(torch.from_numpy(values[1:]), plan)
    with pytest.raises(ValueError, match="edge axis"):
        ops.edge_softmax_fwd_op(torch.from_numpy(logits[1:]),
                                torch.from_numpy(values[1:]), plan)
    with pytest.raises(ValueError, match="expected"):
        ops.edge_softmax_fwd_op(torch.from_numpy(logits),
                                torch.from_numpy(values[:, :2]), plan)


def test_cpu_wrappers_launch_nothing():
    ids, n, logits, values, _, _ = _case("multihead")
    plan = build_csc_plan(ids, n)
    before = dict(ops.launches)
    ops.segment_sum_op(torch.from_numpy(values), plan)
    ops.edge_softmax_op(torch.from_numpy(logits), torch.from_numpy(values),
                        plan)
    assert ops.launches == before


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain_versions(name, cuda):
    ids, n, logits, values, _, bucket = _case(name)
    plan, _ = _plans(name, ids, n, bucket, jax_plans=False)
    plan = plan.to(cuda)
    lg, v = torch.from_numpy(logits).to(cuda), torch.from_numpy(values).to(cuda)
    before = dict(ops.launches)
    got = ops.segment_sum_op(v, plan)
    out, m, den = ops.edge_softmax_fwd_op(lg, v, plan)
    torch.cuda.synchronize()
    flat = v.flatten(1)
    if not name.startswith("hub"):
        torch.testing.assert_close(
            got.flatten(1),
            segment_sum_ref(flat, plan.perm, plan.indptr, plan.num_segments),
            rtol=RTOL, atol=ATOL)
    else:
        # a 700-edge float32 sum in plan order and the plain version's
        # atomic index_add_ on the card differ past atol 1e-6 where the
        # row's values cancel (5.0e-6 measured): the hub is held against
        # a float64 sum, within rtol of its row's sum of |x| (the scale
        # of a float32 sum's rounding error)
        x = flat.double()
        want = segment_sum_ref(x, plan.perm, plan.indptr, plan.num_segments)
        scale = segment_sum_ref(x.abs(), plan.perm, plan.indptr,
                                plan.num_segments)
        err = (got.flatten(1).double() - want).abs()
        assert (err <= ATOL + RTOL * scale).all(), float(err.max())
    w_out, w_m, w_den = edge_softmax_ref(lg, v, plan.perm, plan.indptr,
                                         plan.num_segments)
    torch.testing.assert_close(out, w_out, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(m, w_m, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(den, w_den, rtol=RTOL, atol=ATOL)
    assert ops.launches["segment_sum"] == before["segment_sum"] + 1
    assert ops.launches["edge_softmax"] == before["edge_softmax"] + 1


@pytest.mark.cuda
def test_cuda_kernels_are_deterministic(cuda):
    for name in ("multihead", "hub", "hub_all_masked"):
        ids, n, logits, values, _, _ = _case(name)
        plan = build_csc_plan(ids, n).to(cuda)
        lg = torch.from_numpy(logits).to(cuda)
        v = torch.from_numpy(values).to(cuda)
        a = ops.segment_sum_op(v, plan)
        b = ops.segment_sum_op(v, plan)
        assert torch.equal(a, b), name
        for x, y in zip(ops.edge_softmax_fwd_op(lg, v, plan),
                        ops.edge_softmax_fwd_op(lg, v, plan)):
            assert torch.equal(x, y), name


@pytest.mark.cuda
def test_cuda_chunk_schedule_matches_plain_version(cuda):
    """``edge_softmax.cu``'s merge-path chunks, which run plans of
    LARGE_PLAN rows plus edges or more: hubs at the first and the last
    row beside empty rows, an all-masked hub, masked edges and pad edges
    behind them, within rtol/atol 1e-5 of the plain version; the
    all-masked hub, cut by chunk edges, keeps m = NEG and den = its edge
    count; empty rows give m = NEG, den = 0 and out = 0; two launches
    are bitwise equal."""
    rng = np.random.default_rng(5)
    n, h, d = LARGE_PLAN // 5, 4, 8
    hubs = ((0, 3000), (n // 2, 4000), (n - 1, 3000))
    ids = np.sort(np.concatenate(
        [rng.integers(3, n - 3, LARGE_PLAN - n)]
        + [np.full(deg, r) for r, deg in hubs])).astype(np.int32)
    e = len(ids)
    e_pad = e + 5000                    # pad edges carry garbage
    logits = rng.normal(size=(e_pad, h)).astype(np.float32) * 3
    values = rng.normal(size=(e_pad, h, d)).astype(np.float32)
    masked = (rng.random(e) < 0.2) | (ids == n // 2)
    logits[:e][masked] = NEG
    values[:e][masked] = 0.0
    plan = build_bucket_csc_plan(ids, n, e_pad)
    assert plan.num_segments + plan.num_edges >= LARGE_PLAN
    plan = plan.to(cuda)
    lg = torch.from_numpy(logits).to(cuda)
    v = torch.from_numpy(values).to(cuda)
    before = ops.launches["edge_softmax"]
    got = ops.edge_softmax_fwd_op(lg, v, plan)
    again = ops.edge_softmax_fwd_op(lg, v, plan)
    torch.cuda.synchronize()
    assert ops.launches["edge_softmax"] == before + 2
    for a, b, w in zip(got, again, edge_softmax_ref(
            lg, v, plan.perm, plan.indptr, plan.num_segments)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, b)
    out, m, den = (t.cpu().numpy() for t in got)
    deg = np.diff(plan.indptr.cpu().numpy())
    assert deg[n // 2] > 4 * CHUNK
    assert (den[n // 2] == deg[n // 2]).all() and (m[n // 2] == NEG).all()
    assert not out[n // 2].any()
    for r in (1, 2, n - 3, n - 2):
        assert (m[r] == NEG).all() and not den[r].any() and not out[r].any()
    # the hubs, the empty rows beside them and a few short rows, alone in
    # a plan under LARGE_PLAN (the rows schedule): the same bits
    rows = np.array([0, 1, 2, 3, 4, 5, n // 2, n // 2 + 1, n - 3, n - 2,
                     n - 1])
    keep = np.isin(ids, rows)
    small = build_csc_plan(np.searchsorted(rows, ids[keep]).astype(np.int32),
                           len(rows))
    assert small.num_segments + small.num_edges < LARGE_PLAN
    alone = ops.edge_softmax_fwd_op(lg[:e][torch.from_numpy(keep).to(cuda)],
                                    v[:e][torch.from_numpy(keep).to(cuda)],
                                    small.to(cuda))
    for a, b in zip(alone, got):
        assert torch.equal(a, b[torch.from_numpy(rows).to(cuda)])


@pytest.mark.cuda
def test_cuda_max_combine_runs_the_kernel_pair(cuda):
    """The csc max combine on the card: the segment_max kernel forward,
    its backward kernel under autograd, equal to the plain versions."""
    from repro_torch.core.aggregate import combine
    ids, n, _, values, _, _ = _case("masked")
    plan = build_csc_plan(ids, n).to(cuda)
    v = torch.from_numpy(values).to(cuda).requires_grad_()
    mask = (torch.arange(len(ids), device=cuda) % 5 != 0).float()
    dst = torch.from_numpy(ids).to(cuda)
    before = dict(ops.launches)
    out = combine("max", {"value": v}, dst, n, mask, "csc", plan)
    (d_v,) = torch.autograd.grad(out.sum(), v)
    torch.cuda.synchronize()
    assert ops.launches["segment_max"] == before["segment_max"] + 1
    assert ops.launches["segment_max_bwd"] == before["segment_max_bwd"] + 1
    v_cpu = v.detach().cpu().requires_grad_()
    cpu = combine("max", {"value": v_cpu}, dst.cpu(), n, mask.cpu(), "csc",
                  plan.to("cpu"))
    (want,) = torch.autograd.grad(cpu.sum(), v_cpu)
    torch.testing.assert_close(out.detach().cpu(), cpu.detach(), rtol=0,
                               atol=0)
    torch.testing.assert_close(d_v.cpu(), want, rtol=0, atol=0)


def test_reference_backend_refuses_device_tensors():
    from repro_torch.core.aggregate import get_backend
    data = torch.zeros(4, 2, device="meta")
    with pytest.raises(RuntimeError, match="CPU only"):
        get_backend("reference").segment_sum(data, torch.zeros(4), 3)


def _count_rows(indptr, lo: int, hi: int, by_item: bool, d: int) -> int:
    """The kernels' warp search, #{r in [lo, hi) : (r if by_item else 0)
    + indptr[r+1] < d}: 32 probes a round narrow [lo, hi), as the lanes
    of a warp do; held against ``np.searchsorted``."""
    key = (np.arange(len(indptr) - 1) if by_item else 0) + indptr[1:]
    want = int(np.searchsorted(key[:hi], d, side="left"))
    while hi > lo:
        step = (hi - lo + 31) // 32
        c = sum(p < hi and (p if by_item else 0) + indptr[p + 1] < d
                for p in range(lo, lo + 32 * step, step))
        if c == 0:
            hi = lo
        else:
            nxt = lo + c * step
            lo += (c - 1) * step + 1
            if c < 32 and nxt < hi:
                hi = nxt
    assert lo == want
    return lo


def _first_unit(indptr, r: int, d: int, piece: int) -> tuple:
    """``edge_softmax.cu``'s ``first_unit``: (row, first edge) of the
    first unit that starts at merge-path item ``d`` or later, given
    ``r``, the row whose items hold item ``d`` (n past the last). Row r's
    unit j starts at item r + indptr[r] + j * piece: its row unit (j =
    0, also when the row is empty) and each piece with j * piece less
    than its length."""
    n = len(indptr) - 1
    if r >= n:
        return n, int(indptr[n])
    s, e = int(indptr[r]), int(indptr[r + 1])
    if r + s >= d:
        return r, s
    j = -(-(d - r - s) // piece)
    return (r, s + j * piece) if j * piece < e - s else (r + 1, e)


def _split_chunks(indptr, chunk: int, piece: int, reduce, put):
    """``edge_softmax.cu``'s large-plan schedule: merge-path chunks of
    ``chunk`` items (row r's edges, then its end marker), each taking
    the units of ``_split_rows``' schedule (pieces of ``piece`` edges,
    counted from the row's start) that start in it. Each unit is
    reduced (``reduce(row, a, b)``) and ``put`` as the rows schedule
    puts it: ``put(row, part, None)`` for a whole row, else into slot
    (piece_ptr[r], 1) from its row unit and (p, 0) from piece p.
    Returns {last piece of a cut row: (row, the slots it folds)}."""
    n = len(indptr) - 1
    ptr = _piece_ptr(indptr, piece)
    merge_rows = {}
    for d0 in range(0, n + int(indptr[n]), chunk):
        i0 = _count_rows(indptr, 0, n, True, d0)
        i1 = _count_rows(indptr, i0, min(i0 + chunk, n), True, d0 + chunk)
        r, g = _first_unit(indptr, i0, d0, piece)
        end = _first_unit(indptr, i1, d0 + chunk, piece)
        # the kernel's shared memory: the chunk's edge ids and row ends
        assert end[1] - g <= chunk + piece and end[0] - r <= chunk
        while (r, g) < end:
            s, e = int(indptr[r]), int(indptr[r + 1])
            b, unit = min(e, g + piece), (g - s) // piece
            part = reduce(r, g, b)
            if unit == 0 and b == e:
                put(r, part, None)
            else:
                p = int(ptr[r]) + unit - 1
                put(r, part, (int(ptr[r]), 1) if unit == 0 else (p, 0))
                if unit > 0 and b == e:
                    merge_rows[p] = (r, [(int(ptr[r]), 1)] + [
                        (q, 0) for q in range(int(ptr[r]), p + 1)])
            r, g = (r + 1, e) if b == e else (r, b)
    return merge_rows


def _piece_ptr(indptr, piece: int) -> np.ndarray:
    """``csrc/row_pieces.cuh``'s piece_ptr, a row at a time: a row of d
    edges has a piece for each ``piece`` edges past its first ``piece``."""
    counts, ptr = [], [0]
    for r in range(len(indptr) - 1):
        d, extra = int(indptr[r + 1] - indptr[r]), 0
        while d > piece * (extra + 1):
            extra += 1
        ptr.append(ptr[-1] + extra)
    return np.asarray(ptr, np.int64)


def _split_rows(indptr, num_edges: int, piece: int, reduce, put):
    """``row_pieces.cuh``'s first launch: a warp per row takes its first
    ``piece`` edges (slot (piece_ptr[r], 1) when the row is longer); a
    warp per piece p finds its row r by the warp search over piece_ptr
    and takes the row's edges [s + j*piece, s + (j+1)*piece), j = p -
    piece_ptr[r] + 1, counted from the row's start s (slot (p, 0)).
    Returns {last piece of a cut row: (row, the slots it folds)}."""
    n = len(indptr) - 1
    ptr = _piece_ptr(indptr, piece)
    merge_rows = {}
    for r in range(n):
        s, e = int(indptr[r]), int(indptr[r + 1])
        b = min(e, s + piece)
        put(r, reduce(r, s, b), None if b == e else (int(ptr[r]), 1))
    for p in range(int(ptr[n])):
        r = _count_rows(ptr, 0, n, False, p + 1)
        s, e = int(indptr[r]), int(indptr[r + 1])
        a = s + (p - int(ptr[r]) + 1) * piece
        b = min(e, a + piece)
        assert a < b <= num_edges
        put(r, reduce(r, a, b), (p, 0))
        if b == e:
            merge_rows[p] = (r, [(int(ptr[r]), 1)] + [
                (q, 0) for q in range(int(ptr[r]), p + 1)])
    return merge_rows


def _schedule(n: int, num_edges: int, schedule=None):
    """``schedule``, or ``edge_softmax.cu``'s choice for a plan of n rows
    and num_edges edges: ("rows", PIECE), or ("chunks", CHUNK, PIECE),
    chunks of 2 * CHUNK items from WIDE_CHUNKS on."""
    if schedule is not None:
        return schedule
    items = n + num_edges
    if items < LARGE_PLAN:
        return ("rows", PIECE)
    return ("chunks", CHUNK * (2 if items >= WIDE_CHUNKS else 1), PIECE)


def _split_and_merge(indptr, num_edges: int, schedule, reduce, merge,
                     finish) -> int:
    """Both launches of a kernel, on the CPU. ``schedule`` is ("chunks",
    items, edges) or ("rows", edges), by default ``edge_softmax.cu``'s
    choice for the plan; the second launch folds each cut row's slots in
    plan order (``merge``) and ``finish``es it. Returns the number of cut
    rows."""
    indptr = np.asarray(indptr).astype(np.int64)
    kind, *sizes = _schedule(len(indptr) - 1, num_edges, schedule)
    slots = {}

    def put(r, part, slot):
        if slot is None:
            finish(r, part)
        else:
            assert slot not in slots, f"slot {slot} written twice"
            slots[slot] = part

    merge_rows = (_split_chunks(indptr, *sizes, reduce, put)
                  if kind == "chunks"
                  else _split_rows(indptr, num_edges, *sizes, reduce, put))
    for r, folds in merge_rows.values():
        part = slots.pop(folds[0])
        for key in folds[1:]:
            part = merge(part, slots.pop(key))
        finish(r, part)
    assert not slots, "a partial was left unmerged"
    return len(merge_rows)


def _edge_softmax_twin(logits, values, perm, indptr, schedule=None):
    """``edge_softmax.cu`` step for step, in float32 numpy: the plan's
    schedule (or ``schedule``), which under either kind runs the same
    units; per unit, 4 edges at a time from its start, m_new = max(m,
    x_1..x_4), one rescale by exp(m - m_new), the edges' p = exp(x -
    m_new) summed in edge order; cut rows' (m, l, acc) merged in row
    order; out = acc / max(l, 1e-20). Returns (out, m, den, rows cut)."""
    f = np.float32
    n, (h, d) = len(indptr) - 1, values.shape[1:]
    schedule = _schedule(n, len(perm), schedule)
    step = 4
    out = np.full((n, h, d), np.nan, f)
    m_out = np.full((n, h), np.nan, f)
    den = np.full((n, h), np.nan, f)

    def reduce(r, a, b):
        m, l, acc = np.full(h, f(NEG), f), np.zeros(h, f), np.zeros((h, d), f)
        for t in range(a, b, step):
            es = perm[t:min(t + step, b)]
            x, v = logits[es], values[es]
            m_new = np.maximum(m, x.max(0))
            alpha, p = np.exp(m - m_new), np.exp(x - m_new)
            ps, pv = np.zeros(h, f), np.zeros((h, d), f)
            for u in range(len(es)):
                ps = ps + p[u]
                pv = pv + p[u][:, None] * v[u]
            l = l * alpha + ps
            acc = acc * alpha[:, None] + pv
            m = m_new
        return m, l, acc

    def merge(a, b):
        (m, l, acc), (m2, l2, acc2) = a, b
        mx = np.maximum(m, m2)
        s1, s2 = np.exp(m - mx), np.exp(m2 - mx)
        return mx, l * s1 + l2 * s2, acc * s1[:, None] + acc2 * s2[:, None]

    def finish(r, part):
        m, l, acc = part
        assert np.isnan(den[r]).all(), f"row {r} written twice"
        out[r] = acc / np.maximum(l, f(1e-20))[:, None]
        m_out[r], den[r] = m, l

    cut = _split_and_merge(indptr, len(perm), schedule, reduce, merge,
                           finish)
    assert not np.isnan(den).any(), "a row was never written"
    return out, m_out, den, cut


@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_recurrence_matches_plain_version(name):
    """The chunked online recurrence of ``edge_softmax.cu`` and its merge,
    run here on the CPU, agree with the plain version — on all-masked
    rows exactly."""
    ids, n, logits, values, masked_rows, bucket = _case(name)
    plan, _ = _plans(name, ids, n, bucket, jax_plans=False)
    t_out, t_m, t_den, cut = _edge_softmax_twin(
        logits, values, plan.perm.numpy(), plan.indptr.numpy())
    out, m, den = edge_softmax_ref(torch.from_numpy(logits),
                                   torch.from_numpy(values), plan.perm,
                                   plan.indptr, plan.num_segments)
    np.testing.assert_allclose(t_out, out.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_m, m.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_den, den.numpy(), rtol=RTOL, atol=ATOL)
    if name in ("all_masked_rows", "hub_all_masked"):  # every edge masked
        np.testing.assert_array_equal(t_den[masked_rows],
                                      den.numpy()[masked_rows])
    if name.startswith("hub"):     # the hub is cut into pieces
        assert cut >= 1


# schedules with units far below the kernels' PIECE and CHUNK, so that
# short rows are cut too
SPLITS = {"chunks_5": ("chunks", 5, 1), "chunks_16": ("chunks", 16, 2),
          "rows_1": ("rows", 1), "rows_2": ("rows", 2)}


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", ["all_masked_rows", "bucket_pad",
                                  "empty_rows", "hub_all_masked", "masked"])
def test_split_and_merge_of_edge_softmax(name, split):
    """Rows cut into pieces and merged in plan order stay within
    rtol/atol 1e-5 of the plain version under either schedule; an
    all-masked row that is cut still ends with m = NEG and den = its
    edge count, an empty row with m = NEG, den = 0 and out = 0."""
    ids, n, logits, values, masked_rows, bucket = _case(name)
    plan, _ = _plans(name, ids, n, bucket, jax_plans=False)
    perm, indptr = plan.perm.numpy(), plan.indptr.numpy()
    t_out, t_m, t_den, cut = _edge_softmax_twin(logits, values, perm,
                                                indptr, SPLITS[split])
    out, m, den = edge_softmax_ref(torch.from_numpy(logits),
                                   torch.from_numpy(values), plan.perm,
                                   plan.indptr, plan.num_segments)
    assert cut > 0
    np.testing.assert_allclose(t_out, out.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_m, m.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_den, den.numpy(), rtol=RTOL, atol=ATOL)
    deg = np.diff(indptr)
    if len(masked_rows) and name != "masked":
        np.testing.assert_array_equal(
            t_den[masked_rows], np.repeat(deg[masked_rows, None], 4, 1))
        assert (t_m[masked_rows] == np.float32(NEG)).all()
        assert not t_out[masked_rows].any()
    empty = deg == 0
    assert (t_m[empty] == np.float32(NEG)).all()
    assert not t_den[empty].any() and not t_out[empty].any()


def _segment_max_twin(data, perm, indptr, piece: int):
    """``segment_max.cu``'s split and merge in numpy (row_pieces.cuh's
    schedule, pieces of ``piece`` edges): each row piece's max from NEG,
    NaN-propagating, and the cut rows' pieces folded in plan order.
    Returns (out, rows cut)."""
    n = len(indptr) - 1
    out = np.full((n,) + data.shape[1:], np.inf, np.float32)

    def finish(r, part):
        out[r] = part

    cut = _split_and_merge(
        indptr, len(perm), ("rows", piece),
        lambda r, a, b: np.max(data[perm[a:b]], axis=0,
                               initial=np.float32(NEG)),
        np.maximum, finish)
    return out, cut


@pytest.mark.parametrize("piece", [1, 2, 3, 7, 16, PIECE])
def test_split_and_merge_of_segment_max(piece):
    """segment_max's split and merge, at the kernel's piece size and at
    smaller ones that cut short rows too, exactly against the plain
    version: a hub with a NaN inside, an all-masked hub, hubs at the
    first and the last row next to empty rows, and pad edges behind
    them."""
    rng = np.random.default_rng(3)
    n, d = 60, 8
    ids = rng.integers(2, n - 2, 300)
    ids = np.sort(np.concatenate([ids] + [np.full(deg, r) for r, deg in
                                          ((0, 400), (30, 350),
                                           (n - 1, 500))]))
    data = rng.normal(size=(len(ids), d)).astype(np.float32)
    data[ids == 30] = NEG                       # an all-masked hub
    hub = np.flatnonzero(ids == n - 1)
    data[hub[len(hub) // 2], 3] = np.nan        # a NaN inside a hub
    e = len(ids)
    data = np.concatenate([data, rng.normal(size=(64, d)).astype(
        np.float32)])                           # pad edges behind
    plan = build_bucket_csc_plan(ids.astype(np.int32), n, e + 64)
    perm, indptr = plan.perm.numpy(), plan.indptr.numpy()
    got, cut = _segment_max_twin(data, perm, indptr, piece)
    want = segment_max_ref(torch.from_numpy(data), plan.perm, plan.indptr,
                           n).numpy()
    assert cut >= 3                             # every hub is cut
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[n - 1, 3]) and not np.isnan(got[n - 1, :3]).any()
    assert (got[30] == np.float32(NEG)).all()
    assert (got[[1, n - 2]] == np.float32(NEG)).all()   # empty neighbours


def test_plan_piece_size_is_the_kernels():
    from repro_torch.kernels import plan as plan_mod
    assert plan_mod.PIECE == PIECE


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_piece_ptr_matches_its_twin(name):
    """``build_csc_plan``'s piece_ptr against a row-at-a-time count of
    each row's pieces, over hubs, empty rows and a bucket's pad edges
    (which join no row and so are never cut)."""
    ids, n, _, _, _, bucket = _case(name)
    plan, _ = _plans(name, ids, n, bucket, jax_plans=False)
    indptr = plan.indptr.numpy()
    want = _piece_ptr(indptr, PIECE)
    np.testing.assert_array_equal(plan.piece_ptr.numpy(), want)
    assert plan.piece_ptr.dtype == torch.int32
    assert plan.num_pieces == int(want[-1])
    assert plan.num_real_edges == int(indptr[-1])
    if name.startswith("hub"):
        assert plan.num_pieces == -(-(HUB[1] - PIECE) // PIECE) or \
            plan.num_pieces > 0


def _segment_sum_twin(data, perm, indptr, piece: int = PIECE):
    """``segment_sum.cu``'s order of summation, in float32 numpy: a row
    unit (a row's first ``piece`` edges) summed in edge order by one
    sub-warp; a piece by the warp's S = 32 / L sub-warps (L the power of
    two >= ceil(D / 4), at most 32), sub-warp i summing edges i, i + S,
    ... of the piece in order, then merged by the xor tree; a cut row's
    partials added in row order. Returns (out, rows cut); the kernel's
    output is bitwise this."""
    f = np.float32
    n, d = len(indptr) - 1, data.shape[1]
    lanes = 1
    while lanes < 32 and lanes < -(-d // 4):
        lanes *= 2
    subs = 32 // lanes
    out = np.full((n, d), np.nan, f)

    def seq(ids):
        acc = np.zeros(d, f)
        for e in ids:
            acc = acc + data[e]
        return acc

    def reduce(r, a, b):
        ids = perm[a:b]
        if a == indptr[r]:
            return seq(ids)
        parts, step = [seq(ids[i::subs]) for i in range(subs)], 1
        while step < subs:
            parts = [parts[i] + parts[i ^ step] for i in range(subs)]
            step *= 2
        return parts[0]

    def finish(r, part):
        assert np.isnan(out[r]).all(), f"row {r} written twice"
        out[r] = part

    cut = _split_and_merge(indptr, len(perm), ("rows", piece), reduce,
                           lambda a, b: a + b, finish)
    return out, cut


def _sum_case(d: int, seed: int = 0, degrees=(65, 130, 412)):
    """A plan with hub rows of ``degrees`` edges (at most 4, the first
    and the last row among them), rows of 17, 40 and 64 edges, short and
    empty rows, and pad edges with garbage behind them; data (E_pad, d)
    float32."""
    rng = np.random.default_rng(seed)
    n = 80
    ids = [rng.integers(8, n - 8, 300)]
    ids += [np.full(deg, r) for r, deg in zip((0, n - 1, 6, 7), degrees)]
    ids += [np.full(deg, r) for r, deg in ((3, 17), (4, 40), (5, 64))]
    ids = np.sort(np.concatenate(ids)).astype(np.int32)
    ids = ids[~np.isin(ids, (1, 2, n - 3, n - 2))]          # empty rows
    data = rng.normal(size=(len(ids) + 70, d)).astype(np.float32)
    return build_bucket_csc_plan(ids, n, len(ids) + 70), data


@pytest.mark.parametrize("d", [1, 3, 4, 8, 32, 64, 128, 130])
def test_segment_sum_twin_near_float64(d):
    """The kernel's order of summation stays within 1e-5 of each row's
    sum of |x| of a float64 sum (the scale of a float32 sum's rounding
    error), at the widths that give 32, 16, 8, 4, 2 and 1 sub-warps."""
    plan, data = _sum_case(d)
    got, cut = _segment_sum_twin(data, plan.perm.numpy(), plan.indptr.numpy())
    assert cut == 3
    x = torch.from_numpy(data).double()
    want = segment_sum_ref(x, plan.perm, plan.indptr, plan.num_segments)
    scale = segment_sum_ref(x.abs(), plan.perm, plan.indptr,
                            plan.num_segments)
    err = np.abs(got - want.numpy())
    assert (err <= ATOL + RTOL * scale.numpy()).all(), float(err.max())
    assert not got[[1, 2]].any()                     # empty rows give 0


def _behind(lead: int, deg: int, h: int = 4, d: int = 8):
    """A row of ``deg`` edges (row 1) behind a row of ``lead`` edges (row
    0): the row's logits and values are the same whatever ``lead``."""
    row = np.random.default_rng(deg)
    head = np.random.default_rng(1000 + lead)
    logits = np.concatenate([head.normal(size=(lead, h)),
                             row.normal(size=(deg, h)) * 3]).astype(np.float32)
    values = np.concatenate([head.normal(size=(lead, h, d)),
                             row.normal(size=(deg, h, d))]).astype(np.float32)
    ids = np.repeat(np.int32([0, 1, 2]), [lead, deg, 0])
    return build_csc_plan(ids, 3), logits, values


LEADS = (0, 1, 17, 63)


# the rows that must give the same bits under either schedule of
# edge_softmax.cu and at any offset: short and empty rows, a row of
# ``deg`` edges, the same with 30% and with all of its edges masked, and
# a hub of 5,000 edges
SWITCH_ROWS = (0, 1, 3, 6, 17, "deg", "deg masked", "deg all masked", 5000)
# split sizes for the twin: (chunk items, piece edges), scaled down and
# the kernel's own (both its chunk sizes), below and above a plan size
# that switches
SWITCH_SPLITS = ((16, 8), (CHUNK, PIECE), (2 * CHUNK, PIECE))
SWITCH_AT = 8192                    # the scaled-down kLargePlan


def _switch_rows(deg: int, h: int = 4, d: int = 8):
    """SWITCH_ROWS' edges: (lengths, logits, values), each row's data
    seeded by its place in the list, so that it is the same in every
    plan it is put in."""
    lengths, logits, values = [], [], []
    for i, spec in enumerate(SWITCH_ROWS):
        rng = np.random.default_rng(100 + i)
        k = deg if isinstance(spec, str) else spec
        lg = rng.normal(size=(k, h)).astype(np.float32) * 3
        v = rng.normal(size=(k, h, d)).astype(np.float32)
        masked = (np.ones(k, bool) if spec == "deg all masked" else
                  rng.random(k) < 0.3 if spec == "deg masked" else
                  np.zeros(k, bool))
        lg[masked], v[masked] = NEG, 0.0
        lengths.append(k)
        logits.append(lg)
        values.append(v)
    return lengths, np.concatenate(logits), np.concatenate(values)


def _switch_plan(lead: int, deg: int, fill: int):
    """``fill`` short filler rows (seeded), a row of ``lead`` edges, then
    SWITCH_ROWS: (plan, logits, values, the rows' first row)."""
    lengths, logits, values = _switch_rows(deg)
    rng = np.random.default_rng(7 + lead)
    front = list(rng.integers(0, 9, fill)) + [lead]
    k = int(sum(front))
    ids = np.repeat(np.arange(len(front) + len(lengths), dtype=np.int32),
                    front + lengths)
    plan = build_csc_plan(ids, len(front) + len(lengths))
    logits = np.concatenate([rng.normal(size=(k, 4)).astype(np.float32),
                             logits])
    values = np.concatenate([rng.normal(size=(k, 4, 8)).astype(np.float32),
                             values])
    return plan, logits, values, len(front)


def _schedules_agree(deg: int) -> None:
    """SWITCH_ROWS behind a lead row of 0, 1, 17 or 63 edges, in a plan
    below SWITCH_AT items (which runs rows and pieces) and in one that
    filler rows in front take past it (which runs chunks), at each of
    SWITCH_SPLITS: every plan and chunk size with one piece size gives
    the rows the bits of the first (the chunks set no bits)."""
    wants = {}
    for chunk, piece in SWITCH_SPLITS:
        for lead in LEADS:
            for fill in (0, 900):
                plan, logits, values, first = _switch_plan(lead, deg, fill)
                perm, indptr = plan.perm.numpy(), plan.indptr.numpy()
                items = plan.num_segments + plan.num_edges
                schedule = (("chunks", chunk, piece) if items >= SWITCH_AT
                            else ("rows", piece))
                assert (items >= SWITCH_AT) == (fill > 0)
                out, m, den, cut = _edge_softmax_twin(logits, values, perm,
                                                      indptr, schedule)
                assert cut >= 4         # deg, its masked twins, the hub
                got = [a[first:] for a in (out, m, den)]
                for a, b in zip(wants.setdefault(piece, got), got):
                    assert a.tobytes() == b.tobytes(), (
                        f"{schedule} behind {lead} edges, {fill} fillers")


@pytest.mark.parametrize("deg", [65, 130, 412])
@pytest.mark.parametrize("kernel", ["edge_softmax", "segment_sum",
                                    "edge_softmax_schedules"])
def test_row_cuts_are_offset_invariant(kernel, deg):
    """A row longer than PIECE gives the same bits wherever it lies in
    the plan: behind a leading row of 0, 1, 17 or 63 edges, the
    kernels' split and merge (their CPU twins) cut it at the same edges
    and sum it in the same order. A served cache hit (the top layer over
    a 1-hop view) and a full recompute (over a K-hop view) see the same
    row at different offsets. ``edge_softmax_schedules``: the same holds
    across ``edge_softmax``'s schedule switch, for short, long, masked and
    all-masked rows (:func:`_schedules_agree`)."""
    if kernel == "edge_softmax_schedules":
        _schedules_agree(deg)
        return
    rows = []
    for lead in LEADS:
        plan, logits, values = _behind(lead, deg)
        perm, indptr = plan.perm.numpy(), plan.indptr.numpy()
        if kernel == "edge_softmax":
            out, m, den, cut = _edge_softmax_twin(logits, values, perm,
                                                  indptr)
            rows.append((out[1], m[1], den[1]))
        else:
            out, cut = _segment_sum_twin(values.reshape(len(perm), -1),
                                         perm, indptr)
            rows.append((out[1],))
        assert cut >= 1
    for lead, row in zip(LEADS[1:], rows[1:]):
        for a, b in zip(rows[0], row):
            assert a.tobytes() == b.tobytes(), f"behind {lead} edges"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4, 8, 32, 64, 128, 130])
def test_cuda_segment_sum_is_its_twin_bitwise(d, cuda):
    """``segment_sum.cu`` on hub rows of 65 to 5,000 edges, rows of up
    to 64 edges, empty rows and pad edges: bitwise its CPU twin's
    order of summation (adds only, so no contraction can part them),
    within the float64 gate, and the same bits on a second launch."""
    plan, data = _sum_case(d, degrees=(65, 412, 2832, 5000))
    want, cut = _segment_sum_twin(data, plan.perm.numpy(),
                                  plan.indptr.numpy())
    assert cut == 4
    cplan, x = plan.to(cuda), torch.from_numpy(data).to(cuda)
    before = ops.launches["segment_sum"]
    got = ops.segment_sum_op(x, cplan)
    again = ops.segment_sum_op(x, cplan)
    torch.cuda.synchronize()
    assert ops.launches["segment_sum"] == before + 2
    assert torch.equal(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["edge_softmax", "segment_sum",
                                    "segment_max"])
def test_cuda_row_cuts_are_offset_invariant(kernel, cuda):
    """On the card, a row of 65, 412, 2,832 or 5,000 edges gives the same
    bits behind a leading row of 0, 1, 17 or 63 edges; through
    ``edge_softmax`` also behind filler rows that take the plan past
    LARGE_PLAN, where it runs merge-path chunks, and past WIDE_CHUNKS,
    where its chunks are twice as long."""
    for deg in (65, 412, 2832, 5000):
        rows = []
        for lead in LEADS:
            plans = [_behind(lead, deg) + (1,)]
            if kernel == "edge_softmax":
                plans.append(_behind_fillers(lead, deg, LARGE_PLAN))
            if kernel == "edge_softmax" and lead == LEADS[-1]:
                plans.append(_behind_fillers(lead, deg, WIDE_CHUNKS))
            for plan, logits, values, r in plans:
                plan = plan.to(cuda)
                lg, v = (torch.from_numpy(a).to(cuda)
                         for a in (logits, values))
                if kernel == "edge_softmax":
                    got = ops.edge_softmax_fwd_op(lg, v, plan)
                elif kernel == "segment_sum":
                    got = (ops.segment_sum_op(v, plan),)
                else:
                    got = (ops.segment_max_op(v, plan),)
                rows.append([t[r].cpu() for t in got])
        for row in rows[1:]:
            for a, b in zip(rows[0], row):
                assert torch.equal(a, b), f"{deg} edges"


def _behind_fillers(lead: int, deg: int, items: int):
    """``_behind(lead, deg)``'s rows behind seeded filler rows of 0-8
    edges, enough to take the plan past ``items`` rows plus edges:
    (plan, logits, values, the deg row's index)."""
    _, logits, values = _behind(lead, deg)
    rng = np.random.default_rng(lead)
    fill = items // 4
    front = rng.integers(0, 9, fill)
    k = int(front.sum())
    ids = np.repeat(np.arange(fill + 3, dtype=np.int32),
                    np.concatenate([front, [lead, deg, 0]]))
    plan = build_csc_plan(ids, fill + 3)
    assert plan.num_segments + plan.num_edges >= items
    logits = np.concatenate([rng.normal(size=(k, 4)).astype(np.float32),
                             logits])
    values = np.concatenate([rng.normal(size=(k, 4, 8)).astype(np.float32),
                             values])
    return plan, logits, values, fill + 1
