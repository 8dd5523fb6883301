"""The port's Sum-stage kernels against the JAX package's.

On the CPU the wrappers run the kernels' plain versions
(``repro_torch.kernels.ref``); they are held against the JAX package's
Pallas kernels run in interpret mode, at rtol 1e-5 / atol 1e-6 (the sums
are taken in another order, so equality is not the bar). The tests
marked ``cuda`` hold each CUDA kernel against its plain version on the
card and skip where there is none:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
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
# edge axis with pad edges that join no row
CASES = {
    "multihead": (150, 600, 4, 8, ""),
    "wide_d": (120, 400, 1, 130, ""),
    "empty_rows": (300, 100, 2, 8, ""),
    "masked": (150, 500, 4, 8, "mask"),
    "all_masked_rows": (100, 400, 4, 8, "all_masked"),
    "bucket_pad": (100, 300, 4, 8, "bucket"),
    "no_edges": (50, 0, 4, 8, ""),
}


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
    if len(masked_rows) and name == "all_masked_rows":
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
    torch.testing.assert_close(
        got.flatten(1),
        segment_sum_ref(flat, plan.perm, plan.indptr, plan.num_segments),
        rtol=RTOL, atol=ATOL)
    w_out, w_m, w_den = edge_softmax_ref(lg, v, plan.perm, plan.indptr,
                                         plan.num_segments)
    torch.testing.assert_close(out, w_out, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(m, w_m, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(den, w_den, rtol=RTOL, atol=ATOL)
    assert ops.launches["segment_sum"] == before["segment_sum"] + 1
    assert ops.launches["edge_softmax"] == before["edge_softmax"] + 1


@pytest.mark.cuda
def test_cuda_kernels_are_deterministic(cuda):
    ids, n, logits, values, _, _ = _case("multihead")
    plan = build_csc_plan(ids, n).to(cuda)
    lg, v = torch.from_numpy(logits).to(cuda), torch.from_numpy(values).to(cuda)
    a = ops.segment_sum_op(v, plan)
    b = ops.segment_sum_op(v, plan)
    assert torch.equal(a, b)
    assert torch.equal(ops.edge_softmax_op(lg, v, plan),
                       ops.edge_softmax_op(lg, v, plan))


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


def _edge_softmax_twin(logits, values, perm, indptr):
    """The CUDA kernel's recurrence, step for step, in float32 numpy: per
    row, walk the edges in plan order keeping (m, l, acc) per head and
    rescaling by exp(m_prev - m_new); out = acc / max(l, 1e-20)."""
    f = np.float32
    n, (h, d) = len(indptr) - 1, values.shape[1:]
    out = np.zeros((n, h, d), f)
    m_out = np.full((n, h), f(NEG), f)
    den = np.zeros((n, h), f)
    for i in range(n):
        m, l, acc = np.full(h, f(NEG), f), np.zeros(h, f), np.zeros((h, d), f)
        for e in perm[indptr[i]:indptr[i + 1]]:
            m_new = np.maximum(m, logits[e])
            alpha, p = np.exp(m - m_new), np.exp(logits[e] - m_new)
            l = l * alpha + p
            acc = acc * alpha[:, None] + p[:, None] * values[e]
            m = m_new
        out[i] = acc / np.maximum(l, f(1e-20))[:, None]
        m_out[i], den[i] = m, l
    return out, m_out, den


@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_recurrence_matches_plain_version(name):
    """The online recurrence of ``edge_softmax.cu``, run here on the CPU,
    agrees with the plain version — on all-masked rows exactly."""
    ids, n, logits, values, masked_rows, bucket = _case(name)
    plan, _ = _plans(name, ids, n, bucket, jax_plans=False)
    t_out, t_m, t_den = _edge_softmax_twin(
        logits, values, plan.perm.numpy(), plan.indptr.numpy())
    out, m, den = edge_softmax_ref(torch.from_numpy(logits),
                                   torch.from_numpy(values), plan.perm,
                                   plan.indptr, plan.num_segments)
    np.testing.assert_allclose(t_out, out.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_m, m.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_den, den.numpy(), rtol=RTOL, atol=ATOL)
    if name == "all_masked_rows":      # every edge of these rows masked
        np.testing.assert_array_equal(t_den[masked_rows],
                                      den.numpy()[masked_rows])
