"""The port's host data path against the JAX package's, bit for bit:
datasets, compact K-hop views and the subgraph-size measure, staged
bucket blocks, the plan, and the LM zoo's synthetic token stream."""
import jax  # noqa: F401 — imported first so JAX stays on the CPU
import numpy as np
import pytest
import torch

from repro.core.subgraph import subgraph_size_stats as jax_size_stats
from repro.core.views import CompactBlockBuilder as JaxStager
from repro.core.views import ViewBuilder as JaxViewBuilder
from repro.graph.datasets import make_dataset as jax_dataset
from repro.kernels.ops import build_bucket_csc_plan as jax_bucket_plan
from repro_torch.core.subgraph import subgraph_size_stats
from repro_torch.core.views import (BucketSpec, CompactBlockBuilder,
                                    ViewBuilder)
from repro_torch.graph import DATASETS, make_dataset

SMALL = {"reddit_like": 400, "amazon_like": 400, "alipay_like": 500}
GRAPH_FIELDS = ("src", "dst", "node_features", "labels", "edge_features",
                "edge_weights", "train_mask", "val_mask", "test_mask")
BLOCK_FIELDS = ("src", "dst", "edge_mask", "node_mask", "x", "y",
                "loss_mask", "edge_weight", "edge_attr", "node_active",
                "edge_active")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(name, **kw):
    return jax_dataset(name, seed=0, **kw), make_dataset(name, seed=0, **kw)


def _assert_same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", DATASETS)
def test_make_dataset_bit_identical(name):
    kw = {"num_nodes": SMALL[name]} if name in SMALL else {}
    want, got = _pair(name, **kw)
    assert (got.num_nodes, got.name) == (want.num_nodes, want.name)
    for f in GRAPH_FIELDS:
        _assert_same(getattr(want, f), getattr(got, f), f"{name}.{f}")


@pytest.mark.parametrize("name,cap", [("alipay_like", 0),
                                      ("alipay_like", 3),
                                      ("reddit_like", 0)])
def test_khop_compact_identical(name, cap):
    jg, pg = _pair(name, num_nodes=SMALL[name])
    targets = np.random.default_rng(1).choice(jg.num_nodes, 9,
                                              replace=False)
    jv = JaxViewBuilder(jg, 2, compact=True).khop_compact(
        targets, cap, np.random.default_rng(2) if cap else None)
    pv = ViewBuilder(pg, 2).khop_compact(
        targets, cap, np.random.default_rng(2) if cap else None)
    for f in ("nodes", "hop_offsets", "src_local", "dst_local", "edge_ids",
              "loss_local"):
        _assert_same(getattr(jv, f), getattr(pv, f), f)
    assert jv.meta == pv.meta


@pytest.mark.parametrize("name,K", [("alipay_like", 1), ("alipay_like", 3),
                                    ("reddit_like", 2)])
def test_subgraph_size_stats_identical(name, K):
    """The paper's §1 subgraph-explosion measure, value for value (its
    ``hop_sizes`` and the touched share as Python numbers)."""
    jg, pg = _pair(name, num_nodes=SMALL[name])
    targets = np.random.default_rng(5).choice(jg.num_nodes, 7,
                                              replace=False)
    want = jax_size_stats(jg, targets, K)
    got = subgraph_size_stats(pg, targets, K)
    assert got == want
    assert [type(v) for v in got.values()] == [int, int, float, list]


@pytest.mark.parametrize("gcn_norm", [True, False])
def test_staged_block_and_plan_match_reference(gcn_norm):
    jg, pg = _pair("alipay_like", num_nodes=SMALL["alipay_like"])
    targets = np.arange(0, 60, 7)
    jv = JaxViewBuilder(jg, 2, compact=True).khop_compact(targets)
    pv = ViewBuilder(pg, 2).khop_compact(targets)
    jb = JaxStager(jg, 2, gcn_norm=gcn_norm, csc_plan=True).stage(jv)
    pb = CompactBlockBuilder(pg, 2, gcn_norm=gcn_norm,
                             csc_plan=True).stage(pv)
    for f in BLOCK_FIELDS:
        t = getattr(pb, f)
        _assert_same(getattr(jb, f), None if t is None else t.numpy(), f)

    # the plan: perm/indptr give every real edge's destination once, in
    # edge order within a row; pad edges join no row; edge_dst is the
    # reference plan's inverse map
    plan = pb.csc_plan
    perm, indptr = plan.perm.numpy(), plan.indptr.numpy()
    e = pv.num_edges
    assert plan.num_segments == pb.num_nodes_padded
    assert plan.num_edges == pb.num_edges_padded
    assert indptr[-1] == e
    np.testing.assert_array_equal(np.sort(perm[:e]), np.arange(e))
    rows = np.repeat(np.arange(plan.num_segments), np.diff(indptr))
    np.testing.assert_array_equal(pv.dst_local[perm[:e]], rows)
    for i in np.flatnonzero(np.diff(indptr) > 1):
        assert (np.diff(perm[indptr[i]:indptr[i + 1]]) > 0).all()
    jplan = jax_bucket_plan(jv.dst_local, *jb.x.shape[:1],
                            jb.src.shape[0])
    np.testing.assert_array_equal(plan.edge_dst.numpy(),
                                  jplan.edge_dst[:plan.num_edges])


def test_whole_graph_plan_matches_csc():
    _, g = _pair("reddit_like", num_nodes=SMALL["reddit_like"])
    g = g.add_self_loops()
    plan = g.csc_plan()
    indptr, order = g.csc()
    np.testing.assert_array_equal(plan.indptr.numpy(), indptr)
    np.testing.assert_array_equal(plan.perm.numpy(), order)
    np.testing.assert_array_equal(plan.edge_dst.numpy(), g.dst)
    assert g.csc_plan() is plan                      # built once per graph


def test_staged_blocks_alias_ring_slots_until_copied():
    """A staged block shares its ring slot's memory; ``to(copy=True)``
    detaches it before the next view in the bucket overwrites the slot."""
    _, g = _pair("alipay_like", num_nodes=SMALL["alipay_like"])
    vb = ViewBuilder(g, 2)
    stager = CompactBlockBuilder(g, 2, buckets=BucketSpec(((512, 4096),)),
                                 slots=1, csc_plan=True)
    first = stager.stage(vb.khop_compact(np.array([1, 2])))
    kept = first.to("cpu", copy=True)
    x0 = kept.x.clone()
    stager.stage(vb.khop_compact(np.array([100, 200, 300])))
    assert not torch.equal(first.x, x0)       # the slot was overwritten
    assert torch.equal(kept.x, x0)            # the copy was not
    assert kept.csc_plan.perm.data_ptr() != first.csc_plan.perm.data_ptr()


def test_bucket_overflow_escalates_with_one_warning():
    _, g = _pair("alipay_like", num_nodes=SMALL["alipay_like"])
    vb = ViewBuilder(g, 2)
    stager = CompactBlockBuilder(g, 2, buckets=BucketSpec(((64, 256),)))
    with pytest.warns(RuntimeWarning, match="overflows every bucket"):
        big = stager.stage(vb.khop_compact(np.arange(0, 60, 3)))
    stager.stage(vb.khop_compact(np.arange(1, 60, 3)))   # no second warning
    assert stager.overflows == 2
    assert big.num_nodes_padded >= 64 and big.num_edges_padded > 256
    with pytest.raises(ValueError, match="overflows every bucket"):
        BucketSpec(((64, 256),)).pick(65, 1)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(1024, 32, 2, 0),
                                                  (256, 17, 3, 5)])
def test_token_batches_bit_identical(vocab, seq, batch, seed):
    """``SyntheticLMDataset`` and ``token_batches`` (the port's copy of
    ``repro/data/tokens.py``): the same int32 tokens and labels for every
    batch index, from any start."""
    from repro.data import SyntheticLMDataset as JaxDataset
    from repro.data import token_batches as jax_batches
    from repro_torch.data import SyntheticLMDataset, token_batches
    want, got = JaxDataset(vocab, seq, batch, seed), SyntheticLMDataset(
        vocab, seq, batch, seed)
    for i in (0, 1, 7):
        for k in ("tokens", "labels"):
            _assert_same(got.batch(i)[k], want.batch(i)[k], f"{k} {i}")
    gi, wi = token_batches(vocab, seq, batch, seed, start=3), jax_batches(
        vocab, seq, batch, seed, start=3)
    for _ in range(2):
        g, w = next(gi), next(wi)
        for k in ("tokens", "labels"):
            _assert_same(g[k], w[k], k)
