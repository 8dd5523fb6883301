"""The frozen FLOP and byte counts against small cases worked by hand."""
import pytest

from bench_h100 import counts as steps
from bench_h100.counts import kernels, peaks


def test_edge_softmax_bytes_and_flops_by_hand():
    # E=2 edges into N=1 node, H=1 head of D=1: logits 8 B, values 8 B,
    # offsets 2 x 4 B, edge positions 8 B; out 4 B, max and sum 8 B
    c = kernels.edge_softmax(E=2, N=1, H=1, D=1)
    assert c["bytes"] == 8 + 8 + 8 + 8 + 4 + 8
    assert c["flops"] == 2 * (4 + 2) + 1


def test_edge_softmax_at_the_200k_plan_matches_the_recorded_bound():
    c = kernels.edge_softmax(E=1_199_822, N=200_000, H=4, D=8)
    assert kernels.least_seconds(c) == pytest.approx(0.0628e-3, rel=2e-3)


def test_segment_sum_bwd_bytes_by_hand():
    # g (2, 2) 16 B, three ids 12 B, out (3, 2) 24 B
    c = kernels.segment_sum_bwd(E=3, N=2, D=2)
    assert c == {"bytes": 16 + 12 + 24, "flops": 0}
    assert kernels.least_seconds(c) == 52 / peaks.HBM_BYTES_PER_S


def test_gcn_step_flops_by_hand():
    cfg = {"model": "gcn", "num_layers": 1, "feature_dim": 2,
           "hidden_dim": 3, "num_classes": 2}
    # layer: h W 2*4*2*3 = 48, twice (no input gradient); norm x and sum
    # 2*5*3 = 30, bias and ReLU 2*4*3 = 24, three times; decoder
    # 2*4*3*2 + 4*2 = 56 and loss 4*4*2 = 32, three times each
    assert steps.train_step_flops(cfg, 4, 5) == 2 * 48 + 3 * 54 \
        + 3 * 56 + 3 * 32


def test_gat_e_step_flops_by_hand():
    cfg = {"model": "gat_e", "num_layers": 1, "feature_dim": 2,
           "hidden_dim": 4, "num_heads": 2, "edge_feature_dim": 3,
           "num_classes": 2}
    N, E = 3, 5
    transform = 2 * N * 2 * 4                       # 48
    rest = (2 * 2 * N * 4 + 2 * E * 3 * 2 + 2 * E * 3 * 4 + 3 * E * 2
            + E * 4 + E * 2 * 4 + 2 * E * 4 + N * 4 + 2 * N * 4)
    assert rest == 48 + 60 + 120 + 30 + 20 + 40 + 40 + 12 + 24
    decoder, loss = 2 * N * 4 * 2 + N * 2, 4 * N * 2
    assert steps.train_step_flops(cfg, N, E) == 2 * transform + 3 * rest \
        + 3 * decoder + 3 * loss
