"""Bytes and operations of the Sum-stage kernels the benchmark times,
from the operation's shapes: each input byte read once and each output
byte written once, whatever the kernel reads again."""
from __future__ import annotations

from bench_h100.counts.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

F32 = I32 = 4


def edge_softmax(E: int, N: int, H: int, D: int) -> dict:
    """Softmax-weighted sums of (E, H, D) values over each node's incoming
    edges, with the (N, H) row maxima and denominators the backward
    keeps: reads logits (E, H), values (E, H, D), the destination
    structure (N + 1 row offsets and E edge positions); writes out
    (N, H, D), max and denominator (N, H) each. Per edge and head: a
    compare, a subtraction, an exponential, an addition and D
    multiply-adds; per output element a division."""
    read = E * H * F32 + E * H * D * F32 + (N + 1) * I32 + E * I32
    write = N * H * D * F32 + 2 * N * H * F32
    flops = E * H * (4 + 2 * D) + N * H * D
    return {"bytes": read + write, "flops": flops}


def segment_sum_bwd(E: int, N: int, D: int) -> dict:
    """The gather of a (N, D) cotangent to the edges, ``out[e] =
    g[dst[e]]``: reads g and the (E,) destination ids, writes (E, D); no
    arithmetic."""
    return {"bytes": N * D * F32 + E * I32 + E * D * F32, "flops": 0}


def least_seconds(count: dict) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 rate, whichever is larger."""
    return max(count["bytes"] / HBM_BYTES_PER_S,
               count["flops"] / FP32_FLOPS_PER_S)
