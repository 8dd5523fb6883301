"""The whole step's share of the cards' float32 peak: the step's model
FLOPs (``counts/<model>.py``) times the traced window's steps, over its
time and the cards' 67 TFLOP/s each."""
from bench_h100.counts import train_step_flops
from bench_h100.counts.peaks import FP32_FLOPS_PER_S


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    flops = train_step_flops(ctx.cfg, ctx.num_nodes, ctx.num_edges)
    return 100.0 * flops * ctx.steps / ctx.window_s / (
        FP32_FLOPS_PER_S * ctx.chips)
