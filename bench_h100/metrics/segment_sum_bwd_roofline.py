"""``segment_sum_bwd``'s share of its roofline: the program's op wrapper
on the GCN cell's plan (the graph with its self-loops) with a seeded
cotangent at the hidden width, timed with CUDA events over many
launches, against the least time of its bytes (``counts/kernels.py``)."""
from bench_h100.counts.kernels import least_seconds, segment_sum_bwd
from bench_h100.trace import cuda_seconds


def read(ctx):
    if ctx.device.type != "cuda" or ctx.cfg["model"] != "gcn":
        return None
    import torch
    from repro_torch.kernels import ops
    plan = ctx.graph.csc_plan().to(ctx.device)
    E, N, D = plan.num_edges, plan.num_segments, ctx.cfg["hidden_dim"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    g = torch.randn(N, D, generator=gen, device=ctx.device)
    secs = cuda_seconds(lambda: ops.segment_sum_bwd_op(g, plan),
                        launches=20)
    return 100.0 * least_seconds(segment_sum_bwd(E, N, D)) / secs
