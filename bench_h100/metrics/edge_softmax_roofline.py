"""``edge_softmax``'s share of its roofline: the program's op wrapper on
the cell's layer-0 destination plan (the whole graph) with seeded
logits and values at the configuration's heads, timed with CUDA events
over many launches, against the least time of its bytes and operations
(``counts/kernels.py``)."""
from bench_h100.counts.kernels import edge_softmax, least_seconds
from bench_h100.trace import cuda_seconds


def read(ctx):
    if ctx.device.type != "cuda" or ctx.cfg["model"] != "gat_e":
        return None
    import torch
    from repro_torch.kernels import ops
    plan = ctx.graph.csc_plan().to(ctx.device)
    E, N = plan.num_edges, plan.num_segments
    H = ctx.cfg["num_heads"]
    D = ctx.cfg["hidden_dim"] // H
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    logits = torch.randn(E, H, generator=gen, device=ctx.device)
    values = torch.randn(E, H, D, generator=gen, device=ctx.device)
    secs = cuda_seconds(lambda: ops.edge_softmax_fwd_op(logits, values,
                                                        plan))
    return 100.0 * least_seconds(edge_softmax(E, N, H, D)) / secs
