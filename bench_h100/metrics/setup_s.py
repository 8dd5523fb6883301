"""Process start to the window's start (host clock): imports, kernels
from their cache, the graph, plans, partitions, views, captures and the
warm-up."""


def read(ctx):
    return ctx.setup_s
