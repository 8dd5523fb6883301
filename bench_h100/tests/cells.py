"""Each cell at a test's size, for the CPU tests: a few hundred nodes and
a few steps, at the configuration's widths."""
SMALL = {
    "gat_e.alipay_share.global": {
        "cfg": {"num_nodes": 600},
        "mix": {"rate_steps": 3, "min_steps": 3}},
    "gcn.reddit_quarter.global": {
        "cfg": {"num_nodes": 400},
        "mix": {"graph": {"p_in": 0.5, "p_out": 0.03}, "rate_steps": 3,
                "min_steps": 3}},
}
# the GAT-E cell's mix over two ranks (gloo on the CPU), each holding one
# partition of the engine: the harness's path for a cell over cards
TWO_RANKS = {"ranks": 2, "engine_partitions": 2,
             "partition_method": "1d_src"}
