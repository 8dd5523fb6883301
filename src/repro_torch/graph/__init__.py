from repro_torch.graph.csr import (Graph, GraphBlock, base_block,
                                   block_from_arrays, build_block)
from repro_torch.graph.datasets import (DATASETS, citation_graph,
                                        make_dataset, powerlaw_graph,
                                        sbm_graph)

__all__ = ["Graph", "GraphBlock", "base_block", "block_from_arrays",
           "build_block", "DATASETS", "sbm_graph", "powerlaw_graph",
           "citation_graph", "make_dataset"]
