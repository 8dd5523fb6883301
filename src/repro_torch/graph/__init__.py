from repro_torch.graph.csr import (Graph, GraphBlock, base_block,
                                   block_from_arrays, build_block)
from repro_torch.graph.datasets import DATASETS, make_dataset

__all__ = ["Graph", "GraphBlock", "base_block", "block_from_arrays",
           "build_block", "DATASETS", "make_dataset"]
