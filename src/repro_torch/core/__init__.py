"""The TGAR compute pattern, the Sum stage, the host view path and the
hybrid-parallel distributed engine with its trainers."""
from repro_torch.core.aggregate import (
    COMBINE_SPECS, AggregationBackend, CombineSpec, ShardContext, combine,
    get_backend, register_backend,
)
from repro_torch.core.tgar import (
    TGARLayer, segment_sum, segment_mean, segment_max, segment_softmax,
)
from repro_torch.core.mpgnn import MPGNNModel, forward_block, loss_block
from repro_torch.core.partition import (
    PartitionPlan, ShardedGraph, build_partitions, partition_stats,
)
from repro_torch.core.strategies import (
    GraphView, global_batch_view, mini_batch_views, cluster_batch_views,
    shard_view, shard_view_loop, strategy_views,
)
from repro_torch.core.views import (
    ClusterViewCache, ClusterViewStream, GlobalViewStream,
    MiniBatchViewStream, ViewBuilder, ViewStream, cluster_view_recompute,
)
from repro_torch.core.subgraph import (
    khop_subgraph_view, bfs_layers, bfs_layers_loop,
)
from repro_torch.core.clustering import (
    label_propagation_clusters, hash_clusters,
)
from repro_torch.core.comm import Comm, LocalComm, ProcessGroupComm
from repro_torch.core.engine import HybridParallelEngine
from repro_torch.core.trainer import CompactTrainer, RetraceError, Trainer

__all__ = [k for k in dir() if not k.startswith("_")]
