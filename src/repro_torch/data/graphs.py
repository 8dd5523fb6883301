"""Host-side helpers that stage graph features and labels for device
batches (the counterpart of ``repro/data/graphs.py``)."""
from __future__ import annotations

import numpy as np


def graph_feature_batch(features: np.ndarray, labels: np.ndarray,
                        node_ids: np.ndarray, pad_to: int = 0) -> dict:
    """Slice features/labels by node ids, padding with id 0 / mask 0."""
    n = len(node_ids)
    size = max(pad_to, n)
    ids = np.zeros(size, np.int32)
    mask = np.zeros(size, np.float32)
    ids[:n] = node_ids
    mask[:n] = 1.0
    return {
        "x": features[ids].astype(np.float32),
        "y": labels[ids].astype(np.int32),
        "mask": mask,
        "ids": ids,
    }
