"""MPGNN (paper Algorithm 1): K passes of NN-TGA plus a decoder, as one
``nn.Module`` (the counterpart of ``repro/core/mpgnn.py``)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.core.tgar import TGARLayer, layer_forward_block
from repro_torch.graph.csr import GraphBlock
from repro_torch.nn.layers import Dense


class MPGNNModel(nn.Module):
    """``layers`` (K TGAR layers) + ``decoder`` (one dense NN-T stage).
    ``aggregate_backend`` names the Sum-stage backend ("csc" runs the
    kernels and needs the block's plan)."""

    def __init__(self, layers: Sequence[TGARLayer], num_classes: int,
                 gen: torch.Generator, aggregate_backend: str = "csc"):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.num_classes = int(num_classes)
        self.aggregate_backend = aggregate_backend
        self.decoder = Dense(gen, self.layers[-1].out_dim, self.num_classes)

    @property
    def K(self) -> int:
        return len(self.layers)

    def encode(self, block: GraphBlock) -> torch.Tensor:
        """K passes of NN-TGA over the block; returns final embeddings."""
        h = block.x
        n = block.num_nodes_padded
        for k, layer in enumerate(self.layers):
            h = layer_forward_block(layer, h, block, k, n,
                                    backend=self.aggregate_backend)
        return h

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        """Decoder = a single NN-T (node-local) stage (§3.2)."""
        return self.decoder(h)

    def forward(self, block: GraphBlock) -> torch.Tensor:
        return self.decode(self.encode(block))


def forward_block(model: MPGNNModel, block: GraphBlock) -> torch.Tensor:
    return model(block)
