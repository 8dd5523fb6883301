"""MPGNN (paper Algorithm 1): K passes of NN-TGA plus a decoder, as one
``nn.Module``, and the loss over labeled nodes (the counterpart of
``repro/core/mpgnn.py``)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.core.tgar import TGARLayer, layer_forward_block
from repro_torch.graph.csr import GraphBlock
from repro_torch.nn.layers import Dense, softmax_cross_entropy


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


def loss_block(model: MPGNNModel, block: GraphBlock) -> torch.Tensor:
    """Loss = a single NN-T stage over labeled (loss-masked) nodes."""
    return softmax_cross_entropy(forward_block(model, block), block.y,
                                 block.loss_mask)


def accuracy_block(model: MPGNNModel, block: GraphBlock,
                   mask=None) -> torch.Tensor:
    """Accuracy on ``mask`` (default: the block's loss mask), as a 0-d
    tensor on the block's device."""
    pred = torch.argmax(forward_block(model, block), dim=-1)
    m = (mask if mask is not None else block.loss_mask).float()
    correct = (pred == block.y.long()).float() * m
    return torch.sum(correct) / torch.clamp_min(torch.sum(m), 1.0)
