"""Model and training configuration (the counterpart of
``repro/config.py``): the GNN side's ``GNNConfig`` and ``TrainConfig``,
and the LM zoo's ``ArchConfig`` with its sub-configs, ``reduced()`` and
``get_arch_config``. A copy, not an import: the port stands alone.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"              # gcn | sage | sage_max | gat | gat_e
    num_layers: int = 2
    hidden_dim: int = 16
    num_classes: int = 7
    feature_dim: int = 64
    edge_feature_dim: int = 0       # >0 enables edge-attributed models (GAT-E)
    num_heads: int = 1              # GAT heads
    dropout: float = 0.5
    residual: bool = False
    mean_aggregate: bool = True     # mean vs sum neighbor aggregation
    # Sum-stage aggregation backend: "csc" (the CUDA kernels, their plain
    # versions on the CPU) or "reference" (plain segment ops, CPU only);
    # see repro_torch.core.aggregate
    aggregate_backend: str = "csc"


@dataclass(frozen=True)
class TrainConfig:
    strategy: str = "global"        # global | mini | cluster
    lr: float = 1e-2
    weight_decay: float = 5e-4
    optimizer: str = "adam"         # sgd | adam | adamw
    steps: int = 200
    batch_nodes: int = 0            # mini-batch: #target nodes (0 = 1%)
    batch_clusters: int = 0         # cluster-batch: #clusters per step
    cluster_halo_hops: int = 0      # boundary halo (paper's optional feature)
    seed: int = 0
    grad_clip: float = 0.0


def get_gnn_config(name: str):
    """``(CONFIG, DATASET)`` of a config module under
    ``repro_torch.configs`` (e.g. ``"gnn_gat_e_alipay"``)."""
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG, mod.DATASET


# ---------------------------------------------------------------------------
# Architecture configs (the LM zoo)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    dt_rank: int = 0            # 0 => max(1, d_model // 16), as the
    #                             reference's code floors it


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 128
    decay_lora: int = 64        # low-rank data-dependent decay (Finch)
    gate_lora: int = 64


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    sliding_window: int = 0          # 0 => full attention
    rope_theta: float = 10000.0
    mrope: bool = False              # multimodal RoPE (qwen2-vl)
    mla: Optional[MLAConfig] = None  # multi-head latent attention
    # --- mixture of experts -------------------------------------------------
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    # --- SSM / hybrid -------------------------------------------------------
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_every: int = 0              # hybrid: 1 attention layer per this many
    # --- encoder-decoder (whisper) ------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500
    cross_attention: bool = False
    # --- vlm ----------------------------------------------------------------
    embed_inputs: bool = False
    # --- numerics / misc ----------------------------------------------------
    dtype: str = "bfloat16"
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm (whisper)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    source: str = ""                 # citation for the config

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts — the
        same cut as the reference's ``ArchConfig.reduced``."""
        d = min(self.d_model, 256)
        hd = 32
        heads = max(2, min(self.num_heads, 4)) if self.num_heads else 0
        kv = min(self.num_kv_heads, heads) if heads else 0
        kv = max(kv, 1) if heads else 0
        if heads and self.num_kv_heads == self.num_heads:
            kv = heads
        kw = dict(
            num_layers=2, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=hd if heads else 0, d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            encoder_layers=(min(self.encoder_layers, 2)
                            if self.encoder_layers else 0),
            encoder_seq=min(self.encoder_seq, 64),
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2))
        if self.mamba is not None:
            kw["mamba"] = dataclasses.replace(
                self.mamba, d_state=8, head_dim=32, chunk=16)
        if self.rwkv is not None:
            kw["rwkv"] = dataclasses.replace(
                self.rwkv, head_dim=32, chunk=16, decay_lora=16,
                gate_lora=16)
        if self.attn_every:
            kw["attn_every"] = 2
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=16, qk_rope_head_dim=16,
                                  v_head_dim=16)
        return self.replace(**kw)


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_arch_config(name: str) -> ArchConfig:
    """The ``CONFIG`` of ``repro_torch/configs/<name>.py`` (dashes and
    dots become underscores); ``ValueError`` for a name the zoo does not
    have."""
    try:
        mod = importlib.import_module(
            f"repro_torch.configs.{_module_name(name)}")
    except ModuleNotFoundError as e:
        raise ValueError(f"unknown architecture {name!r}") from e
    return mod.CONFIG
