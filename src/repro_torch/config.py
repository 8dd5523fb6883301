"""Model and training configuration (the counterpart of
``repro/config.py``): the GNN side's ``GNNConfig`` and ``TrainConfig``,
and the LM zoo's ``ArchConfig`` with its sub-configs, ``reduced()``, the
analytic ``param_count`` and ``active_param_count`` that the dry-run's
roofline reads, the four workload ``INPUT_SHAPES``, ``ASSIGNED_ARCHS``
and ``get_arch_config``. A copy, not an import: the port stands alone.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


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

    def param_count(self) -> int:
        """Analytic total parameter count (the roofline's MODEL_FLOPS),
        the reference's formula: the products' weights, no norms or
        biases."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = 0
        if self.num_heads:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            per_attn = q + kv + o
        if self.mla is not None:
            m = self.mla
            qh = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_attn = (d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qh
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * self.num_heads
                        * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.num_heads * m.v_head_dim * d)
        per_ffn = 3 * d * f  # SwiGLU
        if self.moe is not None:
            moe_ffn = self.moe.num_experts * 3 * d * f \
                + d * self.moe.num_experts
            # average per layer given MoE on every moe_every-th layer
            k = max(self.moe_every, 1)
            per_ffn = moe_ffn / k + (3 * d * f) * (k - 1) / k
        per_mamba = 0
        if self.mamba is not None:
            mc = self.mamba
            d_in = mc.expand * d
            per_mamba = (2 * d * d_in            # in_proj (x, z)
                         + d_in * mc.d_conv      # conv
                         + d_in * (2 * mc.d_state + (mc.dt_rank or d // 16))
                         + (mc.dt_rank or d // 16) * d_in
                         + d_in * d              # out_proj
                         + d_in * mc.d_state)    # A_log
        per_rwkv = 0
        if self.rwkv is not None:
            rc = self.rwkv
            # r,k,v,gate,out projections + low-rank data-dependent decay
            per_rwkv = 5 * d * d + 2 * rc.decay_lora * d
        total = emb
        n_attn, n_mix = self._layer_split()
        if self.rwkv is not None:
            total += self.num_layers * (per_rwkv + 2 * d * f)
        elif self.mamba is not None and self.attn_every:
            total += n_attn * (per_attn + per_ffn)
            total += n_mix * (per_mamba + per_ffn)
        elif self.mamba is not None:
            total += self.num_layers * (per_mamba + per_ffn)
        else:
            total += self.num_layers * (per_attn + per_ffn)
        if self.encoder_layers:
            # encoder self-attn + ffn; decoder additionally has cross-attn
            total += self.encoder_layers * (per_attn + per_ffn)
            total += self.num_layers * per_attn
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE counts only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        k = max(self.moe_every, 1)
        n_moe_layers = self.num_layers // k
        all_experts = n_moe_layers * self.moe.num_experts * 3 * d * f
        active_experts = n_moe_layers * self.moe.top_k * 3 * d * f
        return int(self.param_count() - all_experts + active_experts)

    def _layer_split(self) -> Tuple[int, int]:
        """(attention layers, mixer layers) for hybrid archs."""
        if self.attn_every:
            n_attn = self.num_layers // self.attn_every
            return n_attn, self.num_layers - n_attn
        return self.num_layers, 0

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


# ---------------------------------------------------------------------------
# Input shapes (the four assigned workloads) and the zoo's members
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ASSIGNED_ARCHS = [
    "dbrx-132b",
    "mixtral-8x7b",
    "qwen3-4b",
    "rwkv6-1.6b",
    "phi3-medium-14b",
    "whisper-base",
    "qwen3-32b",
    "minicpm3-4b",
    "jamba-1.5-large-398b",
    "qwen2-vl-2b",
]


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


def list_arch_configs() -> dict:
    return {a: get_arch_config(a) for a in ASSIGNED_ARCHS}
