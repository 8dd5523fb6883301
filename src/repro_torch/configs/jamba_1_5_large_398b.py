"""Jamba-1.5-Large 398B — hybrid Mamba + attention (1:7 interleave: one
attention layer then seven Mamba layers a group), MoE 16 experts top-2
on every second layer, GQA (64 q heads, 8 kv heads of 128). The same
config as ``repro/configs/jamba_1_5_large_398b.py``. [arXiv:2403.19887]"""
from repro_torch.config import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2),
    moe_every=2,              # MoE on every 2nd layer (Jamba block design)
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      chunk=128),
    attn_every=8,             # 1 attention per 8 layers (1:7)
    source="arXiv:2403.19887",
)
