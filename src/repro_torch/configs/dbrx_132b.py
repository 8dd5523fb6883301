"""DBRX-base 132B — fine-grained MoE, 16 experts top-4, GQA (48 q heads,
8 kv heads of 128). The same config as ``repro/configs/dbrx_132b.py``.
[hf:databricks/dbrx-base]"""
from repro_torch.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,           # GQA
    d_ff=10752,               # per expert (fine-grained)
    vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4),
    rope_theta=500000.0,
    source="hf:databricks/dbrx-base",
)
