"""Mixtral 8x7B — 8 experts top-2, sliding-window attention (window
4096), GQA (32 q heads, 8 kv heads of 128). The same config as
``repro/configs/mixtral_8x7b.py``. [arXiv:2401.04088]"""
from repro_torch.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    moe=MoEConfig(num_experts=8, top_k=2),
    sliding_window=4096,
    rope_theta=1000000.0,
    source="arXiv:2401.04088",
)
