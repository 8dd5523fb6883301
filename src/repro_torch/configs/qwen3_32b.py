"""Qwen3-32B — dense, qk-norm, GQA (64 q heads, 8 kv heads of 128), RoPE
theta 1e6. The same config as ``repro/configs/qwen3_32b.py``.
[hf:Qwen/Qwen3-8B family card]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B",
)
