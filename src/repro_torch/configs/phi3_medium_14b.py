"""Phi-3-medium 14B — dense RoPE SwiGLU GQA (40 q heads, 10 kv heads of
128), full attention. The same config as
``repro/configs/phi3_medium_14b.py``. [arXiv:2404.14219]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=10000.0,
    source="arXiv:2404.14219",
)
