"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay; 32 heads
of 64, chunk 128, decay LoRA 64. The same config as
``repro/configs/rwkv6_1_6b.py``. [arXiv:2404.05892]"""
from repro_torch.config import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, chunk=128, decay_lora=64),
    source="arXiv:2404.05892",
)
