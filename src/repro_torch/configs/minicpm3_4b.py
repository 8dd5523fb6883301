"""MiniCPM3-4B — multi-head latent attention (MLA: q and kv low-rank
latents, a shared RoPE key head), tied embeddings. The same config as
``repro/configs/minicpm3_4b.py``. [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.config import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,          # MLA: latent cache replaces GQA
    d_ff=6400,
    vocab_size=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
    source="hf:openbmb/MiniCPM3-4B",
)
