"""Qwen2-VL-2B — VLM decoder backbone with M-RoPE (three position streams
t, h, w); 12 query heads over 2 KV heads of 128, tied embeddings. The
same config as ``repro/configs/qwen2_vl_2b.py``; the ViT frontend is a
stub there too (the caller supplies patch and text embeddings and the
three position streams). [arXiv:2409.12191]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    embed_inputs=True,        # stub multimodal frontend
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="arXiv:2409.12191",
)
