"""Whisper-base — encoder-decoder audio backbone: 6 bidirectional encoder
layers over 1,500 frames, 6 causal decoder layers with cross-attention,
LayerNorm and a GELU MLP. The same config as
``repro/configs/whisper_base.py``; the conv/mel frontend is a stub there
too (the caller supplies precomputed frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,             # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,           # MHA
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq=1500,         # stub frontend output frames
    cross_attention=True,
    norm_type="layernorm",
    source="arXiv:2212.04356",
)
