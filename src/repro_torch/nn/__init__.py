from repro_torch.nn.layers import (
    Dense, dense_init, dense_apply,
    rmsnorm_init, rmsnorm_apply,
    layernorm_init, layernorm_apply,
    embedding_init, embedding_apply,
    swiglu_init, swiglu_apply,
    gelu_mlp_init, gelu_mlp_apply,
    softmax_cross_entropy,
    binary_cross_entropy,
    dropout,
)
from repro_torch.nn.attention import (
    rope_frequencies, apply_rope, apply_mrope,
    attention_init, attention_apply,
    mla_init, mla_apply,
)

__all__ = [k for k in dir() if not k.startswith("_")]
