"""The LM zoo's architectures (the counterpart of ``repro/arch``): the
blocks the port serves and the model around them."""
from repro_torch.arch.hints import shard_hint, use_hints
from repro_torch.arch.model import TransformerLM, build_model, layer_kinds

__all__ = ["TransformerLM", "build_model", "layer_kinds", "use_hints",
           "shard_hint"]
