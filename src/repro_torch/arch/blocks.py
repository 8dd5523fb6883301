"""Pre-norm residual blocks of the LM zoo (the counterpart of
``repro/arch/blocks.py``), for every kind the reference has: ``attn``
(GQA, optionally sliding-window, with a SwiGLU FFN: qwen3, phi3; or an
MoE FFN: mixtral, dbrx; or MLA: minicpm3; or LayerNorm, cross-attention
and a GELU MLP: whisper; or M-RoPE: qwen2-vl), ``mamba`` (the Mamba
mixer, with a SwiGLU or MoE FFN: jamba) and ``rwkv`` (RWKV-6).

``train=True`` takes the reference's training path, under autograd:
attention without a cache through ``_sdpa``, RWKV-6 through the plain
``wkv_chunked``. Without it a block with no cache (the served encoder)
attends through the ``flash_attention`` kernel, and RWKV-6 runs the
forward-only ``wkv6`` kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.arch.hints import shard_hint
from repro_torch.arch.mamba import (mamba_apply, mamba_init,
                                    mamba_init_cache)
from repro_torch.arch.moe import (moe_ffn_dense, moe_ffn_ep,
                                  moe_ffn_ep_replicated, moe_init)
from repro_torch.arch.rwkv6_block import (rwkv_channel_apply,
                                          rwkv_channel_init, rwkv_init_cache,
                                          rwkv_time_apply, rwkv_time_init)
from repro_torch.config import ArchConfig
from repro_torch.nn.attention import (attention_apply, attention_init,
                                     mla_apply, mla_init)
from repro_torch.nn.layers import (gelu_mlp_apply, gelu_mlp_init,
                                   layernorm_apply, layernorm_init,
                                   rmsnorm_apply, rmsnorm_init, swiglu_apply,
                                   swiglu_init)

KINDS = ("attn", "mamba", "rwkv")


def _norm_init(cfg: ArchConfig, dtype, device=None) -> dict:
    if cfg.norm_type == "layernorm":
        return layernorm_init(cfg.d_model, dtype, device)
    return rmsnorm_init(cfg.d_model, dtype, device)


def norm_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    if "bias" in p:
        return layernorm_apply(p, x, cfg.norm_eps)
    return rmsnorm_apply(p, x, cfg.norm_eps)


def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str,
               dtype, cross_attention: bool = False,
               use_moe: bool = True, experts=None) -> dict:
    """The weights of one block of ``kind`` ("attn" | "mamba" | "rwkv"),
    drawn from ``gen`` on its device, as a dict with the reference's
    names. ``cross_attention`` adds ``norm_x`` and ``xattn`` to an
    attention block (Whisper's decoder). ``use_moe``: whether THIS
    layer's FFN is MoE when the config has one (the reference's
    ``moe_every`` rule picks it per layer); ``experts`` (lo, hi) keeps
    only those experts of its stacks (:func:`~repro_torch.arch.moe.
    moe_init`)."""
    if kind not in KINDS:
        raise ValueError(kind)
    p: dict = {"norm1": _norm_init(cfg, dtype, gen.device)}
    if kind in ("attn", "mamba"):
        if kind == "mamba":
            p["mixer"] = mamba_init(gen, cfg.d_model, cfg.mamba, dtype)
        elif cfg.mla is not None:
            p["attn"] = mla_init(gen, cfg.d_model, cfg.num_heads, cfg.mla,
                                 dtype)
        else:
            p["attn"] = attention_init(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, dtype, qk_norm=cfg.qk_norm)
        if kind == "attn" and cross_attention:
            p["norm_x"] = _norm_init(cfg, dtype, gen.device)
            p["xattn"] = attention_init(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim, dtype)
        p["norm2"] = _norm_init(cfg, dtype, gen.device)
        if cfg.moe is not None and use_moe:
            p["ffn"] = moe_init(gen, cfg.d_model, cfg.d_ff,
                                cfg.moe.num_experts, dtype, experts)
        elif kind == "attn" and cfg.norm_type == "layernorm":
            p["ffn"] = gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
        else:
            p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype)
    else:
        p["time"] = rwkv_time_init(gen, cfg.d_model, cfg.rwkv, dtype)
        p["norm2"] = _norm_init(cfg, dtype, gen.device)
        p["channel"] = rwkv_channel_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def block_cache_init(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                     dtype, rolling: bool = False, device=None) -> dict:
    """Decode cache for one block of the given kind. ``rolling``: the
    sliding-window cache of ``cache_len`` slots (the window), with
    ``pos``, each slot's position (-1: empty). MLA keeps the compressed
    ``c_kv`` and ``k_rope``, Mamba its conv window and state."""
    if kind not in KINDS:
        raise ValueError(kind)
    if kind == "attn" and cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, cache_len,
                                       m.qk_rope_head_dim), dtype=dtype,
                                      device=device)}
    if kind == "attn":
        hd = cfg.resolved_head_dim
        shape = (batch, cache_len, cfg.num_kv_heads, hd)
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
        if rolling:
            c["pos"] = torch.full((cache_len,), -1, dtype=torch.int32,
                                  device=device)
        return c
    if kind == "mamba":
        return mamba_init_cache(batch, cfg.mamba, cfg.d_model, dtype,
                                device)
    return rwkv_init_cache(batch, cfg.d_model, cfg.rwkv, dtype, device)


def _ffn_apply(p_ffn, x: torch.Tensor, cfg: ArchConfig, moe_impl: str,
               mesh=None):
    """The block's FFN and its auxiliary loss (0 without MoE). The
    reference's rule (``repro/arch/blocks.py:_ffn_apply``): expert
    parallelism only when ``moe_impl == "ep"`` and a mesh is given,
    with the batch split over its ``data`` axis (and S over the model
    ranks that other processes hold, when the mesh's communicator holds
    fewer than all of them); dense dispatch otherwise."""
    if cfg.moe is not None and "router" in p_ffn:
        if moe_impl == "ep" and mesh is not None:
            if mesh.comm.count != mesh.model:
                return moe_ffn_ep_replicated(p_ffn, x, cfg.moe, mesh)
            return moe_ffn_ep(p_ffn, x, cfg.moe, mesh,
                              dp_axis="data")
        return moe_ffn_dense(p_ffn, x, cfg.moe)
    zero = x.new_zeros((), dtype=torch.float32)
    if "wi" in p_ffn:                       # gelu mlp (whisper)
        return gelu_mlp_apply(p_ffn, x), zero
    return swiglu_apply(p_ffn, x), zero


def block_apply(p, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                positions=None, mrope_positions=None, causal=True,
                cache=None, cache_index=None, enc_memory=None,
                moe_impl: str = "dense", mesh=None,
                sliding_window: Optional[int] = None, valid=None,
                kv_start=None, train: bool = False):
    """Pre-norm residual block. Returns (x, new_cache, aux_loss).
    ``valid``: (B, P) pad mask over the first P cache slots (serving
    with left-padded prompts) and ``kv_start`` its first real slot per
    row (prefill, GQA); only the attention path reads them, so a Mamba
    or RWKV row's pads enter its state (ROADMAP C.11). ``enc_memory``
    (B, T_enc, D): the encoder's output, which the decoder's
    cross-attention reads after its self-attention. ``train``: the
    reference's training path (see the module's docstring). ``mesh``:
    the :class:`~repro_torch.launch.mesh.ExpertMesh` that
    ``moe_impl="ep"`` runs over (``_ffn_apply``)."""
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    new_cache = None
    if kind in ("attn", "mamba"):
        h = norm_apply(cfg, p["norm1"], x)
        if kind == "attn":
            h = shard_hint(h, "batch", "seq", None)
        if kind == "mamba":
            out = mamba_apply(p["mixer"], h, cfg.mamba, cache=cache)
        elif cfg.mla is not None:
            out = mla_apply(
                p["attn"], h, num_heads=cfg.num_heads, mla=cfg.mla,
                positions=positions, rope_theta=cfg.rope_theta,
                norm_eps=cfg.norm_eps, cache=cache,
                cache_index=cache_index, valid=valid)
        else:
            out = attention_apply(
                p["attn"], h, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, positions=positions,
                rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                norm_eps=cfg.norm_eps, causal=causal, sliding_window=sw,
                cache=cache, cache_index=cache_index,
                mrope_positions=mrope_positions, valid=valid,
                kv_start=kv_start, kernel=not train)
        a, new_cache = (out if cache is not None or kind == "mamba"
                        else (out, None))
        x = x + a
        if enc_memory is not None:
            hx = norm_apply(cfg, p["norm_x"], x)
            x = x + attention_apply(
                p["xattn"], hx, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, kv_x=enc_memory,
                causal=False)
        h2 = norm_apply(cfg, p["norm2"], x)
        if kind == "attn":
            h2 = shard_hint(h2, "batch", "seq", None)
        f, aux = _ffn_apply(p["ffn"], h2, cfg, moe_impl, mesh)
        x = x + f
    elif kind == "rwkv":
        h = norm_apply(cfg, p["norm1"], x)
        t, c_t = rwkv_time_apply(p["time"], h, cfg.rwkv, cfg.norm_eps,
                                 cache=cache["time"] if cache else None,
                                 train=train)
        x = x + t
        h2 = norm_apply(cfg, p["norm2"], x)
        c, c_c = rwkv_channel_apply(p["channel"], h2,
                                    cache=cache["channel"] if cache else None)
        x = x + c
        if cache is not None:
            new_cache = {"time": c_t, "channel": c_c}
        aux = x.new_zeros((), dtype=torch.float32)
    else:
        raise ValueError(kind)
    x = shard_hint(x, "batch", "seq", None)
    return x, new_cache, aux
