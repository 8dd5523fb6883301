"""The LM zoo's model for serving: prefill and decode (the counterpart of
``repro/arch/model.py``).

:class:`TransformerLM` is an ``nn.Module`` whose blocks sit in an
``nn.ModuleList``, one :class:`~repro_torch.nn.layers.ParamTree` per
layer, and run as a Python loop (the reference scans over stacked
parameters, a hybrid model (jamba) over groups of one attention layer
and ``attn_every - 1`` Mamba layers; eager PyTorch needs neither the
scan nor remat, and layer ``i`` is slot ``i % len(group)`` of its
group). Parameter names are the reference's pytree paths, with the
stacked ``blocks`` unrolled to one entry per layer
(:func:`repro_torch.weights.lm_params_from_jax` maps one onto the
other). ``arch/hints.py:shard_hint`` is a no-op on one device and is not
ported; ``loss`` waits for LM training (ROADMAP A.12). The backbone sums
the MoE layers' load-balance aux losses as the reference's does, ready
for that loss.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch.arch.blocks import (block_apply, block_cache_init,
                                     block_init, norm_apply)
from repro_torch.config import ArchConfig
from repro_torch.nn.attention import left_pad_starts
from repro_torch.nn.layers import (ParamTree, _fan_in_init, embedding_init,
                                   rmsnorm_init)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """Static per-layer kind list."""
    if cfg.rwkv is not None:
        return ["rwkv"] * cfg.num_layers
    if cfg.mamba is not None and cfg.attn_every:
        return ["attn" if i % cfg.attn_every == 0 else "mamba"
                for i in range(cfg.num_layers)]
    if cfg.mamba is not None:
        return ["mamba"] * cfg.num_layers
    return ["attn"] * cfg.num_layers


class TransformerLM(nn.Module):
    """Embedding, ``num_layers`` blocks, final norm and LM head, with
    random weights drawn from ``gen`` (a ``torch.Generator``; its device
    is where the weights are made) in the config's dtype. ``gen=None``
    draws from ``torch.Generator().manual_seed(0)`` on the CPU."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                 rolling_window_decode: bool = False,
                 moe_impl: str = "dense"):
        super().__init__()
        if moe_impl not in ("dense", "ep"):
            raise ValueError(f"moe_impl must be 'dense' or 'ep', got "
                             f"{moe_impl!r}")
        self.cfg = cfg
        self.moe_impl = moe_impl
        self.kinds = layer_kinds(cfg)
        self.rolling = bool(rolling_window_decode and cfg.sliding_window
                            and cfg.mamba is None)
        params = self.init(gen if gen is not None
                           else torch.Generator().manual_seed(0))
        self.embed = ParamTree(params["embed"])
        self.blocks = nn.ModuleList(ParamTree(b) for b in params["blocks"])
        self.final_norm = ParamTree(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"])

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> dict:
        """The weights as the reference's pytree, with ``blocks`` a list
        of one dict per layer."""
        cfg = self.cfg
        dt = _dtype(cfg)
        if cfg.embed_inputs or cfg.encoder_layers:
            raise NotImplementedError("embedding inputs and encoders are "
                                      "not ported yet (ROADMAP A.12)")
        params = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                          dt)}
        group_kinds, _ = self._group_structure()
        g = len(group_kinds)
        if cfg.moe is not None and cfg.moe_every > 1 and g % cfg.moe_every:
            # the reference's rule (repro/arch/model.py:94-106): the
            # group's slots share the MoE pattern, so its size is a
            # multiple of moe_every
            raise ValueError(
                "group size must divide moe_every for uniform layer "
                f"scan (got {g} % {cfg.moe_every})")
        params["blocks"] = [
            block_init(gen, cfg, kind, dt,
                       use_moe=(cfg.moe_every <= 1 or (i % g) % cfg.moe_every
                                == cfg.moe_every - 1))
            for i, kind in enumerate(self.kinds)]
        params["final_norm"] = rmsnorm_init(cfg.d_model, dt, gen.device)
        if not cfg.tie_embeddings:
            params["lm_head"] = _fan_in_init(
                gen, (cfg.d_model, cfg.vocab_size), dtype=dt)
        return params

    def _group_structure(self):
        """(group_kinds, n_groups): the layers are ``group_kinds *
        n_groups``, as the reference's ``_group_structure``."""
        cfg = self.cfg
        if cfg.attn_every and cfg.mamba is not None:
            g = cfg.attn_every
            if cfg.num_layers % g != 0:
                raise ValueError(f"num_layers {cfg.num_layers} must be a "
                                 f"multiple of attn_every {g}")
            return self.kinds[:g], cfg.num_layers // g
        return self.kinds[:1], cfg.num_layers

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # ------------------------------------------------------------- backbone

    def _backbone(self, x, *, positions, caches=None, cache_index=None,
                  valid=None, kv_start=None):
        """All layers; returns (x, new caches, the summed aux loss)."""
        new_caches = [] if caches is not None else None
        aux = x.new_zeros((), dtype=torch.float32)
        for i, (kind, p) in enumerate(zip(self.kinds, self.blocks)):
            c = None if caches is None else caches[i]
            x, nc, a = block_apply(
                p, x, self.cfg, kind, positions=positions, causal=True,
                cache=c, cache_index=cache_index, moe_impl=self.moe_impl,
                sliding_window=self.cfg.sliding_window, valid=valid,
                kv_start=kv_start)
            aux = aux + a
            if new_caches is not None:
                new_caches.append(nc)
        return x, new_caches, aux

    def _embed(self, batch) -> torch.Tensor:
        return self.embed["table"][batch["tokens"]]

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        table = (self.embed["table"].T if self.cfg.tie_embeddings
                 else self.lm_head)
        return h @ table.to(h.dtype)

    # ------------------------------------------------------------- serving

    def init_cache(self, batch_size: int, cache_len: int) -> list:
        """One cache dict per layer, on the model's device; a rolling
        cache holds ``min(cache_len, sliding_window)`` slots."""
        dt = _dtype(self.cfg)
        eff_len = (min(cache_len, self.cfg.sliding_window) if self.rolling
                   else cache_len)
        return [block_cache_init(self.cfg, kind, batch_size, eff_len, dt,
                                 rolling=self.rolling, device=self.device)
                for kind in self.kinds]

    @torch.inference_mode()
    def prefill(self, batch: dict, cache_len: int):
        """Full-sequence forward filling the cache; returns (last_logits
        (B, 1, V), caches, next_index). Optional batch keys for
        left-padded serving: ``positions`` (B, S) per-row RoPE positions
        and ``valid`` (B, S), a left-pad mask."""
        x = self._embed(batch)
        B, S, _ = x.shape
        caches = self.init_cache(B, cache_len)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device)[None]
        valid = batch.get("valid")
        # the left pad's first real key per row, checked once for every
        # GQA layer of the prefill (MLA masks the pads by ``valid``)
        gqa = "attn" in self.kinds and self.cfg.mla is None
        kv_start = (left_pad_starts(valid)
                    if valid is not None and gqa else None)
        h, caches, _ = self._backbone(x, positions=positions,
                                      caches=caches, cache_index=0,
                                      valid=valid, kv_start=kv_start)
        h = norm_apply(self.cfg, self.final_norm, h)
        return self._logits(h[:, -1:]), caches, S

    @torch.inference_mode()
    def decode_step(self, batch: dict, caches: list, index):
        """One-token step: batch {"tokens": (B, 1)}, optionally the
        prompt's ``valid`` (B, P) and per-row ``positions`` (B, 1).
        ``index`` is the cache slot the token takes: an int, or a 0-d
        int64 tensor on the device, which takes no host scalar (a CUDA
        graph can capture the step) and gives the same bits. Returns
        (logits (B, 1, V), caches, index + 1)."""
        x = self._embed(batch)
        positions = batch.get("positions")
        on_device = torch.is_tensor(index)
        if positions is None:
            positions = (index.reshape(1, 1).to(torch.int32) if on_device
                         else torch.full((1, 1), int(index),
                                         dtype=torch.int32, device=x.device))
        h, caches, _ = self._backbone(
            x, positions=positions, caches=caches,
            cache_index=index if on_device else int(index),
            valid=batch.get("valid"))
        h = norm_apply(self.cfg, self.final_norm, h)
        return self._logits(h), caches, (index + 1 if on_device
                                         else int(index) + 1)


def build_model(cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                moe_impl: str = "dense",
                rolling_window_decode: bool = False) -> TransformerLM:
    return TransformerLM(cfg, gen, rolling_window_decode, moe_impl)
