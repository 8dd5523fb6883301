"""The LM zoo's model: training loss, prefill and decode (the counterpart
of ``repro/arch/model.py``).

:class:`TransformerLM` is an ``nn.Module`` whose blocks sit in an
``nn.ModuleList``, one :class:`~repro_torch.nn.layers.ParamTree` per
layer, and run as a Python loop (the reference scans over stacked
parameters, a hybrid model (jamba) over groups of one attention layer
and ``attn_every - 1`` Mamba layers; layer ``i`` is slot ``i %
len(group)`` of its group). Whisper adds a bidirectional ``encoder``
stack and its ``enc_norm``, whose output the decoder's cross-attention
reads; Qwen2-VL takes precomputed ``embeds`` and three M-RoPE position
streams. Parameter names are the reference's pytree paths, with the
stacked ``blocks`` and ``encoder`` unrolled to one entry per layer
(:func:`repro_torch.weights.lm_params_from_jax` maps one onto the
other). The activation hints (:mod:`repro_torch.arch.hints`) sit where
the reference's do; they return their input as it is and, armed by the
dry-run, record how the planned mesh shards it.

:meth:`TransformerLM.loss` is the reference's training path under
autograd (``_sdpa``, MLA decompressed, Mamba's plain SSD, RWKV-6's plain
``wkv_chunked``). With ``remat`` the backward recomputes what the
forward did not keep (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint``: ``remat_granularity`` "group" checkpoints each layer
group, "block" each block; ``remat_policy`` "full" keeps nothing inside
a checkpoint, "dots" keeps the outputs of the 2-D products (``aten.mm``
and ``aten.addmm``, what ``x @ w`` dispatches; the counterpart of
``dots_with_no_batch_dims_saveable``) and "none" checkpoints nothing.
Prefill and decode run the kernels on the card.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.arch.blocks import (_norm_init, block_apply,
                                     block_cache_init, block_init,
                                     norm_apply)
from repro_torch.arch.hints import shard_hint
from repro_torch.arch.moe import expert_range
from repro_torch.config import ArchConfig
from repro_torch.nn.attention import left_pad_starts
from repro_torch.nn.layers import (ParamTree, _fan_in_init, embedding_apply,
                                  embedding_init, unembed_apply)

LOSS_CHUNK = 512
REMAT_POLICIES = ("full", "dots", "none")
REMAT_GRANULARITIES = ("group", "block")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


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
    """Embedding, ``num_layers`` blocks (and Whisper's encoder), final norm
    and LM head, with random weights drawn from ``gen`` (a
    ``torch.Generator``; its device is where the weights are made) in the
    config's dtype. ``gen=None`` draws from
    ``torch.Generator().manual_seed(0)`` on the CPU. ``remat``: the
    loss's backward recomputes each layer group (``remat_policy`` and
    ``remat_granularity``: see the module's docstring). ``moe_impl="ep"`` with
    a ``mesh`` (:class:`~repro_torch.launch.mesh.ExpertMesh`) runs the
    MoE layers' expert-parallel dispatch over it in ``loss``,
    ``prefill`` and ``decode_step``, as the reference's
    ``build_model(cfg, moe_impl, mesh)``; without a mesh they run dense
    dispatch. The mesh's communicator may hold every model rank in this
    process (``LocalComm``), or fewer, one a process under the launcher
    (:mod:`repro_torch.launch.ranks`): each process then holds only its
    ranks' experts (drawn whole from ``gen`` and cut, bitwise a whole
    model's), runs the dense part on the whole batch, and hands each MoE
    layer its block of the sequence
    (:func:`~repro_torch.arch.moe.moe_ffn_ep_replicated`)."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                 rolling_window_decode: bool = False,
                 moe_impl: str = "dense", remat: bool = True, mesh=None,
                 remat_policy: str = "full",
                 remat_granularity: str = "group"):
        super().__init__()
        if moe_impl not in ("dense", "ep"):
            raise ValueError(f"moe_impl must be 'dense' or 'ep', got "
                             f"{moe_impl!r}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of "
                             f"{REMAT_POLICIES}, got {remat_policy!r}")
        if remat_granularity not in REMAT_GRANULARITIES:
            raise ValueError(f"remat_granularity must be one of "
                             f"{REMAT_GRANULARITIES}, got "
                             f"{remat_granularity!r}")
        self.remat_policy = remat_policy
        self.remat_granularity = remat_granularity
        self.cfg = cfg
        self.moe_impl = moe_impl
        self.mesh = mesh
        self.remat = remat
        self.kinds = layer_kinds(cfg)
        self.rolling = bool(rolling_window_decode and cfg.sliding_window
                            and cfg.mamba is None)
        params = self.init(gen if gen is not None
                           else torch.Generator().manual_seed(0))
        self.embed = ParamTree(params["embed"])
        self.blocks = nn.ModuleList(ParamTree(b) for b in params["blocks"])
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(ParamTree(b)
                                         for b in params["encoder"])
            self.enc_norm = ParamTree(params["enc_norm"])
        self.final_norm = ParamTree(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"])

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> dict:
        """The weights as the reference's pytree, with ``blocks`` (and
        ``encoder``) a list of one dict per layer. An ``embed_inputs``
        model keeps the ``embed`` table for its LM head, as the
        reference's."""
        cfg = self.cfg
        dt = _dtype(cfg)
        params = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                          dt)}
        group_kinds, _ = self._group_structure()
        g = len(group_kinds)
        experts = None          # every expert, unless other processes
        mesh = self.mesh        # hold some of them
        if (cfg.moe is not None and self.moe_impl == "ep"
                and mesh is not None and mesh.comm.count != mesh.model):
            experts = expert_range(cfg.moe.num_experts, mesh.model,
                                   mesh.comm.start, mesh.comm.count)
        if cfg.moe is not None and cfg.moe_every > 1 and g % cfg.moe_every:
            # the reference's rule (repro/arch/model.py:94-106): the
            # group's slots share the MoE pattern, so its size is a
            # multiple of moe_every
            raise ValueError(
                "group size must divide moe_every for uniform layer "
                f"scan (got {g} % {cfg.moe_every})")
        params["blocks"] = [
            block_init(gen, cfg, kind, dt,
                       cross_attention=cfg.cross_attention,
                       use_moe=(cfg.moe_every <= 1 or (i % g) % cfg.moe_every
                                == cfg.moe_every - 1), experts=experts)
            for i, kind in enumerate(self.kinds)]
        if cfg.encoder_layers:
            params["encoder"] = [block_init(gen, cfg, "attn", dt)
                                 for _ in range(cfg.encoder_layers)]
            params["enc_norm"] = _norm_init(cfg, dt, gen.device)
        params["final_norm"] = _norm_init(cfg, dt, gen.device)
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

    def _encoder(self, frames: torch.Tensor, train: bool = False):
        """Whisper's encoder: bidirectional self-attention over the frames
        at positions ``arange(T)``, then ``enc_norm``. Served (``train``
        off), each layer attends through the kernel with
        ``causal=False``."""
        cfg = self.cfg
        x = frames
        pos = torch.arange(x.shape[1], dtype=torch.int32,
                           device=x.device)[None]
        for p in self.encoder:
            x, _, _ = block_apply(p, x, cfg, "attn", positions=pos,
                                  causal=False, moe_impl=self.moe_impl,
                                  mesh=self.mesh, train=train)
        return norm_apply(cfg, self.enc_norm, x)

    @torch.inference_mode()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder memory (B, T, D) of frame embeddings (B, T, D), in
        the model's dtype: what a server computes once per batch and
        hands to prefill and every decode step as ``enc_memory``."""
        return self._encoder(frames.to(_dtype(self.cfg)))

    def _enc_memory(self, batch: dict):
        """The batch's encoder memory: ``enc_memory`` as given, or the
        encoder run over ``enc_frames``; None without an encoder."""
        if not self.cfg.encoder_layers:
            return None
        dt = _dtype(self.cfg)
        if "enc_memory" in batch:
            return batch["enc_memory"].to(dt)
        return self._encoder(batch["enc_frames"].to(dt))

    def _backbone(self, x, *, positions, mrope_positions=None, caches=None,
                  cache_index=None, enc_memory=None, valid=None,
                  kv_start=None, train: bool = False):
        """All layers; returns (x, new caches, the summed aux loss).
        Training with ``remat`` checkpoints each layer group, or each
        block, under ``remat_policy``."""
        cfg = self.cfg
        new_caches = [] if caches is not None else None
        aux = x.new_zeros((), dtype=torch.float32)

        def layers(x, lo, hi):
            aux = x.new_zeros((), dtype=torch.float32)
            for i in range(lo, hi):
                c = None if caches is None else caches[i]
                x, nc, a = block_apply(
                    self.blocks[i], x, cfg, self.kinds[i],
                    positions=positions, mrope_positions=mrope_positions,
                    causal=True, cache=c, cache_index=cache_index,
                    enc_memory=enc_memory, moe_impl=self.moe_impl,
                    mesh=self.mesh, sliding_window=cfg.sliding_window,
                    valid=valid, kv_start=kv_start, train=train)
                aux = aux + a
                if new_caches is not None:
                    new_caches.append(nc)
            return x, aux

        do_remat = train and self.remat and self.remat_policy != "none"
        g = (1 if self.remat_granularity == "block"
             else len(self._group_structure()[0]))
        context = (functools.partial(create_selective_checkpoint_contexts,
                                     _save_dots)
                   if self.remat_policy == "dots" else None)
        kw = {} if context is None else {"context_fn": context}
        for lo in range(0, len(self.kinds), g):
            if do_remat:
                x, a = checkpoint(layers, x, lo, lo + g, use_reentrant=False,
                                  **kw)
            else:
                x, a = layers(x, lo, lo + g)
            aux = aux + a
        return x, new_caches, aux

    def _embed(self, batch) -> torch.Tensor:
        if self.cfg.embed_inputs:
            x = batch["embeds"].to(_dtype(self.cfg))
        else:
            x = embedding_apply(self.embed, batch["tokens"])
        return shard_hint(x, "batch", "seq", None)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        logits = (unembed_apply(self.embed, h) if self.cfg.tie_embeddings
                  else h @ self.lm_head.to(h.dtype))
        return shard_hint(logits, "batch", None, "vocab")

    # ------------------------------------------------------------------ loss

    def loss(self, batch: dict, chunk: Optional[int] = None) -> torch.Tensor:
        """Next-token cross-entropy, as the reference's ``loss``: batch
        {"tokens" or "embeds", "labels" (B, S), and "mrope_positions" (3,
        B, S) or "enc_frames" (B, T, D) as the config asks}; the logits
        are made ``min(chunk, S)`` positions at a time (``chunk`` defaults
        to ``LOSS_CHUNK``; S must be a multiple), so no (B, S, V) tensor
        is made at once. Adds ``load_balance_coef`` times the summed MoE
        aux loss. Differentiable: call ``backward`` on it."""
        cfg = self.cfg
        x = self._embed(batch)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
        mrope = batch.get("mrope_positions") if cfg.mrope else None
        enc_memory = None
        if cfg.encoder_layers:
            enc_memory = self._encoder(batch["enc_frames"].to(_dtype(cfg)),
                                       train=True)
        h, _, aux = self._backbone(x, positions=positions,
                                   mrope_positions=mrope,
                                   enc_memory=enc_memory, train=True)
        h = norm_apply(cfg, self.final_norm, h)
        labels = batch["labels"].long()
        chunk = min(LOSS_CHUNK if chunk is None else int(chunk), S)
        if S % chunk != 0:
            raise ValueError(f"sequence length {S} must be a multiple of "
                             f"the loss chunk {chunk}")
        total = x.new_zeros((), dtype=torch.float32)
        for lo in range(0, S, chunk):
            logits = self._logits(h[:, lo:lo + chunk]).float()
            logz = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1,
                              labels[:, lo:lo + chunk, None])[..., 0]
            total = total + torch.sum(logz - ll)
        ce = total / (B * S)
        lb_coef = cfg.moe.load_balance_coef if cfg.moe is not None else 0.0
        return ce + lb_coef * aux

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
        (B, 1, V), caches, next_index). The batch holds ``tokens`` (B, S),
        or ``embeds`` (B, S, D) for Qwen2-VL with ``mrope_positions`` (3,
        B, S); Whisper's holds ``enc_frames`` (B, T, D), which the
        encoder runs over, or the ``enc_memory`` that :meth:`encode`
        made of them. Optional keys for left-padded serving:
        ``positions`` (B, S) per-row RoPE positions and ``valid`` (B, S),
        a left-pad mask."""
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
        h, caches, _ = self._backbone(
            x, positions=positions,
            mrope_positions=(batch.get("mrope_positions") if self.cfg.mrope
                             else None),
            caches=caches, cache_index=0, enc_memory=self._enc_memory(batch),
            valid=valid, kv_start=kv_start)
        h = norm_apply(self.cfg, self.final_norm, h)
        return self._logits(h[:, -1:]), caches, S

    @torch.inference_mode()
    def decode_step(self, batch: dict, caches: list, index):
        """One-token step: batch {"tokens": (B, 1)} (Qwen2-VL: "embeds"
        (B, 1, D) and "mrope_positions" (3, B, 1); Whisper: the carried
        "enc_memory" (B, T, D), or "enc_frames", which the encoder runs
        over again), optionally the prompt's ``valid`` (B, P) and
        per-row ``positions`` (B, 1).
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
            x, positions=positions,
            mrope_positions=(batch.get("mrope_positions") if self.cfg.mrope
                             else None),
            caches=caches, cache_index=index if on_device else int(index),
            enc_memory=self._enc_memory(batch), valid=batch.get("valid"))
        h = norm_apply(self.cfg, self.final_norm, h)
        return self._logits(h), caches, (index + 1 if on_device
                                         else int(index) + 1)


def build_model(cfg: ArchConfig, gen: Optional[torch.Generator] = None,
                moe_impl: str = "dense",
                rolling_window_decode: bool = False,
                remat: bool = True, mesh=None, remat_policy: str = "full",
                remat_granularity: str = "group") -> TransformerLM:
    return TransformerLM(cfg, gen, rolling_window_decode, moe_impl, remat,
                         mesh, remat_policy, remat_granularity)
