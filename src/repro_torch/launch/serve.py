"""Batched LM serving loop: request queue -> prefill -> decode rounds (the
counterpart of ``repro/launch/serve.py``).

Requests arrive with prompts of varying length, are left-padded into
prefill batches, and decode proceeds in lockstep rounds over a fixed
cache (rolling O(window) for the sliding-window arch, Mixtral). On the
card, prefill runs the ``flash_attention`` kernel (the GQA archs: Qwen3,
Mixtral in its window, Phi-3, DBRX, and Jamba's attention layers) or the
``wkv6`` kernel (RWKV-6); Jamba's Mamba layers and MiniCPM3's latent
attention are plain PyTorch products, as the reference's are einsums.
Decode is plain PyTorch, as in the reference, and its round is
one CUDA graph per bucket (batch size and cache length): the reference
compiles ``decode_step`` once (``repro/launch/serve.py:76-78``), the
port captures it once (:class:`DecodeGraph`) and replays it every round.
``cuda_graphs=False`` decodes eagerly on the card, as the CPU always
does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --requests 8 --new-tokens 16 --device cpu

``--full-width`` serves the config as published (bf16, every layer);
without it, the reference's reduced config in float32. One H100 (80 GB)
holds Qwen3-4B, RWKV-6 1.6B, MiniCPM3-4B (8.2 GB), Phi-3-medium (29 GB)
and Qwen3-32B (65.5 GB) at full width and depth; Mixtral 8x7B (93.4 GB),
DBRX (263 GB) and Jamba-1.5-Large (796 GB) do not, and ``chip_smoke.py``
serves Mixtral at 16 of its 32 layers and Jamba as one group of 8 layers
with 8 of its 16 experts, each by handing ``BatchServer`` the config cut
with ``ArchConfig.replace``. Whisper-base and Qwen2-VL-2B take frames
and embeddings, which the server's token requests do not carry (nor do
the reference's): they serve through the model's ``prefill``,
``encode`` and :class:`DecodeGraph`, whose round takes their extra
inputs (``chip_smoke.py`` phase 19).
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.arch import build_model
from repro_torch.config import ArchConfig, get_arch_config
from repro_torch.core.trainer import _assert_once_per_bucket, capture, warm_up
from repro_torch.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int
    out: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


@dataclass
class ServerStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0


def _carry(static, new) -> None:
    """Copy the leaves of a decode step's returned cache ``new`` into the
    fixed buffers ``static`` where they are other tensors (RWKV's
    ``last`` and ``state``; attention writes its cache in place, a
    rolling cache's ``pos`` included)."""
    if torch.is_tensor(static):
        if new is not static:
            static.copy_(new)
        return
    items = static.items() if isinstance(static, dict) else enumerate(static)
    for k, v in items:
        _carry(v, new[k])


class DecodeGraph:
    """One bucket's decode round over fixed buffers: the round's tokens
    (B, 1), positions (B, 1), validity mask over every cache slot (B,
    cache_len), the cache slot as a 0-d tensor, and the caches (a rolling
    cache's ``pos`` among them), which the round reads and writes in
    place. A Whisper round also reads the batch's encoder memory ``enc_memory``
    (B, encoder_seq, D), set once per batch by :meth:`start`; a Qwen2-VL
    round its token's ``embeds`` (B, 1, D) and ``mrope_positions`` (3,
    B, 1), given each round. A round returns ``(logits (B, 1, V), argmax
    tokens (B,))``.

    On the card the first round runs eagerly on a side stream, then is
    captured into a CUDA graph over the buffers (``core/trainer.py``'s
    ``warm_up`` and ``capture``); every later round, whatever the batch,
    loads its inputs and replays. Its outputs are the graph's and stay
    valid until the next round. On the CPU the rounds run eagerly through
    the same buffers."""

    def __init__(self, model, batch_size: int, cache_len: int):
        self.model = model
        dev = model.device
        self.graphs_on = dev.type == "cuda"
        with torch.inference_mode():
            self.static = {
                "tokens": torch.zeros((batch_size, 1), dtype=torch.int64,
                                      device=dev),
                "positions": torch.zeros((batch_size, 1),
                                         dtype=torch.int32, device=dev),
                "valid": torch.ones((batch_size, cache_len),
                                    dtype=torch.bool, device=dev),
                "index": torch.zeros((), dtype=torch.int64, device=dev),
                "caches": model.init_cache(batch_size, cache_len)}
            cfg, dt = model.cfg, model.embed["table"].dtype
            if cfg.encoder_layers:
                self.static["enc_memory"] = torch.zeros(
                    (batch_size, cfg.encoder_seq, cfg.d_model), dtype=dt,
                    device=dev)
            if cfg.embed_inputs:
                self.static["embeds"] = torch.zeros(
                    (batch_size, 1, cfg.d_model), dtype=dt, device=dev)
            if cfg.mrope:
                self.static["mrope_positions"] = torch.zeros(
                    (3, batch_size, 1), dtype=torch.int32, device=dev)
        self.captures = 0
        self._step = None
        self._side = None

    def _round(self, s):
        batch = {k: s[k] for k in ("tokens", "valid", "positions",
                                   "enc_memory", "embeds",
                                   "mrope_positions") if k in s}
        logits, new, _ = self.model.decode_step(batch, s["caches"],
                                                s["index"])
        _carry(s["caches"], new)
        return logits, torch.argmax(logits[:, -1], -1)

    @torch.inference_mode()
    def start(self, caches, valid: torch.Tensor,
              enc_memory: Optional[torch.Tensor] = None) -> None:
        """A new batch: its prefill's caches, its prompt's left-pad mask
        (B, P) into the buffers (slots past the prompt valid), and a
        Whisper batch's encoder memory."""
        _carry(self.static["caches"], caches)
        v = self.static["valid"]
        v.fill_(True)
        v[:, :valid.shape[1]] = valid
        if "enc_memory" in self.static:
            self.static["enc_memory"].copy_(enc_memory)

    @torch.inference_mode()
    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor,
                 index: int, embeds: Optional[torch.Tensor] = None,
                 mrope_positions: Optional[torch.Tensor] = None):
        s = self.static
        s["tokens"].copy_(tokens)
        s["positions"].copy_(positions)
        s["index"].fill_(index)
        if "embeds" in s:
            s["embeds"].copy_(embeds)
        if "mrope_positions" in s:
            s["mrope_positions"].copy_(mrope_positions)
        if not self.graphs_on:
            return self._round(s)
        if self._step is not None:
            return self._step.replay(None)
        self._side = torch.cuda.Stream(s["tokens"].device)
        out = warm_up(self._round, s, self._side)
        self._step = capture(self._round, s, self._side,
                             load=lambda static, _: None)
        self.captures += 1
        return out


class BatchServer:
    """Fixed-batch lockstep server (padding inactive slots).

    Variable-length prompts are left-padded (right-aligned so the last
    token sits at a shared index) and a per-request validity mask rides
    along through prefill *and* decode: the pad K/Vs persist in the
    cache, so every step masks them out of attention, and per-row RoPE
    positions are pad-shifted so each prompt starts at position 0 —
    batched generations match running each request solo.

    The weights are random, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless ``device="cpu"``), unless a
    ``state_dict`` is given (e.g. the JAX server's params through
    :func:`repro_torch.weights.lm_params_from_jax`). On the card a decode
    round is one CUDA graph per bucket, ``(batch_size, cache_len)``
    (:class:`DecodeGraph`), unless ``cuda_graphs=False``;
    :meth:`assert_compiled_per_bucket` certifies one capture per touched
    bucket, the reference's rule. ``rolling`` keeps a sliding-window
    arch's cache at O(window) slots, as the reference's server does.
    ``arch`` is a name (``reduced`` then picks the reference's reduced
    config in float32) or an ``ArchConfig``, served as it is: a model too
    large for the card is served cut with ``cfg.replace(...)``.

    Requests carry token prompts only, as the reference's: a config that
    takes embeddings (Qwen2-VL) or encoder frames (Whisper) is refused.
    Those models serve through ``prefill``, :meth:`TransformerLM.encode`
    and :class:`DecodeGraph` directly.
    """

    def __init__(self, arch: Union[str, ArchConfig], batch_size: int,
                 cache_len: int,
                 reduced: bool = True, seed: int = 0, rolling: bool = True,
                 greedy: bool = True, device=None,
                 state_dict: Optional[Mapping] = None,
                 cuda_graphs: bool = True):
        if isinstance(arch, ArchConfig):
            cfg = arch
        else:
            cfg = get_arch_config(arch)
            if reduced:
                cfg = cfg.reduced().replace(dtype="float32")
        if cfg.embed_inputs or cfg.encoder_layers:
            raise ValueError(
                f"{cfg.name}: BatchServer serves token prompts, as the "
                "reference's; a config with embedding inputs or an "
                "encoder takes them through prefill and DecodeGraph")
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = build_model(cfg, gen, rolling_window_decode=rolling)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.requires_grad_(False)
        self.batch_size = batch_size
        self.cache_len = cache_len
        self.greedy = greedy
        self.stats = ServerStats()
        self.graphs_on = bool(cuda_graphs) and self.device.type == "cuda"
        self.bucket = (batch_size, cache_len)   # the decode graph's shapes
        self.batches = 0
        # a list here keeps every decode round's logits (float32, on the
        # CPU: a sync a round), for comparisons
        self.round_logits: Optional[list] = None
        self._graph: Optional[DecodeGraph] = None

    def _pad_prompts(self, reqs: List[Request]):
        """Left-pad to a common length plus the pad-correction tensors:
        a (B, max_p) validity mask (unused batch slots stay all-True —
        an all-masked row would softmax over nothing) and per-row
        positions shifted so every real prompt starts at 0."""
        max_p = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.batch_size, max_p), np.int64)
        valid = np.ones((self.batch_size, max_p), bool)
        pads = np.zeros(self.batch_size, np.int64)
        for i, r in enumerate(reqs):
            pads[i] = max_p - len(r.prompt)
            toks[i, pads[i]:] = r.prompt
            valid[i, :pads[i]] = False
        positions = np.maximum(np.arange(max_p)[None] - pads[:, None], 0)
        dev = self.device
        return (torch.from_numpy(toks).to(dev),
                torch.from_numpy(valid).to(dev),
                torch.from_numpy(positions.astype(np.int32)).to(dev),
                torch.from_numpy(pads).to(dev), max_p)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, requests: List[Request]) -> ServerStats:
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests exceed the "
                             f"server batch size {self.batch_size}")
        if not self.greedy:
            raise NotImplementedError("sampling is not ported; the "
                                      "reference serves greedily too")
        reqs = list(requests)
        toks, valid, positions, pads, plen = self._pad_prompts(reqs)
        self._sync()
        t0 = time.perf_counter()
        logits, caches, idx = self.model.prefill(
            {"tokens": toks, "valid": valid, "positions": positions},
            cache_len=self.cache_len)
        cur = torch.argmax(logits[:, -1], -1)
        first = cur.tolist()
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefill_tokens += plen * len(reqs)

        for i, r in enumerate(reqs):
            r.out.append(int(first[i]))
        self.batches += 1
        t0 = time.perf_counter()
        if self.graphs_on:
            if self._graph is None:
                self._graph = DecodeGraph(self.model, *self.bucket)
            graph = self._graph
            graph.start(caches, valid)
            del caches
        while not all(r.done for r in reqs):
            step_pos = (idx - pads)[:, None].to(torch.int32)
            if self.graphs_on:
                logits, cur = graph(cur[:, None], step_pos, idx)
                idx += 1
            else:
                logits, caches, idx = self.model.decode_step(
                    {"tokens": cur[:, None], "valid": valid,
                     "positions": step_pos}, caches, idx)
                cur = torch.argmax(logits[:, -1], -1)
            if self.round_logits is not None:
                self.round_logits.append(logits.float().cpu())
            got = cur.tolist()
            self.stats.decode_tokens += sum(not r.done for r in reqs)
            for i, r in enumerate(reqs):
                if not r.done:
                    r.out.append(int(got[i]))
        self.stats.decode_s += time.perf_counter() - t0
        return self.stats

    @property
    def captures(self) -> dict:
        """Decode graphs captured, by bucket."""
        return {} if self._graph is None else {
            self.bucket: self._graph.captures}

    def assert_compiled_per_bucket(self) -> None:
        """Exactly one decode capture for the server's bucket once it has
        decoded under CUDA graphs (``RetraceError`` otherwise); eager,
        that decode ran."""
        touched = int(self.batches > 0)
        if self.graphs_on:
            _assert_once_per_bucket(sum(self.captures.values()), touched,
                                    "decode step")
        elif touched == 0:
            _assert_once_per_bucket(0, 0, "decode step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b",
                    help="mixtral-8x7b, qwen3-4b, qwen3-32b, "
                    "phi3-medium-14b, dbrx-132b, rwkv6-1.6b, "
                    "jamba-1.5-large-398b or minicpm3-4b (whisper-base and "
                    "qwen2-vl-2b take frames and embeddings, which the "
                    "server's token requests do not carry, as the "
                    "reference's)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the config as published (bf16, every "
                    "layer) instead of its reduced float32 variant")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    server = BatchServer(args.arch, args.batch,
                         cache_len=args.prompt_len + args.new_tokens + 8,
                         reduced=not args.full_width, seed=args.seed,
                         device=args.device)
    cfg = server.cfg
    # RWKV's and Mamba's prefill take a padded length of at most one
    # chunk or a multiple of it (as the reference's): prompts at or past
    # one chunk are cut to a multiple of it, so every batch's longest
    # prompt fits
    chunk = next((c.chunk for c in (cfg.rwkv, cfg.mamba) if c is not None),
                 0)
    reqs = []
    for i in range(args.requests):
        n = int(rng.integers(4, args.prompt_len + 1))
        if chunk and n >= chunk:
            n = n // chunk * chunk
        reqs.append(Request(i, rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32), args.new_tokens))
    done = []
    for i in range(0, len(reqs), args.batch):
        batch = reqs[i:i + args.batch]
        server.run(batch)
        done.extend(batch)
        log.info("served batch %d: %d requests", i // args.batch,
                 len(batch))
    s = server.stats
    print(f"[{server.device}] {cfg.name} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.dtype}): served {len(done)} requests "
          f"(prefill {s.prefill_tokens} tok @ "
          f"{s.prefill_tokens / max(s.prefill_s, 1e-9):.0f} tok/s, "
          f"decode {s.decode_tokens} tok @ "
          f"{s.decode_tokens / max(s.decode_s, 1e-9):.0f} tok/s)")
    for r in done[:2]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
