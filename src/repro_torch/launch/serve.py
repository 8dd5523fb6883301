"""Batched LM serving loop: request queue -> prefill -> decode rounds (the
counterpart of ``repro/launch/serve.py``).

Requests arrive with prompts of varying length, are left-padded into
prefill batches, and decode proceeds in lockstep rounds over a fixed
cache. On the card, prefill runs the ``flash_attention`` kernel
(Qwen3) or the ``wkv6`` kernel (RWKV-6); decode is plain PyTorch, as in
the reference.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --requests 8 --new-tokens 16 --device cpu

``--full-width`` serves the config as published (bf16, every layer, on
the card it needs one H100); without it, the reference's reduced
config in float32.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import List, Mapping, Optional

import numpy as np
import torch

from repro_torch.arch import build_model
from repro_torch.config import get_arch_config
from repro_torch.device import resolve_device


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
    :func:`repro_torch.weights.lm_params_from_jax`).
    """

    def __init__(self, arch: str, batch_size: int, cache_len: int,
                 reduced: bool = True, seed: int = 0, rolling: bool = True,
                 greedy: bool = True, device=None,
                 state_dict: Optional[Mapping] = None):
        cfg = get_arch_config(arch)
        if reduced:
            cfg = cfg.reduced().replace(dtype="float32")
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
        t0 = time.perf_counter()
        while not all(r.done for r in reqs):
            step_pos = (idx - pads)[:, None].to(torch.int32)
            logits, caches, idx = self.model.decode_step(
                {"tokens": cur[:, None], "valid": valid,
                 "positions": step_pos}, caches, idx)
            cur = torch.argmax(logits[:, -1], -1)
            got = cur.tolist()
            self.stats.decode_tokens += sum(not r.done for r in reqs)
            for i, r in enumerate(reqs):
                if not r.done:
                    r.out.append(int(got[i]))
        self.stats.decode_s += time.perf_counter() - t0
        return self.stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b",
                    help="qwen3-4b or rwkv6-1.6b (the rest of the zoo "
                    "waits for ROADMAP A.12)")
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
    # RWKV's prefill takes a padded length that its chunk divides (as
    # the reference's): prompts at or past one chunk are cut to a
    # multiple of it, so every batch's longest prompt fits
    chunk = cfg.rwkv.chunk if cfg.rwkv is not None else 0
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
