"""Batched LM serving on the PyTorch port: prefill a batch of prompts,
then decode with the rolling O(window) sliding-window cache, on the card
unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--new-tokens 32]
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The JAX example's run (``examples/serve_lm.py``): reduced Mixtral 8x7B in
float32 (2 layers, d 256, 4 experts top-2) with its window cut to 16, so
the 32-token prompts are longer than the window and the cache's 16 slots
wrap in prefill and again in decode. Prefill runs the ``flash_attention``
kernel in its window band on the card (its plain version on the CPU);
decode is greedy, one step at a time. ``chip_smoke.py`` serves the full
width (``BatchServer``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.arch import build_model
from repro_torch.config import get_arch_config
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(arch: str = "mixtral-8x7b", batch: int = 4, prompt_len: int = 32,
         new_tokens: int = 32, device=None, params=None,
         seed: int = 0) -> dict:
    """Serve one batch and print the JAX example's lines. ``params`` (a
    ``state_dict``) replaces the seeded weights, e.g. the JAX example's
    through :func:`repro_torch.weights.lm_params_from_jax`. Returns the
    decoded tokens (B, new_tokens), the prefill's logits and the model's
    weights on the CPU."""
    dev = resolve_device(device)
    cfg = get_arch_config(arch).reduced().replace(dtype="float32",
                                                  sliding_window=16)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_model(cfg, gen, rolling_window_decode=True)
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.requires_grad_(False)
    rng = np.random.default_rng(0)
    B, P, N = batch, prompt_len, new_tokens
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))
                               ).to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches, idx = model.prefill({"tokens": prompts},
                                        cache_len=P + N)
    first = logits
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = [torch.argmax(logits[:, -1], -1)]
    t0 = time.perf_counter()
    for _ in range(N):
        tok = generated[-1][:, None]
        logits, caches, idx = model.decode_step({"tokens": tok}, caches,
                                                idx)
        generated.append(torch.argmax(logits[:, -1], -1))
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(generated[1:], dim=1).cpu().numpy()
    print(f"arch={arch} (reduced)  batch={B}  prompt={P}  new={N}  "
          f"[{dev}]")
    print(f"prefill: {t_prefill * 1e3:.1f} ms "
          f"({B * P / t_prefill:.0f} tok/s)")
    print(f"decode : {t_decode * 1e3:.1f} ms total, "
          f"{t_decode / N * 1e3:.2f} ms/step, "
          f"{B * N / t_decode:.0f} tok/s")
    print(f"sample continuation (seq 0): {toks[0][:16]}")
    print(f"rolling SWA cache: window={cfg.sliding_window} slots "
          f"(O(window), not O(seq)): {caches[0]['k'].shape[1]} held")
    return {"tokens": toks, "prefill_logits": first.float().cpu(),
            "params": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    args = ap.parse_args()
    main(args.arch, args.batch, args.prompt_len, args.new_tokens,
         args.device)
