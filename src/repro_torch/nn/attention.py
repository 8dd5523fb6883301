"""GQA attention with RoPE and qk-norm (the counterpart of
``repro/nn/attention.py``).

Functional, as the reference: ``attention_init`` returns a dict of
weights and ``attention_apply(p, x, ...)`` reads it. Softmax is in
float32 whatever the activations' type. Prefill into a full cache runs
the ``flash_attention`` kernel (:mod:`repro_torch.kernels.ops`); decode
and the no-cache path compute ``_sdpa`` over an additive bias, as the
reference does. The caches are updated in place (the reference returns
new ones), which keeps one copy of each on the card. The rolling
sliding-window cache keeps W slots (slot = position mod W): its prefill
runs the kernel within the prompt and its decode ``_sdpa`` over the W
slots. MLA (``mla_apply``, MiniCPM3) attends through float32 products,
as the reference's does: no kernel. Cross-attention (Whisper's decoder
over the encoder memory) takes ``_sdpa`` with no mask, no RoPE and no
cache, as the reference's; M-RoPE (Qwen2-VL) rotates three sections of
the rotary half-dim by three position streams. The bidirectional
encoder's self-attention has no cache either: served, it runs the kernel
with ``causal=False`` (``kernel=True``); trained, it takes ``_sdpa``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG as NEG_INF   # one masking sentinel
from repro_torch.nn.layers import _fan_in_init, rmsnorm_apply, rmsnorm_init


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None
                     ) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,) float32 (computed in
    numpy as the reference computes them), made once per device: a
    host-to-device copy in every layer would stall the launch queue."""
    return _rope_frequencies(int(head_dim), float(theta),
                             str(torch.device("cpu" if device is None
                                              else device)))


@functools.lru_cache(maxsize=32)
def _rope_frequencies(head_dim: int, theta: float, device: str):
    exponents = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    inv = (1.0 / (theta ** exponents)).astype(np.float32)
    return torch.from_numpy(inv).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    ang = positions[..., None].float() * inv            # (..., S, hd/2)
    ang = ang[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 10000.0,
                sections=(0.25, 0.375, 0.375)) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL). positions3: (3, ..., S), the (t, h, w)
    streams. The rotary half-dim is cut into three contiguous sections of
    ``int(round(f * hd // 2))`` for the first two fractions (Python's
    ``round``, as the reference's) and the rest, each rotated by its own
    stream: 16/24/24 at head dim 128, 4/6/6 at 32."""
    hd = x.shape[-1]
    half = hd // 2
    s0 = int(round(sections[0] * half))
    s1 = int(round(sections[1] * half))
    sizes = [s0, s1, half - s0 - s1]
    inv = rope_frequencies(hd, theta, x.device)
    parts, off = [], 0
    for i, sz in enumerate(sizes):
        pos = positions3[i][..., None].float()             # (..., S, 1)
        parts.append(pos * inv[off:off + sz])
        off += sz
    ang = torch.cat(parts, dim=-1)[..., None, :]         # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def make_attention_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        causal: bool, sliding_window: int = 0,
                        k_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Additive bias (..., Sq, Sk) in float32: 0 allowed, NEG blocked."""
    qp = q_pos[..., :, None].to(torch.int32)
    kp = k_pos[..., None, :].to(torch.int32)
    allowed = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                         dtype=torch.bool, device=qp.device)
    if causal:
        allowed = allowed & (kp <= qp)
    if sliding_window:
        allowed = allowed & (kp > qp - sliding_window)
    if k_valid is not None:
        allowed = allowed & k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=qp.device)
    return torch.where(allowed, zero, torch.full_like(zero, NEG_INF))


def attention_init(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, dtype=torch.float32,
                   qk_norm: bool = False) -> dict:
    p = {
        "wq": _fan_in_init(gen, (d_model, num_heads * head_dim),
                           dtype=dtype),
        "wk": _fan_in_init(gen, (d_model, num_kv_heads * head_dim),
                           dtype=dtype),
        "wv": _fan_in_init(gen, (d_model, num_kv_heads * head_dim),
                           dtype=dtype),
        "wo": _fan_in_init(gen, (num_heads * head_dim, d_model),
                           dtype=dtype),
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(head_dim, dtype, gen.device)
    return p


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,hd)  k,v: (B,Sk,Hkv,hd)  bias: (B,1|Hkv,Sq,Sk) ->
    (B,Sq,Hkv,G,hd) float32."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())


def left_pad_starts(valid: torch.Tensor) -> torch.Tensor:
    """The first real key of each row of a left-pad mask ``valid`` (B, P):
    ``P - valid.sum(1)`` as int32. Raises ``ValueError`` when a row is
    not left-padded (False slots, then True slots): the kernel masks one
    leading run of keys per row and nothing else."""
    P = valid.shape[1]
    start = P - valid.sum(1).to(torch.int32)
    want = torch.arange(P, device=valid.device)[None, :] >= start[:, None]
    if not bool(torch.equal(valid.bool(), want)):
        raise ValueError("valid must be a left-pad mask: each row False "
                         "on its leading pad slots and True after them")
    return start.contiguous()


def _prompt_attention(q, k, v, sliding_window, valid, kv_start,
                      causal: bool = True):
    """Causal (and windowed) attention within a prompt of Sq tokens
    through the ``flash_attention`` kernel, or bidirectional attention
    over an encoder's frames with ``causal=False``: q (B, Sq, Hq, hd), k
    and v (B, Sq, Hkv, hd) -> (B, Sq, Hq, hd). ``valid`` (B, Sq), a
    left-pad mask, masks each row's pad keys through ``kv_start``, its
    first real key (computed here when None)."""
    Sq = k.shape[1]
    if valid is not None:
        if valid.shape[1] != Sq:
            raise ValueError(f"prefill valid mask covers {valid.shape[1]} "
                             f"slots, the prompt {Sq}")
        if kv_start is None:
            kv_start = left_pad_starts(valid)
    return ops.flash_attention_op(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  sliding_window=sliding_window,
                                  kv_start=kv_start)


def _rolling_store(k, v, cache, cache_index) -> None:
    """A prefill's keys and values into the rolling cache (reference
    ``repro/nn/attention.py:175-183``): the last ``min(W, Sq)`` of them,
    at positions ``cache_index + Sq - last ...``, go to slots ``pos %
    W``, and ``pos`` records their positions."""
    Sq = k.shape[1]
    W = cache["k"].shape[1]
    last = min(W, Sq)
    tail = (torch.arange(last, dtype=torch.int64, device=k.device)
            + (cache_index + Sq - last))
    slots = torch.remainder(tail, W)
    cache["k"].index_copy_(1, slots, k[:, Sq - last:].to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v[:, Sq - last:].to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slots, tail.to(torch.int32))


def _rolling_decode_bias(k, v, cache, cache_index, sliding_window, valid):
    """One decode token into the rolling cache (reference
    ``repro/nn/attention.py:184-211``): k and v (B, 1, Hkv, hd) and the
    position go to slot ``index % W``, computed on the device (under a
    CUDA graph the index is a 0-d tensor), and the bias (B, 1, 1, W) over
    the W slots is built from their positions ``pos``: empty slots
    (``pos < 0``) masked, and ``valid`` (B, P) mapped through ``pos``
    (slots holding a prompt position take its pad mask, later positions
    are real). A mask over all ``cache_len`` slots, True past the prompt
    (``DecodeGraph``'s), gives the same bias."""
    W = cache["k"].shape[1]
    dev = k.device
    idx = (cache_index.reshape(()).to(torch.int64)
           if torch.is_tensor(cache_index)
           else torch.tensor(int(cache_index), dtype=torch.int64,
                             device=dev))
    slot = torch.remainder(idx, W).reshape(1)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cpos = cache["pos"]
    cpos.index_copy_(0, slot, idx.reshape(1).to(torch.int32))
    q_pos = idx.reshape(1, 1).to(torch.int32)
    k_valid = (cpos >= 0)[None]
    if valid is not None:
        P = valid.shape[1]
        in_prompt = (cpos >= 0) & (cpos < P)
        mapped = torch.index_select(valid.bool(), 1,
                                    cpos.clamp(0, P - 1).to(torch.int64))
        k_valid = k_valid & torch.where(in_prompt[None], mapped, True)
    bias = make_attention_bias(q_pos, cpos[None], causal=True,
                               sliding_window=sliding_window,
                               k_valid=k_valid)
    return bias[:, None] if bias.dim() == 3 else bias


def attention_apply(p, x: torch.Tensor, *, num_heads: int, num_kv_heads: int,
                    head_dim: int, positions=None, rope_theta=10000.0,
                    qk_norm=False, norm_eps=1e-5, causal=True,
                    sliding_window=0, cache=None, cache_index=None,
                    kv_x=None, kv_positions=None, mrope_positions=None,
                    valid=None, kv_start=None, kernel: bool = False):
    """Unified GQA attention, as ``repro/nn/attention.py:attention_apply``.

    - train/prefill without a cache: self attention over x (``_sdpa``),
      or, with ``kernel=True``, through the ``flash_attention`` kernel
      (``causal`` as given): the served encoder's path.
    - cross attention: ``kv_x`` (B, Sk, D) given, the encoder memory: K
      and V projected from it, no RoPE on q or k, no mask and no cache,
      through ``_sdpa`` (Sq differs from Sk, which the kernel does not
      take). Decode recomputes the cross K/V every step, as the
      reference's does.
    - ``mrope_positions`` (3, B, S): M-RoPE on q and k in place of RoPE
      (:func:`apply_mrope`).
    - with a cache {"k","v"} (B, S_max, Hkv, hd): the new kv is written at
      ``cache_index`` and ``(out, cache)`` returned. ``cache_index`` is an
      int, or for decode a 0-d int64 tensor on the device: no host
      scalar, so the step can be captured into a CUDA graph, and the same
      bits as the int. A prefill
      (``cache_index == 0``, more than one token) attends over the prompt
      through the ``flash_attention`` kernel, with ``valid``'s left pad as
      the per-row ``kv_start``; decode attends over the whole cache with
      ``_sdpa``.
    - ``valid``: (B, P) bool, which of the first P cache slots hold real
      tokens. Prefill passes the prompt's pad mask; decode keeps passing
      it so the pad K/Vs stay masked out of every later step (or a mask
      over all S_max slots, True past the prompt: a shape fixed by the
      cache, which a captured decode reads).
    - ``kv_start``: (B,) int32, ``left_pad_starts(valid)``. A prefill
      through many layers computes it once and passes it to each; left
      ``None``, the prefill computes it here from ``valid``.
    - a rolling cache (``"pos"`` in it, W slots): a prefill (more than one
      token, any ``cache_index``) attends within its tokens through the
      kernel and keeps the last W; decode writes slot ``index % W`` and
      attends over the W slots (:func:`_rolling_store`,
      :func:`_rolling_decode_bias`).

    Query rows that are left pad see no key at all: the kernel gives them
    0 where the reference's ``_sdpa`` gives the uniform average of the
    values (ROADMAP C.8). Those rows feed only pad positions, which every
    later layer masks as keys and no logit reads.
    """
    B, Sq, _ = x.shape
    G = num_heads // num_kv_heads
    q = (x @ p["wq"]).reshape(B, Sq, num_kv_heads, G, head_dim)
    src = kv_x if kv_x is not None else x
    Sk = src.shape[1]
    k = (src @ p["wk"]).reshape(B, Sk, num_kv_heads, head_dim)
    v = (src @ p["wv"]).reshape(B, Sk, num_kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, norm_eps)
        k = rmsnorm_apply(p["k_norm"], k, norm_eps)
    if kv_x is not None:
        # cross attention: every query sees every encoder frame
        if cache is not None:
            raise ValueError("cross-attention takes no cache")
        bias = torch.zeros((B, 1, Sq, Sk), dtype=torch.float32,
                           device=x.device)
        out = _sdpa(q, k, v, bias)
        return out.reshape(B, Sq, num_heads * head_dim).to(x.dtype) @ p["wo"]
    if mrope_positions is not None:
        q = apply_mrope(q.reshape(B, Sq, num_heads, head_dim),
                        mrope_positions, rope_theta
                        ).reshape(B, Sq, num_kv_heads, G, head_dim)
        k = apply_mrope(k, mrope_positions, rope_theta)
    elif positions is not None:
        q = apply_rope(q.reshape(B, Sq, num_heads, head_dim), positions,
                       rope_theta).reshape(B, Sq, num_kv_heads, G, head_dim)
        kpos = kv_positions if kv_positions is not None else positions
        k = apply_rope(k, kpos, rope_theta)
    if cache is None and kernel:
        out = _prompt_attention(q.reshape(B, Sq, num_heads, head_dim), k, v,
                                sliding_window, valid, kv_start,
                                causal=causal)
        return out.reshape(B, Sq, num_heads * head_dim).to(x.dtype) @ p["wo"]

    rolling = cache is not None and "pos" in cache
    if cache is not None and Sq > 1 and (rolling or (
            not torch.is_tensor(cache_index) and int(cache_index) == 0)):
        # prefill: attend within the prompt (the reference's rolling
        # prefill attends within the new tokens at any cache_index; into
        # a full cache at index 0 every later slot is masked), then keep
        # its keys: a full cache at slots 0..Sq-1, a rolling one the last W
        if rolling:
            _rolling_store(k, v, cache, cache_index)
        else:
            cache["k"][:, :Sq] = k.to(cache["k"].dtype)
            cache["v"][:, :Sq] = v.to(cache["v"].dtype)
        out = _prompt_attention(q.reshape(B, Sq, num_heads, head_dim), k, v,
                                sliding_window, valid, kv_start)
        out = out.reshape(B, Sq, num_heads * head_dim).to(x.dtype)
        return out @ p["wo"], cache
    if rolling:
        bias = _rolling_decode_bias(k, v, cache, cache_index,
                                    sliding_window, valid)
        k, v = cache["k"], cache["v"]
    elif cache is not None:
        # decode at a device index takes no host scalar, so a CUDA graph
        # captures the step once and replays it at every index
        start = (cache_index.reshape(()).to(torch.int64)
                 if torch.is_tensor(cache_index) else int(cache_index))
        pos = start + torch.arange(Sq, dtype=torch.int64, device=x.device)
        cache["k"].index_copy_(1, pos, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, pos, v.to(cache["v"].dtype))
        q_pos = pos.to(torch.int32)[None]
        ck, cv = cache["k"], cache["v"]
        S_max = ck.shape[1]
        k_pos = torch.arange(S_max, dtype=torch.int32, device=x.device)[None]
        k_valid = k_pos <= q_pos[:, -1:]
        if valid is not None:
            # left-pad slots written at prefill stay in the cache; mask
            # them out of this and every later step's attention (a mask
            # of all S_max slots is taken as it is)
            P = valid.shape[1]
            vfull = torch.ones((B, S_max), dtype=torch.bool,
                               device=x.device)
            vfull[:, :P] = valid.bool()
            k_valid = k_valid & vfull
        bias = make_attention_bias(q_pos, k_pos, causal=True,
                                   sliding_window=sliding_window,
                                   k_valid=k_valid)
        bias = bias[:, None] if bias.dim() == 3 else bias
        k, v = ck, cv
    else:
        q_pos = positions if positions is not None else (
            torch.arange(Sq, dtype=torch.int32, device=x.device)[None])
        if q_pos.dim() == 1:
            q_pos = q_pos[None]
        bias = make_attention_bias(q_pos, q_pos, causal=causal,
                                   sliding_window=sliding_window)
        if bias.dim() == 3:
            bias = bias[:, None]
        bias = bias.expand((B, 1) + tuple(bias.shape[-2:]))

    out = _sdpa(q, k, v, bias)
    out = out.reshape(B, Sq, num_heads * head_dim).to(x.dtype)
    out = out @ p["wo"]
    if cache is not None:
        return out, cache
    return out


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, d_model: int, num_heads: int, mla,
             dtype=torch.float32) -> dict:
    """The latent attention's weights, named as the reference's."""
    qh = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    return {
        "wq_a": _fan_in_init(gen, (d_model, mla.q_lora_rank), dtype=dtype),
        "q_a_norm": rmsnorm_init(mla.q_lora_rank, dtype, gen.device),
        "wq_b": _fan_in_init(gen, (mla.q_lora_rank, num_heads * qh),
                             dtype=dtype),
        "wkv_a": _fan_in_init(
            gen, (d_model, mla.kv_lora_rank + mla.qk_rope_head_dim),
            dtype=dtype),
        "kv_a_norm": rmsnorm_init(mla.kv_lora_rank, dtype, gen.device),
        "wk_b": _fan_in_init(
            gen, (mla.kv_lora_rank, num_heads * mla.qk_nope_head_dim),
            dtype=dtype),
        "wv_b": _fan_in_init(
            gen, (mla.kv_lora_rank, num_heads * mla.v_head_dim),
            dtype=dtype),
        "wo": _fan_in_init(gen, (num_heads * mla.v_head_dim, d_model),
                           dtype=dtype),
    }


def _mla_qkv(p, x, num_heads: int, mla, positions, rope_theta, norm_eps):
    """The shared projections: q_nope (B, S, H, nope), q_rope (B, S, H,
    rope), c_kv (B, S, kv_rank) and k_rope (B, S, rope), the one key head
    that every query head shares, with RoPE on q_rope and k_rope."""
    B, S, _ = x.shape
    qh = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    q = rmsnorm_apply(p["q_a_norm"], x @ p["wq_a"], norm_eps) @ p["wq_b"]
    q = q.reshape(B, S, num_heads, qh)
    q_nope = q[..., :mla.qk_nope_head_dim]
    q_rope = q[..., mla.qk_nope_head_dim:]
    kv = x @ p["wkv_a"]
    c_kv = rmsnorm_apply(p["kv_a_norm"], kv[..., :mla.kv_lora_rank],
                         norm_eps)
    k_rope = kv[..., mla.kv_lora_rank:][:, :, None, :]
    if positions is not None:
        q_rope = apply_rope(q_rope, positions, rope_theta)
        k_rope = apply_rope(k_rope, positions, rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def mla_apply(p, x: torch.Tensor, *, num_heads: int, mla, positions=None,
              rope_theta=10000.0, norm_eps=1e-5, cache=None,
              cache_index=None, valid=None):
    """MLA attention, as ``repro/nn/attention.py:mla_apply``.

    - Without a cache: K and V decompressed per head (``c_kv @ wk_b``,
      ``c_kv @ wv_b``), causal attention over the tokens; returns out.
    - With a cache {"c_kv" (B, S_max, kv_rank), "k_rope" (B, S_max,
      rope)}: the *absorbed* form. ``c_kv`` and ``k_rope`` are written at
      ``cache_index`` in place (an int, or a 0-d int64 tensor on the
      device: a CUDA graph captures the step), ``q_nope`` is projected
      into the latent space through ``wk_b``, attention runs over all
      S_max slots of the compressed cache (slots past ``cache_index + Sq
      - 1`` and ``valid``'s pads masked) and ``wv_b`` applies after the
      weighting; returns (out, cache). The model's prefill passes a
      cache, so a served prefill takes this path too, as the
      reference's. ``valid`` is (B, P) over the first P slots, or all
      S_max of them.

    Scores and the weighting are float32 products, as the reference's;
    no kernel runs here (the reference's MLA is einsums)."""
    B, Sq, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(
        p, x, num_heads, mla, positions, rope_theta, norm_eps)
    scale = 1.0 / np.sqrt(mla.qk_nope_head_dim + mla.qk_rope_head_dim)

    if cache is None:
        k_nope = (c_kv @ p["wk_b"]).reshape(B, Sq, num_heads,
                                            mla.qk_nope_head_dim)
        v = (c_kv @ p["wv_b"]).reshape(B, Sq, num_heads, mla.v_head_dim)
        pos = positions if positions is not None else (
            torch.arange(Sq, dtype=torch.int32, device=x.device)[None])
        if pos.dim() == 1:
            pos = pos[None]
        bias = make_attention_bias(pos, pos, causal=True)
        if bias.dim() == 3:
            bias = bias[:, None]
        scores = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                              k_nope.float())
        scores += torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                               k_rope.float())
        scores *= scale
        probs = torch.softmax(scores + bias, dim=-1)
        del scores
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
        out = out.reshape(B, Sq, num_heads * mla.v_head_dim).to(x.dtype)
        return out @ p["wo"]

    # ---- absorbed attention over the compressed cache
    cc, cr = cache["c_kv"], cache["k_rope"]
    start = (cache_index.reshape(()).to(torch.int64)
             if torch.is_tensor(cache_index) else int(cache_index))
    slots = start + torch.arange(Sq, dtype=torch.int64, device=x.device)
    cc.index_copy_(1, slots, c_kv.to(cc.dtype))
    cr.index_copy_(1, slots, k_rope.to(cr.dtype))
    S_max = cc.shape[1]
    wk_b = p["wk_b"].reshape(mla.kv_lora_rank, num_heads,
                             mla.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b.float())
    ccf = cc.float()
    scores = torch.einsum("bqhr,bkr->bhqk", q_lat, ccf)
    del q_lat
    scores += torch.einsum("bqhd,bkd->bhqk", q_rope.float(), cr.float())
    scores *= scale
    k_pos = torch.arange(S_max, dtype=torch.int32, device=x.device)[None]
    q_pos = slots.to(torch.int32)[None]
    k_valid = k_pos <= q_pos[:, -1:]
    if valid is not None:
        # the pad slots stay masked, as in the GQA cache path
        P = valid.shape[1]
        vfull = torch.ones((B, S_max), dtype=torch.bool, device=x.device)
        vfull[:, :P] = valid.bool()
        k_valid = k_valid & vfull
    bias = make_attention_bias(q_pos, k_pos, causal=True, k_valid=k_valid)
    if bias.dim() == 3:
        bias = bias[:, None]
    scores += bias
    probs = torch.softmax(scores, dim=-1)
    del scores
    o_lat = torch.einsum("bhqk,bkr->bqhr", probs, ccf)
    del probs
    wv_b = p["wv_b"].reshape(mla.kv_lora_rank, num_heads, mla.v_head_dim)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b.float())
    out = out.reshape(B, Sq, num_heads * mla.v_head_dim).to(x.dtype)
    return out @ p["wo"], cache
