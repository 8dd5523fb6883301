"""Plain PyTorch versions of the CUDA kernels, forward and backward: the
same functions, the same masked-row and clipping semantics, on whatever
device their inputs lie. The Sum-stage kernels' come first, then the LM
zoo's (``flash_attention_ref``, ``wkv6_ref``), with the reference's
float32 attention oracle ``mha_ref`` beside ``flash_attention_ref``.

The kernel wrappers in :mod:`repro_torch.kernels.ops` take these for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on
the card. ``NEG`` is the port's one masking sentinel (as
``repro/kernels/segment_sum.py:NEG`` is the reference's).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def _rows(perm: torch.Tensor, indptr: torch.Tensor, num_segments: int):
    """(edge ids in plan order, their destination rows) for the edges
    that join a row; pad edges sort past ``indptr[-1]`` and drop out."""
    counts = (indptr[1:] - indptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_segments, device=perm.device), counts)
    return perm[:seg.numel()].long(), seg


def segment_sum_ref(data: torch.Tensor, perm: torch.Tensor,
                    indptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """data (E, D) -> (num_segments, D): per-row sum over the row's edges."""
    rows, seg = _rows(perm, indptr, num_segments)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, seg, data.index_select(0, rows))


def segment_max_ref(data: torch.Tensor, perm: torch.Tensor,
                    indptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """data (E, D) -> (num_segments, D): per-row feature-wise max; empty
    rows give ``NEG`` (callers clamp), as ``segment_max_csc`` does."""
    rows, seg = _rows(perm, indptr, num_segments)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), NEG)
    idx = seg.view(-1, *([1] * (data.dim() - 1))).expand(
        (len(seg),) + tuple(data.shape[1:]))
    return out.scatter_reduce_(0, idx, data.index_select(0, rows), "amax",
                               include_self=True)


def edge_softmax_ref(logits: torch.Tensor, values: torch.Tensor,
                     perm: torch.Tensor, indptr: torch.Tensor,
                     num_segments: int):
    """logits (E, H), values (E, H, D) -> (out (N, H, D), m (N, H),
    den (N, H)): per destination and head, the softmax over the row's
    in-edges applied to their values, with the running max ``m`` and
    denominator ``den`` that ``edge_softmax_csc`` emits.

    Masked edges carry ``NEG`` logits and no separate mask, as in the
    kernel: a row whose edges are all masked gives ``m = NEG`` and
    ``den`` = its edge count (each ``exp(NEG - NEG)`` is 1), an empty row
    ``m = NEG`` and ``den = 0``; ``out = num / max(den, 1e-20)``."""
    rows, seg = _rows(perm, indptr, num_segments)
    h = logits.shape[1]
    lg = logits.index_select(0, rows)
    v = values.index_select(0, rows)
    m = logits.new_full((num_segments, h), NEG)
    m.scatter_reduce_(0, seg[:, None].expand(-1, h), lg, "amax",
                      include_self=True)
    p = torch.exp(lg - m[seg])
    den = logits.new_zeros((num_segments, h)).index_add_(0, seg, p)
    num = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    num.index_add_(0, seg, p[..., None] * v)
    return num / den.clamp_min(1e-20)[..., None], m, den


def _clipped_rows(edge_dst: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Each edge's destination row, clipped to the last row as
    ``jnp.take(..., mode="clip")`` clips it: a pad edge (``edge_dst ==
    num_segments``) reads row ``num_segments - 1``."""
    return edge_dst.long().clamp_max(num_segments - 1)


def segment_sum_bwd_ref(g: torch.Tensor, edge_dst: torch.Tensor
                        ) -> torch.Tensor:
    """g (N, D) -> (E, D): ``d_data[e] = g[edge_dst[e]]``, clipped; zeros
    when N = 0."""
    n = g.shape[0]
    if n == 0:
        return g.new_zeros((len(edge_dst),) + tuple(g.shape[1:]))
    return g.index_select(0, _clipped_rows(edge_dst, n))


def segment_max_bwd_ref(g: torch.Tensor, fwd_out: torch.Tensor,
                        data: torch.Tensor, edge_dst: torch.Tensor
                        ) -> torch.Tensor:
    """g / fwd_out (N, D), data (E, D) -> (E, D): ``d_data[e] =
    g[edge_dst[e]] * (data[e] == fwd_out[edge_dst[e]])``, clipped, as
    ``segment_max_bwd_csc`` computes it: every entry that attains its
    row's max gets the row's full cotangent (ties do not split it), a
    NaN entry none; zeros when N = 0."""
    n = g.shape[0]
    if n == 0:
        return data.new_zeros(data.shape)
    rows = _clipped_rows(edge_dst, n)
    return g.index_select(0, rows) * (data == fwd_out.index_select(0, rows))


def edge_softmax_bwd_ref(g: torch.Tensor, logits: torch.Tensor,
                         values: torch.Tensor, m: torch.Tensor,
                         den: torch.Tensor, og: torch.Tensor,
                         edge_dst: torch.Tensor):
    """g (N, H, D), logits (E, H), values (E, H, D), m / den / og (N, H)
    -> (d_logits (E, H), d_values (E, H, D)), as ``edge_softmax_bwd_csc``
    computes them: ``p_e = exp(logit_e - m_i) / max(den_i, 1e-20)``, zero
    where ``logit_e <= NEG/2``; ``d_values = p * g_i`` and ``d_logits =
    p * (values_e . g_i - og_i)``, with the row lookup clipped."""
    n = g.shape[0]
    if n == 0:
        return torch.zeros_like(logits), torch.zeros_like(values)
    rows = _clipped_rows(edge_dst, n)
    p = torch.exp(logits - m[rows]) / den[rows].clamp_min(1e-20)
    p = torch.where(logits > NEG / 2, p, torch.zeros_like(p))
    gi = g.index_select(0, rows)
    d_values = p[..., None] * gi
    d_logits = p * ((values * gi).sum(-1) - og[rows])
    return d_logits, d_values


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, sliding_window: int = 0) -> torch.Tensor:
    """q, k, v (B, T, H, D) -> (B, T, H, D) in q's dtype: the float32
    softmax oracle of ``repro/kernels/ref.py:63``, with masked scores at
    ``NEG`` (a row with no visible key, which neither mask makes, would
    average its values)."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((T, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (ki <= qi)
    if sliding_window:
        ok = ok & (ki > qi - sliding_window)
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, sliding_window: int = 0,
                        seq_len: int = 0,
                        kv_start: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q (B, T, Hq, D), k (B, T, Hkv, D), v (B, T, Hkv, Dv) -> (B, T, Hq,
    Dv) in q's dtype, computed in float32: what ``flash_attention``'s
    ``_flash_kernel`` computes, with GQA by index and a per-row key start.

    q head ``h`` reads kv head ``h // (Hq / Hkv)`` (the reference's
    ``jnp.repeat`` of the kv heads). Key ``j`` is visible to query ``i``
    of row ``b`` when ``j < seq_len`` (0 means T), ``j >= kv_start[b]``,
    and, as asked, ``j <= i`` (causal) and ``j > i - sliding_window``.
    Scores are ``q.k / sqrt(D)``, masked ones ``NEG``; the output is
    ``sum(p v) / max(sum(p), 1e-20)`` with ``p = 0`` on masked keys, so a
    query row with no visible key gives 0."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    seq_len = seq_len or T
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, T, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    ok = ki < seq_len
    if causal:
        ok = ok & (ki <= qi)
    if sliding_window:
        ok = ok & (ki > qi - sliding_window)
    if kv_start is not None:
        ok = ok[None] & (ki[None] >= kv_start.long()[:, None, None])
    else:
        ok = ok[None].expand(B, T, T)
    ok = ok[:, None, None]                               # (B, 1, 1, T, T)
    s = torch.where(ok, s, torch.full_like(s, NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    den = p.sum(-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / den
    return (out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, v.shape[-1])
            .to(q.dtype))


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None):
    """The RWKV-6 recurrence, one step at a time in float32, from a zero
    state: r, k, w (B, T, H, K), v (B, T, H, V), u (H, K) ->
    (o (B, T, H, V) in ``out_dtype``, S_final (B, H, K, V) float32), with

        o_t = r_t . (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T

    (``repro/kernels/ref.py:wkv6_ref``, which ``wkv6`` computes in
    chunks). ``out_dtype`` None is r's dtype (the TPU kernel's contract);
    ``torch.float32`` keeps o as the model's ``wkv_chunked`` returns it."""
    dtype = r.dtype if out_dtype is None else out_dtype
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    B, T, H, K = r.shape
    S = r.new_zeros((B, H, K, v.shape[-1]))
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    o = (torch.stack(outs, 1) if outs
         else v.new_zeros((B, 0, H, v.shape[-1])))
    return o.to(dtype), S
