"""Mixture-of-Experts FFN: the router and both dispatch implementations
(the counterpart of ``repro/arch/moe.py``).

``moe_ffn_dense``, the reference's default ``moe_impl``: every expert
runs on every token and the outputs are weighted by the renormalized
top-k router gates. It spends ``num_experts / top_k`` times the expert
FLOPs of sparse routing, by the reference's design. The reference has no
kernel here; the products are plain matrix products.

``moe_ffn_ep``, expert parallelism over an
:class:`~repro_torch.launch.mesh.ExpertMesh`: each ``data x model`` rank
routes its block of tokens into capacity-bounded buffers, one per
expert, which move to the experts' owners and back by the mesh
communicator's ``all_to_all``. Tokens past an expert's capacity are
dropped, earlier tokens first served, as in the reference, so the result
equals dense dispatch only where nothing drops. Under ``LocalComm`` every
rank lives in this process on one device (the exchange is a transpose);
under ``ProcessGroupComm`` each process holds its own model ranks, one
per card under the launcher (:mod:`repro_torch.launch.ranks`), and only
their experts (``moe_init``'s ``experts``). The step has static shapes,
no host sync and no atomic scatter: each kept (token, expert) pair owns
one buffer slot, so dispatch and combine are gathers, and their
backwards are gathers too. ``moe_ffn_ep_replicated`` is the model's
call where the communicator holds fewer model ranks than the mesh has:
every process runs the dense part on the whole batch, and hands the MoE
only its block of the sequence.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import _fan_in_init


def moe_init(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype, experts=None) -> dict:
    """The router, float32 whatever ``dtype`` is (as the reference's), and
    the experts' SwiGLU weights ``(E, d_in, d_out)``. ``_fan_in_init``
    takes fan_in from ``shape[0]``, which for the expert stacks is E: the
    reference draws them so, and the port copies it. ``experts`` (lo,
    hi), from :func:`expert_range`, keeps experts ``lo:hi`` of each
    stack: every stack is drawn whole from ``gen``, so the kept ones are
    bitwise a whole model's, and the rest is dropped at once (one
    stack's draw is the peak)."""
    lo, hi = (0, num_experts) if experts is None else experts

    def stack(shape):
        w = _fan_in_init(gen, shape, dtype=dtype)
        return w if (lo, hi) == (0, num_experts) else w[lo:hi].clone()

    return {
        "router": _fan_in_init(gen, (d_model, num_experts),
                               dtype=torch.float32),
        "wi_gate": stack((num_experts, d_model, d_ff)),
        "wi_up": stack((num_experts, d_model, d_ff)),
        "wo": stack((num_experts, d_ff, d_model)),
    }


def _per_device(E: int, M: int) -> int:
    """Experts per model rank, ``E_pad // M`` with ``E_pad = max(E, M)``;
    raises where the reference does (``E_pad`` not a multiple of M)."""
    E_pad = max(E, M)
    if E_pad % M != 0:
        raise ValueError(f"expert count {E} must pad to a multiple of "
                         f"the device count {M}")
    return E_pad // M


def expert_range(E: int, model: int, start: int, count: int) -> tuple:
    """(lo, hi): the real experts (of ``E``) that model ranks ``start`` to
    ``start + count`` of ``model`` own; the dead ones past ``E`` are
    zeros made at the call (:func:`_expert_slice`)."""
    per = _per_device(E, model)
    return min(start * per, E), min((start + count) * per, E)


def top_k_mask(probs: torch.Tensor, k: int) -> torch.Tensor:
    """1.0 on the ``k`` largest entries of the last axis, 0.0 elsewhere,
    in ``probs``' dtype: the experts ``jax.lax.top_k`` picks, which on a
    tie takes the lower index first (``torch.topk`` does not promise
    it). An entry is picked when fewer than ``k`` entries rank above it:
    the larger ones, and the equal ones at lower indices."""
    E = probs.shape[-1]
    a = probs[..., :, None]                     # entry e
    b = probs[..., None, :]                     # against entry j
    lower = torch.ones((E, E), dtype=torch.bool,
                       device=probs.device).tril(-1)   # [e, j]: j < e
    above = (b > a) | ((b == a) & lower)
    return (above.sum(-1) < k).to(probs.dtype)


def _route(p, x: torch.Tensor, moe_cfg):
    """The renormalized top-k gates (B, S, E) in float32, the routed
    share of each expert and its mean probability over (B, S)."""
    logits = x.float() @ p["router"]                        # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    mask = top_k_mask(probs, moe_cfg.top_k)                 # (B, S, E) 0/1
    gated = probs * mask
    gated = gated / torch.clamp_min(gated.sum(-1, keepdim=True), 1e-9)
    frac = mask.mean(dim=(0, 1))                            # routed share
    prob = probs.mean(dim=(0, 1))
    return gated, frac, prob


def router_gates(p, x: torch.Tensor, moe_cfg):
    """Renormalized top-k gates (B, S, E) in float32 and the Switch-style
    load-balance aux loss (a 0-d float32 tensor)."""
    gated, frac, prob = _route(p, x, moe_cfg)
    return gated, prob.shape[-1] * torch.sum(frac * prob)


def moe_ffn_dense(p, x: torch.Tensor, moe_cfg):
    """All experts on all tokens, gate-weighted combine; returns (out in
    x's dtype, aux). The reference's einsums ``bsd,edf->ebsf`` and
    ``ebsf,efd->ebsd`` are written as batched products over the expert
    axis, which read each expert's weights in place (``torch.einsum``
    would copy them into another layout first, on every call)."""
    gates, aux = router_gates(p, x, moe_cfg)                # (B, S, E)
    B, S, D = x.shape
    xt = x.reshape(1, B * S, D)
    # silu(h_g) * h_u with at most three (E, BS, F) tensors alive at once
    h = F.silu(torch.matmul(xt, p["wi_gate"]))              # (E, BS, F)
    h = h * torch.matmul(xt, p["wi_up"])
    y = torch.matmul(h, p["wo"]).reshape(-1, B, S, D)       # (E, B, S, D)
    out = torch.einsum("ebsd,bse->bsd", y, gates.to(y.dtype))
    return out.to(x.dtype), aux




# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

_DROP_LOGS: List[list] = []


@contextlib.contextmanager
def count_drops():
    """Inside the block every ``moe_ffn_ep`` call appends ``(dropped,
    routed)`` to the yielded list: its (token, expert) pairs dropped for
    capacity and all its routed pairs, as 0-d int64 tensors on the
    device (nothing is read back until the caller reads them)."""
    log: list = []
    _DROP_LOGS.append(log)
    try:
        yield log
    finally:
        _DROP_LOGS.remove(log)


def _padded(a: torch.Tensor) -> torch.Tensor:
    """(R, N, D) -> (R, N + 1, D): a zero row after the last."""
    return torch.cat([a, a.new_zeros((a.shape[0], 1, a.shape[2]))], dim=1)


def _rows(padded: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``padded[r, idx[r, k]]`` for (R, N + 1, D) and (R, K): (R, K, D);
    index N reads the zero row."""
    return torch.gather(padded, 1,
                        idx[..., None].expand(-1, -1, padded.shape[2]))


def _sum_slots(g: torch.Tensor, slot: torch.Tensor,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum_e w[r, t, e] * g[r, slot[r, t, e]]`` (w = 1 when None) for
    g (R, K, D) and slot (R, T, E) in [0, K], summed over e in order:
    (R, T, D)."""
    gp = _padded(g)
    out = None
    for e in range(slot.shape[2]):
        part = _rows(gp, slot[:, :, e])
        if w is not None:
            part = part * w[:, :, e, None]
        out = part if out is None else out + part
    return out


class _Dispatch(torch.autograd.Function):
    """The capacity buffers: ``buf[r, s] = x[r, tok[r, s]]``, a zero row
    where ``tok`` is T (an empty slot). Kept pairs own one slot each, so
    the backward gathers each token's slots, ``slot`` (R, T, E) (the
    spare index for a pair not kept), and sums them over e in order."""

    @staticmethod
    def forward(ctx, x, tok, slot):
        ctx.save_for_backward(slot)
        return _rows(_padded(x), tok)

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        return _sum_slots(g, slot), None, None


class _Combine(torch.autograd.Function):
    """``out[r, t] = sum_e w[r, t, e] * y[r, slot[r, t, e]]`` over e in
    order (w is 0 on pairs not kept). Backward: each slot's cotangent is
    its one pair's weight times its token's cotangent, gathered through
    ``tok`` (the slot's token; T for an empty slot) and the slot's expert
    ``s // cap``; each pair's weight cotangent is the product of its
    token's cotangent with its slot's output row."""

    @staticmethod
    def forward(ctx, y, w, slot, tok, cap):
        ctx.save_for_backward(y, w, slot, tok)
        ctx.cap = cap
        return _sum_slots(y, slot, w)

    @staticmethod
    def backward(ctx, g):
        y, w, slot, tok = ctx.saved_tensors
        gy = gw = None
        if ctx.needs_input_grad[0]:
            R, T, E = w.shape
            expert = torch.arange(tok.shape[1], device=tok.device) // ctx.cap
            pair = torch.where(tok < T, tok * E + expert, T * E)
            w_flat = torch.cat([w.reshape(R, T * E), w.new_zeros((R, 1))],
                               dim=1)
            gy = _rows(_padded(g), tok) * torch.gather(w_flat, 1,
                                                       pair)[..., None]
        if ctx.needs_input_grad[1]:
            yp = _padded(y)
            gw = torch.stack([(_rows(yp, slot[:, :, e]) * g).sum(-1)
                              for e in range(slot.shape[2])], dim=-1)
        return gy, gw, None, None, None


def moe_ffn_ep(p, x: torch.Tensor, moe_cfg, mesh, dp_axis=None):
    """Expert-parallel dispatch over ``mesh`` (an
    :class:`~repro_torch.launch.mesh.ExpertMesh`), the reference's
    ``moe_ffn_ep`` step by step; returns (out in x's dtype, aux).

    x: (B, S, D), this process's block: B split over ``data`` when
    ``dp_axis`` is given (else every data row holds the whole batch), S
    over the ``model`` ranks the communicator holds (all of them under
    ``LocalComm``, one under ``ProcessGroupComm``). Rank (d, m) routes
    its ``T = b * s`` tokens, batch-major, into ``(E_pad, cap, D)``
    buffers with ``cap = max(1, ceil(T * top_k / E * capacity_factor))``;
    an expert's slots go to the tokens that pick it in token order, and
    the rest are dropped. ``E_pad = max(E, model)``: dead experts have
    zero weights. Raises ``ValueError`` where the reference's
    ``shard_map`` does (B or S not evenly divisible) and where ``E_pad``
    is not a multiple of the model axis. The gates and aux are computed
    over the whole block before any split (under ``ProcessGroupComm``
    aux is the mean over every process's block) and the gates are cast
    to x's dtype before dispatch, as the reference casts them."""
    comm = mesh.comm
    M, L = mesh.model, comm.count
    E = moe_cfg.num_experts
    per_dev = _per_device(E, M)
    E_pad = per_dev * M
    Dp = mesh.data if dp_axis is not None else 1
    B, S, D = x.shape
    for name, n, ranks in (("batch", B, Dp), ("sequence", S, L)):
        if n % ranks != 0:
            raise ValueError(f"moe_ffn_ep: the {name} axis of x "
                             f"{tuple(x.shape)} ({n}) is not evenly "
                             f"divisible by the {ranks} ranks of the mesh "
                             "that split it")

    gates, frac, prob = _route(p, x, moe_cfg)            # the whole block
    if L != M:          # M // L processes: the global means
        frac = comm.all_reduce(frac[None]) / (M // L)
        prob = (comm.all_reduce(prob[None]) + prob - prob.detach()) \
            / (M // L)
    aux = E * torch.sum(frac * prob)

    b, s = B // Dp, S // L
    T, R = b * s, L * Dp

    def blocks(a):      # (B, S, C) -> (R, T, C), rank (l, d) at l * Dp + d
        return a.reshape(Dp, b, L, s, a.shape[-1]).permute(
            2, 0, 1, 3, 4).reshape(R, T, a.shape[-1])

    xr, g = blocks(x), blocks(gates.to(x.dtype))
    cap = max(1, math.ceil(T * moe_cfg.top_k / E * moe_cfg.capacity_factor))
    sel = g > 0                                          # (R, T, E)
    # pos + 1, scanned along T as the inner axis: (R, E, T)
    cnt_e = torch.cumsum(sel.transpose(1, 2).contiguous(), dim=-1,
                         dtype=torch.int32)
    cnt = cnt_e.transpose(1, 2)
    keep = sel & (cnt <= cap)
    spare = E_pad * cap
    slot = torch.where(keep, torch.arange(E, device=x.device) * cap
                       + cnt.long() - 1, spare)
    # slot c of expert e holds the first token whose count reaches c + 1
    # (T: none, the slot stays empty)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=x.device)
    tok = torch.searchsorted(cnt_e, want.expand(R, E, cap).contiguous())
    if E_pad != E:
        tok = torch.cat([tok, tok.new_full((R, E_pad - E, cap), T)], dim=1)
    tok = tok.reshape(R, spare)
    if _DROP_LOGS:
        routed = sel.sum()
        for log in _DROP_LOGS:
            log.append((routed - keep.sum(), routed))

    buf = _Dispatch.apply(xr, tok, slot)                 # (R, E_pad*cap, D)

    # ---- dispatch: each rank's expert slices to their owners ----------
    rows = Dp * per_dev * cap
    buf = buf.reshape(L, Dp, M, per_dev, cap, D).permute(
        0, 2, 1, 3, 4, 5).reshape(L, M, rows, D)
    buf = comm.all_to_all(buf)                           # rows by sender
    buf = buf.reshape(L, M, Dp, per_dev, cap, D).permute(
        0, 3, 2, 1, 4, 5).reshape(L * per_dev, Dp * M * cap, D)

    # ---- this process's experts ----------------------------------------
    lo, hi = comm.start * per_dev, (comm.start + L) * per_dev
    wg, wu, wo = (_expert_slice(p[k], E, E_pad, lo, hi)
                  for k in ("wi_gate", "wi_up", "wo"))
    h = F.silu(torch.matmul(buf, wg))
    h = h * torch.matmul(buf, wu)
    y = torch.matmul(h, wo)                 # (L * per_dev, Dp*M*cap, D)

    # ---- return: back to the senders ----------------------------------
    y = y.reshape(L, per_dev, Dp, M, cap, D).permute(
        0, 3, 2, 1, 4, 5).reshape(L, M, rows, D)
    y = comm.all_to_all(y)                               # rows by owner
    y = y.reshape(L, M, Dp, per_dev, cap, D).permute(
        0, 2, 1, 3, 4, 5).reshape(R, spare, D)

    # ---- combine: the kept outputs, gate-weighted, summed per token ---
    out = _Combine.apply(y, g * keep.to(g.dtype), slot, tok, cap)
    out = out.reshape(L, Dp, b, s, D).permute(1, 2, 0, 3, 4).reshape(B, S, D)
    return out.to(x.dtype), aux


def _expert_slice(w: torch.Tensor, E: int, E_pad: int, lo: int, hi: int):
    """Experts ``lo:hi`` of ``E_pad`` from ``w``: a whole stack (E, ...),
    or the process's own (its real experts of ``lo:hi``, as
    :func:`moe_init` keeps them), padded with zero (dead) experts past
    ``E``; a view where no dead expert is in range."""
    if w.shape[0] != E:                 # already the process's own
        real = max(0, min(hi, E) - lo)
        if w.shape[0] != real:
            raise ValueError(f"an expert stack of {w.shape[0]} experts is "
                             f"neither the whole {E} nor experts "
                             f"{lo}:{min(hi, E)}")
        if real == hi - lo:
            return w
        dead = w.new_zeros((hi - lo - real,) + tuple(w.shape[1:]))
        return torch.cat([w, dead], dim=0)
    if hi <= E:
        return w[lo:hi]
    dead = w.new_zeros((E_pad - E,) + tuple(w.shape[1:]))
    return torch.cat([w, dead], dim=0)[lo:hi]


# ---------------------------------------------------------------------------
# the model's call over processes
# ---------------------------------------------------------------------------


class _Replicated(torch.autograd.Function):
    """A weight every process holds whole and applies to its own tokens
    (the router): the identity, whose backward sums the cotangent over
    the processes, as ``shard_map`` transposes a replicated input into a
    ``psum``."""

    @staticmethod
    def forward(ctx, w, comm):
        ctx.comm = comm
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g[None]), None


def _seq_rows(a: torch.Tensor, L: int) -> torch.Tensor:
    """(B, L * s, D) -> (L, B, s, D): a process's sequence block as the
    communicator's rows, one per model rank."""
    B, Ls, D = a.shape
    return a.reshape(B, L, Ls // L, D).transpose(0, 1)


def _seq_unrows(a: torch.Tensor) -> torch.Tensor:
    """(n, B, s, D) -> (B, n * s, D)."""
    n, B, s, D = a.shape
    return a.transpose(0, 1).reshape(B, n * s, D)


class _SeqBlock(torch.autograd.Function):
    """(B, S, D), the same on every process -> this process's columns of
    S (``count`` blocks of ``S // model`` from block ``start``); the
    backward gathers every process's block cotangent into the whole
    one."""

    @staticmethod
    def forward(ctx, x, comm, M):
        s = x.shape[1] // M
        ctx.comm = comm
        lo = comm.start * s
        return x[:, lo:lo + comm.count * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        rows = _seq_rows(g, ctx.comm.count).contiguous()
        return _seq_unrows(ctx.comm.all_gather(rows)), None, None


class _SeqGather(torch.autograd.Function):
    """The transpose of :class:`_SeqBlock`: every process's block
    gathered into the whole (B, S, D); the backward keeps this process's
    block of the cotangent (every process holds the same one)."""

    @staticmethod
    def forward(ctx, y, comm, M):
        ctx.comm, ctx.M = comm, M
        rows = _seq_rows(y, comm.count).contiguous()
        return _seq_unrows(comm.all_gather(rows))

    @staticmethod
    def backward(ctx, g):
        s = g.shape[1] // ctx.M
        lo = ctx.comm.start * s
        return g[:, lo:lo + ctx.comm.count * s].contiguous(), None, None


def moe_ffn_ep_replicated(p, x: torch.Tensor, moe_cfg, mesh):
    """:func:`moe_ffn_ep` for a model whose communicator holds
    ``mesh.comm.count`` of the mesh's ``model`` ranks (one a process
    under the launcher): ``x`` (B, S, D) is the whole batch, the same on
    every process, since the dense part runs replicated; this process's
    block of S (B over ``data`` inside it) goes through
    :func:`moe_ffn_ep`, and the outputs are gathered back, as the
    reference's ``shard_map`` splits "B over ``data``, S over ``model``".
    The router's gradient is summed over the processes; each process's
    experts take theirs from every process's tokens through the
    exchange, and the dense part's is whole on every process. Raises
    ``ValueError`` before any exchange where S does not split."""
    comm, M = mesh.comm, mesh.model
    B, S, D = x.shape
    if S % M != 0:
        raise ValueError(f"moe_ffn_ep: the sequence axis of x "
                         f"{tuple(x.shape)} ({S}) is not evenly divisible "
                         f"by the {M} ranks of the mesh that split it")
    p = {"router": _Replicated.apply(p["router"], comm),
         **{k: p[k] for k in ("wi_gate", "wi_up", "wo")}}
    out, aux = moe_ffn_ep(p, _SeqBlock.apply(x, comm, M), moe_cfg, mesh,
                          dp_axis="data")
    return _SeqGather.apply(out, comm, M), aux
