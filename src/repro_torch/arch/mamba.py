"""Selective SSM (Mamba) mixer with the chunked (SSD-style) scan (the
counterpart of ``repro/arch/mamba.py``).

As the reference, one scalar decay per head per step (Mamba-2/SSD), so
the intra-chunk terms and the per-chunk state summaries are batched
matrix products. The reference has no kernel here: its scan is einsums
and an ``associative_scan``, and the port's is plain PyTorch products.
The chunk-boundary recurrence ``S_j = A_j * S_{j-1} + B_j`` is a loop
over the chunks (the reference's log-depth ``associative_scan`` computes
the same sums in another order: on 8 chunks the final states part by
8.5e-8 of max|S| in float32, ``tests/test_torch_mamba.py``).

Prefill (more than one token, or no cache) runs the chunked scan and,
given a cache, returns the conv window's tail (the last ``K - 1``
pre-conv inputs, left-padded when the prompt is shorter) and the final
state; decode is the one-step recurrence over that cache. ``valid``
never reaches the mixer, as in the reference: a left-padded row's pads
enter its state (ROADMAP C.11).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.arch.hints import shard_hint
from repro_torch.nn.layers import _fan_in_init


def _dims(d_model: int, mc):
    d_in = mc.expand * d_model
    return d_in, d_in // mc.head_dim


def mamba_init(gen: torch.Generator, d_model: int, mc, dtype) -> dict:
    """The mixer's weights, drawn from ``gen`` on its device. ``dt_proj``,
    ``dt_bias``, ``A_log`` and ``D`` are float32 whatever ``dtype`` is,
    as the reference's. ``dt_bias`` comes from ``default_rng(0)`` whatever
    the generator (the reference's ``mamba_init`` draws it so): every
    layer gets the same values."""
    d_in, H = _dims(d_model, mc)
    dt_rank = mc.dt_rank or max(1, d_model // 16)
    dev = gen.device
    a = np.linspace(1.0, 16.0, H).astype(np.float32)
    dt_bias = np.log(np.expm1(np.clip(np.exp(np.random.default_rng(0)
                                             .uniform(np.log(1e-3),
                                                      np.log(1e-1), H)),
                                      1e-4, None)))
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": _fan_in_init(gen, (d_model, 2 * d_in), dtype=dtype),
        "conv_w": (torch.randn((mc.d_conv, d_in), generator=gen, **f32)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros(d_in, dtype=dtype, device=dev),
        "x_proj": _fan_in_init(gen, (d_in, dt_rank + 2 * mc.d_state),
                               dtype=dtype),
        "dt_proj": _fan_in_init(gen, (dt_rank, H), dtype=torch.float32),
        "dt_bias": torch.tensor(dt_bias.astype(np.float32), **f32),
        "A_log": torch.tensor(np.log(a), **f32),
        "D": torch.ones(H, **f32),
        "out_proj": _fan_in_init(gen, (d_in, d_model), dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """x (B, T, C), w (K, C): the depthwise causal conv, accumulated in
    float32 tap by tap in the reference's order, the bias added last."""
    K, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out += pad[:, i:i + T].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _ssd_chunked(xh, dt, a_log_cum, Bm, Cm, chunk: int):
    """The chunked selective scan: xh (B, T, H, P), dt (B, T, H),
    ``a_log_cum`` the chunk-local cumsum of log a, Bm and Cm (B, T, N).
    Returns y (B, T, H, P) and the final state (B, H, P, N), float32.

    The intra-chunk weights are built as (B, nc, H, L, L), heads before
    the chunk's rows, so that the products over them read them in place;
    the reference's (B, nc, L, L, H) holds the same values."""
    B_, T, H, P_ = xh.shape
    N = Bm.shape[-1]
    nc = T // chunk
    xc = xh.reshape(B_, nc, chunk, H, P_).float()
    dtc = dt.reshape(B_, nc, chunk, H).float()
    lac = a_log_cum.reshape(B_, nc, chunk, H)
    Bc = Bm.reshape(B_, nc, chunk, N).float()
    Cc = Cm.reshape(B_, nc, chunk, N).float()

    # ---- intra-chunk: M[l, m] = exp(la_l - la_m) G[l, m] dt_m, m <= l
    G = Cc @ Bc.transpose(-1, -2)                           # (B,nc,L,L)
    lat = lac.permute(0, 1, 3, 2)                           # (B,nc,H,L)
    M = lat[..., :, None] - lat[..., None, :]               # (B,nc,H,L,L)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    dtm = dtc.permute(0, 1, 3, 2)[..., None, :]
    if torch.is_grad_enabled():
        # under autograd (training), out of place: exp keeps its output
        # and each product its operands for the backward
        M = torch.exp(M).masked_fill(~causal, 0.0) * G[:, :, None] * dtm
    else:
        # serving: in place, since M is a full-width prefill's largest
        # temporary
        M.exp_()
        M.masked_fill_(~causal, 0.0)
        M.mul_(G[:, :, None])
        M.mul_(dtm)
    y = M @ xc.permute(0, 1, 3, 2, 4)                       # (B,nc,H,L,P)
    del M, G
    y = y.permute(0, 1, 3, 2, 4)                            # (B,nc,L,H,P)

    # ---- per-chunk state summaries
    la_last = lac[:, :, -1, :]                              # (B,nc,H)
    damp = torch.exp(la_last[:, :, None, :] - lac)          # (B,nc,L,H)
    w = (dtc * damp).permute(0, 1, 3, 2)                    # (B,nc,H,L)
    dB = w[..., None] * Bc[:, :, None]                      # (B,nc,H,L,N)
    Bhat = xc.permute(0, 1, 3, 4, 2) @ dB                   # (B,nc,H,P,N)
    del dB
    A = torch.exp(la_last)                                  # (B,nc,H)

    # ---- the chunk-boundary recurrence S -> A * S + Bhat, a loop over
    # the chunks; S_prev[j] is the state entering chunk j
    S_prev = torch.empty_like(Bhat)
    S = torch.zeros_like(Bhat[:, 0])
    for j in range(nc):
        S_prev[:, j] = S
        S = A[:, j, :, None, None] * S + Bhat[:, j]

    # ---- inter-chunk contribution
    inter = torch.einsum("bcln,bchpn->bclhp", Cc, S_prev)
    y = y + torch.exp(lac)[..., None] * inter
    return y.reshape(B_, T, H, P_), S


def mamba_apply(p, x: torch.Tensor, mc, cache=None):
    """x (B, T, D); ``cache`` {"conv": (B, K-1, d_in), "state": (B, H, P,
    N)}. Returns (out, new cache or None), as the reference's.

    Prefill (no cache, or T > 1) refuses T > chunk when the chunk does not
    divide it, as the reference does; with a cache it assumes the incoming
    cache is zero and returns the pre-conv tail and the final state.
    Decode (a cache and T == 1) is the one-step recurrence."""
    B, T, D = x.shape
    d_in, H = _dims(D, mc)
    P_, N = mc.head_dim, mc.d_state
    K = p["conv_w"].shape[0]
    xz = x @ p["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)
    prefill = cache is None or T > 1

    new_cache = None
    if prefill:
        xc = _causal_conv(xi, p["conv_w"], p["conv_b"])
    else:
        window = torch.cat([cache["conv"], xi], dim=1)     # (B, K, d_in)
        xc = torch.einsum("btc,tc->bc", window[:, -K:].float(),
                          p["conv_w"].float())[:, None, :]
        xc = (xc + p["conv_b"].float()).to(x.dtype)
        new_conv = window[:, -(K - 1):]
    xc = F.silu(xc)
    xc = shard_hint(xc, "batch", None, "heads_flat")

    proj = xc @ p["x_proj"]
    dt_rank = p["dt_proj"].shape[0]
    dt_in, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_in.float() @ p["dt_proj"] + p["dt_bias"])  # (B,T,H)
    A = -torch.exp(p["A_log"])                              # (H,) < 0
    log_a = dt * A[None, None, :]                           # (B,T,H) <= 0
    xh = xc.reshape(B, T, H, P_)

    if prefill:
        chunk = min(mc.chunk, T)
        if T % chunk != 0:
            raise ValueError(f"sequence length {T} must be a multiple of "
                             f"chunk {chunk}")
        la_local = torch.cumsum(log_a.reshape(B, T // chunk, chunk, H),
                                dim=2).reshape(B, T, H)
        y, S = _ssd_chunked(xh, dt, la_local, Bm, Cm, chunk)
        if cache is not None:
            tail = F.pad(xi, (0, 0, max(K - 1 - T, 0), 0))
            new_cache = {"conv": tail[:, -(K - 1):], "state": S}
    else:
        S = cache["state"]                                  # (B,H,P,N)
        a = torch.exp(log_a[:, 0])                          # (B,H)
        dB = dt[:, 0, :, None] * Bm[:, 0, None, :].float()  # (B,H,N)
        S = a[:, :, None, None] * S + (
            xh[:, 0, :, :, None].float() * dB[:, :, None, :])
        y = torch.einsum("bhpn,bn->bhp", S, Cm[:, 0].float())[:, None]
        new_cache = {"conv": new_conv, "state": S}

    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, T, d_in).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, new_cache


def mamba_init_cache(batch: int, mc, d_model: int, dtype, device=None
                     ) -> dict:
    """The decode cache: ``conv`` (B, K-1, d_in) in the model's dtype and
    ``state`` (B, H, P, N) in float32, zero."""
    d_in, H = _dims(d_model, mc)
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, mc.head_dim, mc.d_state),
                             dtype=torch.float32, device=device),
    }
