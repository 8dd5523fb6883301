"""RWKV-6 ("Finch") block: time mixing with data-dependent decay plus
channel mixing (the counterpart of ``repro/arch/rwkv6_block.py``;
arXiv:2404.05892).

The same simplification as the reference: static token-shift mixing
coefficients instead of the data-dependent ddlerp; the recurrence is
unchanged. Prefill runs the recurrence through the ``wkv6`` kernel
(:func:`repro_torch.kernels.ops.wkv6_op`), which also returns the final
state for the decode cache and writes o in float32, so ``ln_x`` reads
the same float32 o as the reference's; decode is the one-step
recurrence in plain PyTorch, as the reference computes it outside any
kernel. Training (``train=True``) takes the reference's train path,
:func:`wkv_chunked`, plain PyTorch under autograd: the kernel has no
backward, in either package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.layers import _fan_in_init, rmsnorm_apply, rmsnorm_init


def rwkv_time_init(gen: torch.Generator, d_model: int, rc, dtype) -> dict:
    H = d_model // rc.head_dim
    dev = gen.device
    half = lambda: torch.full((d_model,), 0.5, device=dev)   # noqa: E731
    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "w_r": _fan_in_init(gen, (d_model, d_model), dtype=dtype),
        "w_k": _fan_in_init(gen, (d_model, d_model), dtype=dtype),
        "w_v": _fan_in_init(gen, (d_model, d_model), dtype=dtype),
        "w_g": _fan_in_init(gen, (d_model, d_model), dtype=dtype),
        "w_o": _fan_in_init(gen, (d_model, d_model), dtype=dtype),
        # data-dependent decay lora (Finch): w0 + tanh(x A) B
        "decay_w0": torch.full((d_model,), -2.0, device=dev),
        "decay_A": _fan_in_init(gen, (d_model, rc.decay_lora)),
        "decay_B": _fan_in_init(gen, (rc.decay_lora, d_model)),
        "bonus_u": torch.randn((H, rc.head_dim), generator=gen, device=dev)
        * 0.1,
        "ln_x": rmsnorm_init(d_model, torch.float32, dev),
    }


def rwkv_channel_init(gen: torch.Generator, d_model: int, d_ff: int,
                      dtype) -> dict:
    dev = gen.device
    return {
        "mu_k": torch.full((d_model,), 0.5, device=dev),
        "mu_r": torch.full((d_model,), 0.5, device=dev),
        "w_k": _fan_in_init(gen, (d_model, d_ff), dtype=dtype),
        "w_v": _fan_in_init(gen, (d_ff, d_model), dtype=dtype),
        "w_r": _fan_in_init(gen, (d_model, d_model), dtype=dtype),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; shifted[0] = last (carried across steps)."""
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor):
    return x + (xs - x) * mu.to(x.dtype)


def wkv_chunked(r, k, v, w, u, chunk: int):
    """The chunked log-domain WKV of ``repro/arch/rwkv6_block.py:69``, in
    plain PyTorch (differentiable): within a chunk, pairwise-decay
    attention batched over the chunks; across chunks, the state
    recurrence ``S_j = A_j * S_{j-1} + B_j``, a loop over the chunks (the
    reference's log-depth ``associative_scan`` sums the same terms in
    another order). r, k, w (B, T, H, K), v (B, T, H, V), u (H, K), T a
    multiple of ``chunk`` -> (o (B, T, H, V), S_final (B, H, K, V)),
    float32."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    nc = T // chunk
    rc_ = r.float().reshape(B, nc, chunk, H, K)
    kc = k.float().reshape(B, nc, chunk, H, K)
    vc = v.float().reshape(B, nc, chunk, H, V)
    lw = torch.log(torch.clamp_min(w.float(), 1e-12)).reshape(
        B, nc, chunk, H, K)
    la = torch.cumsum(lw, dim=2)
    la_ex = la - lw
    t_i = torch.arange(chunk, device=r.device)[:, None]
    u_i = torch.arange(chunk, device=r.device)[None, :]
    strict = (u_i < t_i)[None, None, :, :, None]
    diag = (t_i == u_i)[None, None, :, :, None]

    # within a chunk, all chunks at once
    ldiff = la_ex[:, :, :, None] - la[:, :, None]        # (B,nc,L,L,H,K)
    decay = torch.where(strict[..., None], torch.exp(ldiff),
                        torch.zeros((), device=r.device))
    scores = torch.einsum("bclhk,bcmhk,bclmhk->bclmh", rc_, kc, decay)
    db = torch.einsum("bclhk,bclhk,hk->bclh", rc_, kc, u.float())
    scores = scores + torch.where(diag, db[:, :, :, None],
                                  torch.zeros((), device=r.device))
    o = torch.einsum("bclmh,bcmhv->bclhv", scores, vc)

    # each chunk's state summary, then the recurrence over the chunks
    la_last = la[:, :, -1]                               # (B,nc,H,K)
    k_dec = kc * torch.exp(la_last[:, :, None] - la)
    b_hat = torch.einsum("bclhk,bclhv->bchkv", k_dec, vc)
    a = torch.exp(la_last)
    S = r.new_zeros((B, H, K, V), dtype=torch.float32)
    prev = []
    for j in range(nc):
        prev.append(S)
        S = a[:, j, :, :, None] * S + b_hat[:, j]
    s_prev = torch.stack(prev, dim=1)                    # (B,nc,H,K,V)
    o = o + torch.einsum("bclhk,bchkv->bclhv", rc_ * torch.exp(la_ex),
                         s_prev)
    return o.reshape(B, T, H, V), S


def rwkv_time_apply(p, x: torch.Tensor, rc, norm_eps: float, cache=None,
                    train: bool = False):
    """Time mixing. cache (decode): {"last": (B,1,D), "state": (B,H,K,V)}.
    Returns ``(out, new_cache)``; ``new_cache`` is None without a cache.
    A prefill (T > 1) starts from a zero state, as the reference's.
    ``train``: the recurrence through :func:`wkv_chunked` under autograd
    instead of the forward-only kernel."""
    B, T, D = x.shape
    H = D // rc.head_dim
    K = rc.head_dim
    last = cache["last"] if cache is not None else x.new_zeros((B, 1, D))
    xs = _token_shift(x, last)
    xr = _mix(x, xs, p["mu_r"])
    xk = _mix(x, xs, p["mu_k"])
    xv = _mix(x, xs, p["mu_v"])
    xw = _mix(x, xs, p["mu_w"])
    xg = _mix(x, xs, p["mu_g"])
    r = (xr @ p["w_r"]).reshape(B, T, H, K)
    k = (xk @ p["w_k"]).reshape(B, T, H, K)
    v = (xv @ p["w_v"]).reshape(B, T, H, K)
    g = F.silu(xg @ p["w_g"])
    # Finch data-dependent decay, in (0,1): exp(-exp(.))
    dd = p["decay_w0"] + torch.tanh(xw.float() @ p["decay_A"]) @ p["decay_B"]
    w = torch.exp(-torch.exp(dd)).reshape(B, T, H, K)

    new_cache = None
    if cache is None or T > 1:
        # the reference's chunked pass takes only T that its chunk
        # divides; the kernel runs any T, but both packages accept the
        # same inputs
        chunk = min(rc.chunk, T)
        if T % chunk != 0:
            raise ValueError(f"sequence length {T} must be a multiple of "
                             f"chunk {chunk}")
        if train:
            o, S = wkv_chunked(r, k, v, w, p["bonus_u"], chunk)
        else:
            # o in float32, as the reference's wkv_chunked returns it:
            # ln_x normalises it and the result rounds to x's dtype once
            o, S = ops.wkv6_op(r.contiguous(), k.contiguous(),
                               v.contiguous(), w.contiguous(),
                               p["bonus_u"].contiguous(),
                               out_dtype=torch.float32)
        if cache is not None:
            new_cache = {"last": x[:, -1:], "state": S}
    else:
        S = cache["state"]                                 # (B,H,K,V) f32
        r1, k1, v1, w1 = (a[:, 0].float() for a in (r, k, v, w))
        kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
        o = torch.einsum("bhk,bhkv->bhv", r1,
                         S + p["bonus_u"][None, :, :, None] * kv)[:, None]
        S = w1[..., None] * S + kv
        new_cache = {"last": x[:, -1:], "state": S}

    o = o.reshape(B, T, D)
    o = rmsnorm_apply(p["ln_x"], o, norm_eps).to(x.dtype)
    return (o * g) @ p["w_o"], new_cache


def rwkv_channel_apply(p, x: torch.Tensor, cache=None):
    """Channel mixing. cache (decode): {"last": (B,1,D)}."""
    B, T, D = x.shape
    last = cache["last"] if cache is not None else x.new_zeros((B, 1, D))
    xs = _token_shift(x, last)
    xk = _mix(x, xs, p["mu_k"])
    xr = _mix(x, xs, p["mu_r"])
    kk = torch.square(F.relu(xk @ p["w_k"]))
    out = torch.sigmoid(xr @ p["w_r"]) * (kk @ p["w_v"])
    new_cache = {"last": x[:, -1:]} if cache is not None else None
    return out, new_cache


def rwkv_init_cache(batch: int, d_model: int, rc, dtype, device=None):
    H = d_model // rc.head_dim
    return {
        "time": {"last": torch.zeros((batch, 1, d_model), dtype=dtype,
                                     device=device),
                 "state": torch.zeros((batch, H, rc.head_dim, rc.head_dim),
                                      dtype=torch.float32, device=device)},
        "channel": {"last": torch.zeros((batch, 1, d_model), dtype=dtype,
                                        device=device)},
    }
