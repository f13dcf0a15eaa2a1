"""Mamba2 (state-space duality, arXiv:2405.21060): the JAX package's
``models/mamba.py`` in plain PyTorch.

Training and prefill use the chunked SSD algorithm: within a chunk of Q
timesteps the output is a masked (Q x Q) product; across chunks a Python
loop (the reference's ``lax.scan``) carries the (H, P, N) state.  Decode is
the O(1) recurrence h <- exp(dt*A) h + dt * B (x) x; y = C.h + Dx, plus a
(conv-1)-deep ring buffer for the depthwise conv.

Layout: ngroups=1 (B/C shared across heads); in_proj emits
[z | x | B | C | dt] as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import mean, normal


class MambaParams(NamedTuple):
    in_proj: torch.Tensor  # (D, 2*d_in + 2*N + H)
    conv_w: torch.Tensor  # (K, d_in + 2*N) depthwise
    conv_b: torch.Tensor  # (d_in + 2*N,)
    A_log: torch.Tensor  # (H,)
    D: torch.Tensor  # (H,)
    dt_bias: torch.Tensor  # (H,)
    norm_w: torch.Tensor  # (d_in,)
    out_proj: torch.Tensor  # (d_in, D)


class MambaState(NamedTuple):
    """Decode state: SSM state + conv ring buffer."""

    h: torch.Tensor  # (B, H, P, N) f32
    conv: torch.Tensor  # (B, K-1, d_in + 2*N)


def dims(d_model: int, expand: int, head_dim: int, state: int):
    d_in = expand * d_model
    n_heads = d_in // head_dim
    return d_in, n_heads


def init(gen: torch.Generator, d_model: int, *, expand: int, head_dim: int, state: int, conv: int, dtype,
         device) -> MambaParams:
    d_in, H = dims(d_model, expand, head_dim, state)
    proj_out = 2 * d_in + 2 * state + H
    f32 = dict(dtype=torch.float32, device=device)
    return MambaParams(
        in_proj=normal(gen, (d_model, proj_out), d_model**-0.5, dtype, device),
        conv_w=normal(gen, (conv, d_in + 2 * state), conv**-0.5, dtype, device),
        conv_b=torch.zeros((d_in + 2 * state,), dtype=dtype, device=device),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),  # A in [-16, -1]
        D=torch.ones((H,), **f32),
        dt_bias=torch.log(torch.exp(torch.linspace(1e-3, 1e-1, H, **f32)) - 1.0),
        norm_w=torch.ones((d_in,), dtype=dtype, device=device),
        out_proj=normal(gen, (d_in, d_model), d_in**-0.5, dtype, device),
    )


def _rms(x, w, eps=1e-5):
    xf = x.float()
    xf = xf * torch.rsqrt(mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def apply_scan(
    p: MambaParams,
    x: torch.Tensor,  # (B, S, D)
    *,
    expand: int,
    head_dim: int,
    state: int,
    conv: int,
    chunk: int = 64,
    init_state: MambaState | None = None,
    return_state: bool = False,
):
    """Full-sequence SSD (training / prefill)."""
    B, S, D = x.shape
    d_in, H = dims(D, expand, head_dim, state)
    P, N = head_dim, state
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1  # the reference's rule for lengths that are not a multiple
    nC = S // chunk

    proj = torch.einsum("bsd,dp->bsp", x, p.in_proj)
    z = proj[..., :d_in]
    xBC = proj[..., d_in : 2 * d_in + 2 * N]
    dt_raw = proj[..., 2 * d_in + 2 * N :]

    # depthwise causal conv over [x|B|C]
    prev = (
        init_state.conv
        if init_state is not None
        else torch.zeros((B, conv - 1, d_in + 2 * N), dtype=xBC.dtype, device=x.device)
    )
    xin = torch.cat([prev, xBC], dim=1)
    conv_out = torch.zeros(xBC.shape, dtype=torch.float32, device=x.device)
    for kk in range(conv):
        conv_out = conv_out + xin[:, kk : kk + S].float() * p.conv_w[kk].float()[None, None, :]
    xBC = F.silu(conv_out + p.conv_b.float()).to(x.dtype)
    new_conv_tail = xin[:, -(conv - 1) :] if conv > 1 else prev[:, :0]

    xs = xBC[..., :d_in].reshape(B, nC, chunk, H, P).float()
    Bmat = xBC[..., d_in : d_in + N].reshape(B, nC, chunk, N).float()
    Cmat = xBC[..., d_in + N :].reshape(B, nC, chunk, N).float()
    dt = _softplus(dt_raw.float() + p.dt_bias[None, None, :]).reshape(B, nC, chunk, H)
    A = -torch.exp(p.A_log)  # (H,)
    dA = dt * A[None, None, None, :]  # (B,nC,Q,H) negative

    # ---- intra-chunk (dual / quadratic) ------------------------------------
    cs = torch.cumsum(dA, dim=2)  # (B,nC,Q,H)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nC,Q,Q,H)
    ii = torch.arange(chunk, device=x.device)
    causal_mask = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal_mask, diff, -1e30))  # masked before exp
    CB = torch.einsum("bcin,bcjn->bcij", Cmat, Bmat)
    M = CB[:, :, :, :, None] * L * dt[:, :, None, :, :]  # (B,nC,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xs)

    # ---- chunk boundary states ---------------------------------------------
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # (B,nC,Q,H)
    # the reference's three-operand einsums, contracted pairwise in the order
    # JAX's path picks: an outer product first, then the contraction
    BW = Bmat[..., :, None] * (dt * decay_to_end)[..., None, :]  # (B,nC,Q,N,H)
    Sc = torch.einsum("bcjhp,bcjnh->bchpn", xs, BW)  # (B,nC,H,P,N)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B,nC,H)

    h = init_state.h if init_state is not None else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nC):
        h_in.append(h)  # the state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + Sc[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nC,H,P,N)

    # ---- inter-chunk contribution -------------------------------------------
    decay_from_start = torch.exp(cs)  # (B,nC,Q,H)
    hC = torch.einsum("bchpn,bcin->bchpi", h_in, Cmat)
    y_inter = decay_from_start[..., None] * hC.permute(0, 1, 4, 2, 3)  # (B,nC,Q,H,P)
    y = y_intra + y_inter + xs * p.D[None, None, None, :, None]
    y = y.reshape(B, S, d_in)

    # gated norm + out projection
    y = _rms((y * F.silu(z.float())).to(x.dtype), p.norm_w)
    out = torch.einsum("bsd,dp->bsp", y, p.out_proj)
    if return_state:
        return out, MambaState(h=h, conv=new_conv_tail)
    return out


def apply_step(
    p: MambaParams,
    x: torch.Tensor,  # (B, 1, D)
    st: MambaState,
    *,
    expand: int,
    head_dim: int,
    state: int,
    conv: int,
) -> Tuple[torch.Tensor, MambaState]:
    """Single-token decode: O(1) state update."""
    B, _, D = x.shape
    d_in, H = dims(D, expand, head_dim, state)
    P, N = head_dim, state
    proj = torch.einsum("bsd,dp->bsp", x, p.in_proj)[:, 0]  # (B, proj)
    z = proj[:, :d_in]
    xBC = proj[:, d_in : 2 * d_in + 2 * N]
    dt_raw = proj[:, 2 * d_in + 2 * N :]

    # conv ring buffer
    window = torch.cat([st.conv, xBC[:, None, :]], dim=1)  # (B,K,ch)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p.conv_w.float())
    xBC = F.silu(conv_out + p.conv_b.float()).to(x.dtype)
    new_conv = window[:, 1:]

    xs = xBC[:, :d_in].reshape(B, H, P).float()
    Bv = xBC[:, d_in : d_in + N].float()
    Cv = xBC[:, d_in + N :].float()
    dt = _softplus(dt_raw.float() + p.dt_bias[None, :])  # (B,H)
    A = -torch.exp(p.A_log)
    dec = torch.exp(dt * A[None, :])  # (B,H)
    Bdt = Bv[:, :, None] * dt[:, None, :]  # (B,N,H): the outer product first, as JAX contracts
    h = st.h * dec[:, :, None, None] + torch.einsum("bhp,bnh->bhpn", xs, Bdt)
    y = torch.einsum("bn,bhpn->bhp", Cv, h) + xs * p.D[None, :, None]
    y = y.reshape(B, 1, d_in)
    y = _rms((y * F.silu(z[:, None].float())).to(x.dtype), p.norm_w)
    out = torch.einsum("bsd,dp->bsp", y, p.out_proj)
    return out, MambaState(h=h, conv=new_conv)
