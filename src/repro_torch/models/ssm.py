"""Mamba-2 SSD (state-space duality) block — chunked matmul form.

The SSD recurrence  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T,
y_t = C_t h_t + D x_t  (scalar A per head) is evaluated chunk-wise
(arXiv:2405.21060 Alg. 1): within a chunk the quadratic "attention-like"
matmul form; across chunks a small state (B,H,N,P) carried by a loop over
chunks — O(S) total.  Dtypes and rounding points are the reference's.

On a mesh the block computes every head on every rank of a 'model' line,
as the reference's constraint of ``zxbcdt`` to ('dp', None, None) asks:
``in_proj``'s columns are gathered (``layers.column_parallel``), the cache's ``state`` (split on heads)
and ``conv`` (split on d_inner) are gathered to run the step and the rank
keeps its blocks of the new ones, and ``out_proj`` is row-parallel (the
rank's rows of the gated output, a partial sum over 'model').
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import part
from repro_torch.models.layers import (column_parallel, einsum, rms_norm,
                                       row_parallel)

F32 = torch.float32
BF16 = torch.bfloat16
CHUNK = 512


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    d_in = cfg.d_inner
    H, N = cfg.n_ssm_heads, cfg.ssm_state
    z, xs, B_, C_, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)
    return z, xs, B_, C_, dt  # dt: (..., H)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width W.  x: (B,S,d), w: (W,d).
    With `state` (B,W-1,d): single-step decode, returns (y, new_state).
    The sum is python's ``sum`` of the W products in x's dtype, in order,
    as the reference rounds it (not a conv1d in f32)."""
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
        y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
        return F.silu(y.to(F32)).to(x.dtype), None
    full = torch.cat([state, x], dim=1)                  # (B, W, d)
    y = sum(full[:, i:i + 1, :] * w[i] for i in range(W))
    return (F.silu(y.to(F32)).to(x.dtype),
            full[:, 1:, :].to(state.dtype))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor,
                state0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xh: (B,S,H,P), dt: (B,S,H) (post-softplus), A: (H,) negative,
    B_, C_: (B,S,N) (single group).  Returns (y (B,S,H,P), state (B,H,N,P)).
    """
    Bb, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = min(CHUNK, S)
    nc = S // Q
    assert nc * Q == S, (S, Q)

    dA = dt * A[None, None, :]                       # (B,S,H) <= 0
    x_dt = xh * dt[..., None]                        # dt-weighted input

    def ck(t):                                       # (nc, B, Q, ...)
        return t.reshape(Bb, nc, Q, *t.shape[2:]).transpose(0, 1)
    dA_c, x_c, B_c, C_c = ck(dA), ck(x_dt), ck(B_), ck(C_)

    cum = torch.cumsum(dA_c, dim=2)                  # (nc,B,Q,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (nc,B,Qi,Qj,H)
    iq = torch.arange(Q, device=xh.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # the decay mask in bf16, as the reference keeps it.  The reference
    # takes exp(seg) everywhere and then masks it; above the diagonal seg
    # is a positive sum that overflows past ~88 (a long chunk), and the
    # mask's gradient, 0 * inf, is NaN there: the reference's gradient is
    # NaN from seq 128 on.  Masking before the exp gives the same values
    # (exp(-inf) = 0) and a finite gradient.
    L = torch.exp(torch.where(causal, seg, float("-inf"))).to(BF16)

    # intra-chunk: y_intra[i] = sum_j (C_i . B_j) L_ij x_dt[j]
    G = einsum("cbin,cbjn->cbij", C_c, B_c, f32=True).to(BF16)
    M = G[..., None] * L                             # (nc,B,Qi,Qj,H) bf16
    y_intra = einsum("cbijh,cbjhp->cbihp", M, x_c.to(BF16), f32=True)

    # inter-chunk: carried state
    decay_out = torch.exp(cum)                       # (nc,B,Q,H)
    decay_last = torch.exp(cum[:, :, -1:, :] - cum)  # exp(cum_Q - cum_j)
    if state0 is None:
        state0 = torch.zeros((Bb, H, N, P), dtype=F32, device=xh.device)

    state = state0.to(F32)
    y_inter = []
    for c in range(nc):
        # y_inter[i] = C_i . state * exp(cum_i)
        y_inter.append(einsum("bin,bhnp->bihp", C_c[c].to(F32), state)
                       * decay_out[c][..., None])
        chunk_decay = torch.exp(dA_c[c].sum(dim=1))  # (B,H)
        upd = einsum("bjn,bjhp->bhnp", B_c[c].to(F32),
                     x_c[c].to(F32) * decay_last[c][..., None])
        state = state * chunk_decay[:, :, None, None] + upd
    y = y_intra + torch.stack(y_inter)               # (nc,B,Q,H,P)
    y = y.transpose(0, 1).reshape(Bb, S, H, P)
    return y.to(xh.dtype), state


def ssd_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
              cache: Optional[dict] = None, mesh=None):
    """Full Mamba-2 block.  x: (B,S,d).

    p: {'in_proj' (d, 2*d_in+2N+H), 'conv_w' (W, d_in), 'A_log' (H,),
        'D' (H,), 'dt_bias' (H,), 'gate_norm' (d_in,), 'out_proj' (d_in,d)}.
    cache: {'conv' (B,W-1,d_in), 'state' (B,H,N,P)}, updated in place:
    a prefill (S > 1) runs the chunked scan from the empty state and
    stashes the final state and the conv tail; a decode step (S == 1)
    runs the single-step recurrence.
    """
    from repro_torch.models.part import constrain
    Bb, S, d = x.shape
    H, N, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    width = 2 * cfg.d_inner + 2 * N + H
    zxbcdt, = column_parallel(x, (p["in_proj"],), (width,), mesh)
    if zxbcdt.shape[-1] < width:             # the rank's columns
        zxbcdt = part.tp_gather(zxbcdt, -1, mesh)
    zxbcdt = constrain(zxbcdt, mesh, ("dp", None, None))
    z, xs, B_, C_, dt_raw = _split_proj(zxbcdt, cfg)
    dt_in = dt_raw.to(F32) + p["dt_bias"].to(F32)
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))     # softplus
    A = -torch.exp(p["A_log"].to(F32))

    new_cache = cache
    blocks = cache
    if cache is not None and part.tp_size(mesh) > 1:
        # the whole state and conv tail this step reads and writes; the
        # rank's blocks are copied back below
        cache = dict(conv=_whole(cache["conv"], -1, cfg.d_inner, mesh),
                     state=_whole(cache["state"], 1, H, mesh))
    if cache is None:
        xc, _ = _causal_conv(xs, p["conv_w"])
        xh = xc.reshape(Bb, S, H, P)
        y, _ = ssd_chunked(xh, dt, A, B_, C_)
        y = y.to(F32)
    elif S > 1:
        W = p["conv_w"].shape[0]
        xc, _ = _causal_conv(xs, p["conv_w"])
        xh = xc.reshape(Bb, S, H, P)
        y, state = ssd_chunked(xh, dt, A, B_, C_)
        y = y.to(F32)
        cache["conv"].copy_(xs[:, S - (W - 1):, :])
        cache["state"].copy_(state)
    else:
        xc, conv_state = _causal_conv(xs, p["conv_w"], cache["conv"])
        xh = xc.reshape(Bb, S, H, P)
        # single-step recurrence (S == 1 in decode)
        decay = torch.exp(dt * A[None, None, :])[:, 0]          # (B,H)
        upd = einsum("bn,bhp->bhnp", B_[:, 0].to(F32),
                     xh[:, 0].to(F32) * dt[:, 0, :, None])
        state = cache["state"].to(F32) * decay[:, :, None, None] + upd
        y = einsum("bn,bhnp->bhp", C_[:, 0].to(F32), state)[:, None]
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)

    if blocks is not cache:
        for k, dim in (("conv", -1), ("state", 1)):
            blocks[k].copy_(part.tp_block(cache[k], dim,
                                          blocks[k].shape[dim], mesh))

    # D skip connection on the (conv'd) input heads
    y = y + xh.to(F32) * p["D"].to(F32)[None, None, :, None]
    y = y.reshape(Bb, S, H * P).to(x.dtype)
    # gated RMSNorm (Mamba-2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z.to(F32)).to(x.dtype), p["gate_norm"])
    rows = p["out_proj"].shape[0]
    if rows < y.shape[-1]:                   # out_proj's rows over 'model'
        y = part.tp_block(y, -1, rows, mesh)
        return row_parallel(y, p["out_proj"], mesh), new_cache
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    return out, new_cache


def _whole(t: torch.Tensor, dim: int, n: int, mesh) -> torch.Tensor:
    """A cache block made whole along ``dim`` (n entries), a new tensor."""
    if t.shape[dim] < n:
        return part.tp_gather(t, dim, mesh)
    return t.clone()
