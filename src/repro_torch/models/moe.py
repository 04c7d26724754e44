"""Mixture-of-Experts FFN: token-choice top-k routing with static capacity
(GShard-style dense dispatch) + optional shared expert.

Tokens are processed in groups of GROUP tokens, padded with all-zero rows
to a whole number of groups; each expert takes at most ``capacity`` tokens
of a group.  The dispatch and combine tensors, their dtypes and the Switch
load-balance loss are the reference's.

On a mesh the experts lie over 'model' (EP): the router's logits are
gathered whole before top-k, every rank routes the token groups alike, and
a rank computes its own experts' slots (a partial output summed over
'model'), the shared expert column- then row-parallel.  Token groups are
the whole batch's, as on one device: where the rank's rows do not form
whole groups its tokens are gathered over the DP axes first, so capacity
drops the tokens one device drops.  Every rank of those axes then routes
and computes the same tokens: the weights' gradients are each the whole
(``part.replica_share``).  The router, the experts and a split shared
expert take their input through ``part.tp_copy``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_size
from repro_torch.models import part
from repro_torch.models.layers import einsum, row_parallel

F32 = torch.float32
BF16 = torch.bfloat16
GROUP = 64           # tokens per dispatch group
CAPACITY_FACTOR = 1.0


def capacity(cfg: ArchConfig, group: int = GROUP) -> int:
    c = math.ceil(group * cfg.top_k * CAPACITY_FACTOR / cfg.n_experts)
    return max(4, -(-c // 4) * 4)      # round up to a multiple of 4


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties broken by
    the lower index (a stable descending sort; ``torch.topk`` promises no
    tie order, and the padded rows' probabilities tie exactly)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig, mesh=None,
            batch_axes=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  p: {'router' (d,E), 'w_gate','w_up' (E,d,f),
    'w_down' (E,f,d)[, shared expert 'sh_gate','sh_up','sh_down']}.

    Returns (y (B,S,d), aux_loss scalar) — aux is the standard load-balance
    loss (mean fraction * mean prob * E), padded tokens included as in the
    reference.  On a mesh, x is the rank's rows of a batch split over
    ``batch_axes``."""
    from repro_torch.models.part import constrain
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg)
    # the whole batch's groups: a rank whose rows are not whole groups
    # routes every rank's tokens and keeps its own rows' outputs
    whole = bool(batch_axes) and (B * S) % GROUP != 0
    if whole:
        x = part.gather([x], [0], batch_axes, mesh)[0]
        B = x.shape[0]
        p = {k: part.replica_share(v, batch_axes, mesh) for k, v in p.items()}
    T = B * S
    Tp = -(-T // GROUP) * GROUP                # pad to a group multiple
    xf = x.reshape(T, d)
    if Tp != T:
        xf = torch.cat([xf, torch.zeros((Tp - T, d), dtype=x.dtype,
                                        device=x.device)], dim=0)
    nG = Tp // GROUP
    xg = xf.reshape(nG, GROUP, d)
    t_valid = (torch.arange(Tp, device=x.device) < T).reshape(nG, GROUP)

    # the input of the products that differ by 'model' rank (the rank's
    # router columns and experts)
    xs = part.tp_copy(xg, mesh)
    if p["router"].shape[-1] < E:              # the router's E over 'model'
        logits = part.tp_gather(einsum("gtd,de->gte", xs, p["router"])
                                .to(F32), -1, mesh)
    else:
        logits = einsum("gtd,de->gte", xg, p["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                 # (nG, T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * mean(fraction_e) * mean(prob_e)
    top1 = F.one_hot(gate_idx[..., 0], E).to(F32)
    frac, prob = torch.mean(top1, dim=(0, 1)), torch.mean(probs, dim=(0, 1))
    if batch_axes and not whole:
        # the rank holds whole groups, as many as every other: the batch's
        # means are the means of the ranks'
        n = axis_size(mesh, batch_axes)
        both = part.all_sum(torch.stack([frac, prob]), batch_axes, mesh) / n
        frac, prob = both[0], both[1]
    aux = E * torch.mean(frac * prob)

    # --- capacity-constrained dispatch/combine masks -----------------------
    dispatch = torch.zeros((nG, GROUP, E, C), dtype=BF16, device=x.device)
    combine = torch.zeros((nG, GROUP, E, C), dtype=BF16, device=x.device)
    pos_base = torch.zeros((nG, 1, E), dtype=torch.int32, device=x.device)
    for s in range(k):
        oh = F.one_hot(gate_idx[..., s], E).to(torch.int32)   # (nG,T,E)
        oh = oh * t_valid[..., None]           # padded tokens route nowhere
        pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh + pos_base
        pos_base = pos_base + oh.sum(dim=1, keepdim=True, dtype=torch.int32)
        keep = (pos < C) & (oh > 0)
        # jax.nn.one_hot gives a zero row for pos >= C, which keep masks
        # here (F.one_hot refuses an index out of range)
        pc = F.one_hot(torch.clamp(pos, max=C - 1).long(), C).to(BF16) * \
            keep[..., None].to(BF16)                               # (nG,T,E,C)
        dispatch = dispatch + pc
        combine = combine + pc * gate_vals[..., s][..., None, None].to(BF16)

    # --- expert compute (the rank's experts on a mesh) --------------------
    E_loc = p["w_gate"].shape[0]
    if E_loc < E:
        dispatch = part.tp_block(dispatch, 2, E_loc, mesh)
        combine = part.tp_block(combine, 2, E_loc, mesh)
    xg = constrain(xg, mesh, ("dp", None, None))
    xe = einsum("gtec,gtd->gecd", dispatch, xs if E_loc < E else xg)
    h_g = einsum("gecd,edf->gecf", xe, p["w_gate"])
    h_u = einsum("gecd,edf->gecf", xe, p["w_up"])
    h = F.silu(h_g.to(F32)).to(xe.dtype) * h_u
    ye = einsum("gecf,efd->gecd", h, p["w_down"])
    if E_loc < E:
        y = row_parallel(combine.to(ye.dtype).reshape(nG, GROUP, -1),
                         ye.reshape(nG, -1, d), mesh)
    else:
        y = einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)

    if cfg.n_shared_experts:
        split = p["sh_down"].shape[0] < cfg.d_ff_expert * cfg.n_shared_experts
        xh = xs if split else xg
        g = einsum("gtd,df->gtf", xh, p["sh_gate"])
        u = einsum("gtd,df->gtf", xh, p["sh_up"])
        sh = F.silu(g.to(F32)).to(xg.dtype) * u
        if split:
            y = y + row_parallel(sh, p["sh_down"], mesh)
        else:
            y = y + einsum("gtf,fd->gtd", sh, p["sh_down"])

    y = y.reshape(Tp, d)[:T].reshape(B, S, d)
    if whole:
        y = part.batch_block(y, batch_axes, mesh)
    return y, aux
