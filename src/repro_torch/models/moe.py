"""Mixture-of-Experts FFN: token-choice top-k routing with static capacity
(GShard-style dense dispatch) + optional shared expert.

Tokens are processed in groups of GROUP tokens, padded with all-zero rows
to a whole number of groups; each expert takes at most ``capacity`` tokens
of a group.  The dispatch and combine tensors, their dtypes and the Switch
load-balance loss are the reference's.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import einsum

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


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  p: {'router' (d,E), 'w_gate','w_up' (E,d,f),
    'w_down' (E,f,d)[, shared expert 'sh_gate','sh_up','sh_down']}.

    Returns (y (B,S,d), aux_loss scalar) — aux is the standard load-balance
    loss (mean fraction * mean prob * E), padded tokens included as in the
    reference."""
    from repro_torch.models.part import constrain
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg)
    T = B * S
    Tp = -(-T // GROUP) * GROUP                # pad to a group multiple
    xf = x.reshape(T, d)
    if Tp != T:
        xf = torch.cat([xf, torch.zeros((Tp - T, d), dtype=x.dtype,
                                        device=x.device)], dim=0)
    nG = Tp // GROUP
    xg = xf.reshape(nG, GROUP, d)
    t_valid = (torch.arange(Tp, device=x.device) < T).reshape(nG, GROUP)

    logits = einsum("gtd,de->gte", xg, p["router"]).to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                 # (nG, T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * mean(fraction_e) * mean(prob_e)
    top1 = F.one_hot(gate_idx[..., 0], E).to(F32)
    aux = E * torch.mean(torch.mean(top1, dim=(0, 1)) *
                         torch.mean(probs, dim=(0, 1)))

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

    # --- expert compute --------------------------------------------------
    xg = constrain(xg, mesh, ("dp", None, None))
    xe = einsum("gtec,gtd->gecd", dispatch, xg)                    # (nG,E,C,d)
    h_g = einsum("gecd,edf->gecf", xe, p["w_gate"])
    h_u = einsum("gecd,edf->gecf", xe, p["w_up"])
    h = F.silu(h_g.to(F32)).to(xe.dtype) * h_u
    ye = einsum("gecf,efd->gecd", h, p["w_down"])
    y = einsum("gtec,gecd->gtd", combine.to(ye.dtype), ye)

    if cfg.n_shared_experts:
        g = einsum("gtd,df->gtf", xg, p["sh_gate"])
        u = einsum("gtd,df->gtf", xg, p["sh_up"])
        sh = F.silu(g.to(F32)).to(xg.dtype) * u
        y = y + einsum("gtf,fd->gtd", sh, p["sh_down"])

    y = y.reshape(Tp, d)[:T]
    return y.reshape(B, S, d), aux
