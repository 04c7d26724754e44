"""Seed-and-vote filtering (paper Section 5.1, Fig. 2).

The reference is partitioned into overlapping, equal-length windows over the
*projected alignment start* (t_pos - q_pos).  Each anchor votes for the two
overlapping windows containing it (50% overlap); anchors whose best window
gathers fewer than ``thresh_voting`` votes are discarded before chaining.

Votes accumulate in a per-read mod-hash bin table (``vote_bins``) — the same
bounded-memory trade the in-storage Arithmetic Units make.  A whole chunk
is one integer ``scatter_add_`` over (R, vote_bins), so the result does not
depend on the accumulation order.  The projected-start shift is
clip-guarded: a diag below -DIAG_SHIFT lands in bin 0 and is tallied in the
``n_votes_clipped`` debug counter (outside the chunk counter schema).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.config import MarsConfig

# Projected starts are shifted by +2^20 before the window bit-ops so that
# slightly-negative diags (t_pos - q_pos < 0 near the reference start) stay
# non-negative.  Anything below -DIAG_SHIFT is clip-guarded (and counted).
DIAG_SHIFT = 1 << 20


def vote_filter_reference(q_pos: torch.Tensor, t_pos: torch.Tensor,
                          valid: torch.Tensor,
                          cfg: MarsConfig) -> Tuple[torch.Tensor, Dict]:
    """Pre-fast-path vote filter: each read's two bin scatters, no clip
    guard (a diag below -DIAG_SHIFT takes the arithmetic shift's bin, as in
    the reference package).  q_pos, t_pos: (R, E, H) int32; valid: same-shape
    bool.  Returns (valid', {n_anchors_postvote, n_votes_cast} of (R,)
    int32).  Parity oracle + the "pre" side of the cheap-phase
    microbenchmark."""
    R = q_pos.shape[0]
    red = (-2, -1)
    i32 = torch.int32
    if not cfg.use_vote_filter:
        return valid, dict(n_anchors_postvote=valid.sum(red).to(i32),
                           n_votes_cast=torch.zeros((R,), dtype=i32,
                                                    device=valid.device))
    v = cfg.voting_window_log2
    nbins = cfg.vote_bins
    diag = (t_pos - q_pos) + DIAG_SHIFT                     # projected start
    w1 = ((diag >> v) % nbins).reshape(R, -1).to(torch.int64)
    w2 = (((diag >> v) + 1) % nbins).reshape(R, -1).to(torch.int64)
    ones = valid.reshape(R, -1).to(i32)
    votes = torch.zeros((R, nbins), dtype=i32, device=valid.device)
    votes.scatter_add_(1, w1, ones)
    votes.scatter_add_(1, w2, ones)
    v1 = torch.gather(votes, 1, w1).reshape(valid.shape)
    v2 = torch.gather(votes, 1, w2).reshape(valid.shape)
    keep = valid & (torch.maximum(v1, v2) >= cfg.thresh_voting)
    return keep, dict(n_anchors_postvote=keep.sum(red).to(i32),
                      n_votes_cast=(2 * valid.sum(red)).to(i32))


def vote_filter(q_pos: torch.Tensor, t_pos: torch.Tensor, valid: torch.Tensor,
                cfg: MarsConfig) -> Tuple[torch.Tensor, Dict]:
    """q_pos, t_pos: (R, E, H) int32; valid: same-shape bool.  Returns
    (valid', counters of (R,) int32 vectors).

    Window id = projected start >> voting_window_log2; anchors vote for wid
    and wid+1; an anchor survives if either window reaches thresh_voting.
    """
    R = q_pos.shape[0]
    red = (-2, -1)
    i32 = torch.int32
    if not cfg.use_vote_filter:
        zeros = torch.zeros((R,), dtype=i32, device=valid.device)
        return valid, dict(n_anchors_postvote=valid.sum(red).to(i32),
                           n_votes_cast=zeros, n_votes_clipped=zeros)
    v = cfg.voting_window_log2
    nbins = cfg.vote_bins
    diag = t_pos - q_pos                                    # projected start
    shifted = diag + DIAG_SHIFT
    clipped = torch.clamp(shifted, min=0)
    n_clipped = (valid & (shifted < 0)).sum(red).to(i32)
    w1 = ((clipped >> v) % nbins).reshape(R, -1).to(torch.int64)
    w2 = (((clipped >> v) + 1) % nbins).reshape(R, -1).to(torch.int64)
    ones = valid.reshape(R, -1).to(i32)
    votes = torch.zeros((R, nbins), dtype=i32, device=valid.device)
    votes.scatter_add_(1, w1, ones)
    votes.scatter_add_(1, w2, ones)
    v1 = torch.gather(votes, 1, w1).reshape(valid.shape)
    v2 = torch.gather(votes, 1, w2).reshape(valid.shape)
    keep = valid & (torch.maximum(v1, v2) >= cfg.thresh_voting)
    counters = dict(n_anchors_postvote=keep.sum(red).to(i32),
                    n_votes_cast=(2 * valid.sum(red)).to(i32),
                    n_votes_clipped=n_clipped)
    return keep, counters
