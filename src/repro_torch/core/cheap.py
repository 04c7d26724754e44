"""The per-stage cheap phase (detect, quantize, seed, query, vote) over a
chunk, each stage a batch-level torch program.

It is the reference plan's cheap phase (``pipeline.cheap_phase``) and the
plain version of the fused ``cheap_fused`` kernel
(``kernels/cheap_fused/ref.py``), which starts from the Q-format samples.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import events, hashing, quantization, seeding, vote
from repro_torch.core.config import MarsConfig


def cheap_phase_stages(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                       cfg: MarsConfig):
    """signals (R, S) f32 raw.  Returns (q_pos (R,E,H), t_pos (R,E,H),
    hit_valid (R,E,H), per-read counters dict of (R,) int32)."""
    return cheap_stages_quantized(events.early_quantize(signals, cfg), index,
                                  cfg)


def cheap_stages_quantized(xq: torch.Tensor, index: Dict[str, torch.Tensor],
                           cfg: MarsConfig):
    """``cheap_phase_stages`` from the Q-format samples (R, S) int32 on."""
    means, n_ev, _ = events.detect_quantized(xq, cfg)
    E = cfg.max_events
    ev_valid = (torch.arange(E, device=xq.device)
                < n_ev.unsqueeze(-1))
    sym = quantization.quantize_events(means, ev_valid, cfg)
    keys, seed_valid = hashing.pack_seeds(sym, n_ev, cfg)
    seed_valid = hashing.minimizer_mask(keys, seed_valid,
                                        cfg.minimizer_radius)
    t_pos, hit_valid, qc = seeding.query_index(keys, seed_valid, index, cfg)
    q_pos = torch.arange(E, dtype=torch.int32, device=xq.device)[
        None, :, None].expand(t_pos.shape)
    hit_valid, vc = vote.vote_filter(q_pos, t_pos, hit_valid, cfg)
    counters = {"n_events": n_ev, **qc, **vc}
    return q_pos, t_pos, hit_valid, counters
