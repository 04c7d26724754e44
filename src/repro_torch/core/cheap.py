"""The per-stage cheap phase (detect, quantize, seed, query, vote) over a
chunk, each stage a batch-level torch program.

It is level (2) of ``pipeline.cheap_phase``'s dispatch ladder: the plan's
``detector`` and ``gather`` plug in for the detect stage and the two
gathers of the query (the ``event_detect`` and ``pluto_lookup`` kernels
under the kernels plan; the torch reference math under the reference
plan).  From the Q-format samples on, the same program is the plain
version of the fused ``cheap_fused`` kernel (``kernels/cheap_fused/ref.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import events, hashing, quantization, seeding, vote
from repro_torch.core.config import MarsConfig


def cheap_phase_stages(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                       cfg: MarsConfig, detector: Callable, gather: Callable):
    """signals (R, S) f32 raw; ``detector(signals) -> (means, n_events)``
    and ``gather(table, idx)`` are the plan's (``stages.cheap_primitives``).
    Returns (q_pos (R,E,H), t_pos (R,E,H), hit_valid (R,E,H), per-read
    counters dict of (R,) int32)."""
    means, n_ev = detector(signals)
    return cheap_from_events(means, n_ev, index, cfg, gather)


def cheap_stages_quantized(xq: torch.Tensor, index: Dict[str, torch.Tensor],
                           cfg: MarsConfig):
    """``cheap_phase_stages`` of the fixed-point path from the Q-format
    samples (R, S) int32 on."""
    means, n_ev, _ = events.detect_quantized(xq, cfg)
    return cheap_from_events(means, n_ev, index, cfg)


def cheap_from_events(means: torch.Tensor, n_ev: torch.Tensor,
                      index: Dict[str, torch.Tensor], cfg: MarsConfig,
                      gather: Optional[Callable] = None):
    """The stages after detect: quantize, seed, query and vote."""
    E = cfg.max_events
    dev = means.device
    ev_valid = torch.arange(E, device=dev) < n_ev.unsqueeze(-1)
    sym = quantization.quantize_events(means, ev_valid, cfg)
    keys, seed_valid = hashing.pack_seeds(sym, n_ev, cfg)
    seed_valid = hashing.minimizer_mask(keys, seed_valid,
                                        cfg.minimizer_radius)
    t_pos, hit_valid, qc = seeding.query_index(keys, seed_valid, index, cfg,
                                               gather=gather)
    q_pos = torch.arange(E, dtype=torch.int32, device=dev)[
        None, :, None].expand(t_pos.shape)
    hit_valid, vc = vote.vote_filter(q_pos, t_pos, hit_valid, cfg)
    counters = {"n_events": n_ev, **qc, **vc}
    return q_pos, t_pos, hit_valid, counters
