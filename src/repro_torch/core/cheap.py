"""The per-stage cheap phase (detect, quantize, seed, query, vote) over a
chunk, each stage a batch-level torch program.

It is level (2) of ``pipeline.cheap_phase``'s dispatch ladder: the plan's
``detector`` and ``gather`` plug in for the detect stage and the two
gathers of the query (the ``event_detect`` and ``pluto_lookup`` kernels
under the kernels plan; the torch reference math under the reference
plan), or ``query_fn`` for the whole query (the query backend's stage
body, where it is no gather: the tiered index's, ring, a2a).  Quantize,
seed, query and vote run the stage bodies of ``stages`` (the reference
package's cheap phase runs its registered bodies for them too), so the
math lives in one place.  The chunk program resumes from the tiered
pre-pass's keys (``cheap_from_keys``).  From the Q-format samples on, the
same program is the plain version of the fused ``cheap_fused`` kernel
(``kernels/cheap_fused/ref.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import events, stages
from repro_torch.core.config import MarsConfig


def cheap_phase_stages(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                       cfg: MarsConfig, detector: Callable,
                       gather: Optional[Callable] = None,
                       query_fn: Optional[Callable] = None):
    """signals (R, S) f32 raw; ``detector(signals) -> (means, n_events)``
    and ``gather(table, idx)`` or ``query_fn(state, cfg, index)`` (a query
    stage body) are the plan's (``stages.cheap_primitives``).  Returns
    (q_pos (R,E,H), t_pos (R,E,H), hit_valid (R,E,H), per-read counters
    dict of (R,) int32)."""
    means, n_ev = detector(signals)
    return cheap_from_events(means, n_ev, index, cfg, gather, query_fn)


def cheap_stages_quantized(xq: torch.Tensor, index: Dict[str, torch.Tensor],
                           cfg: MarsConfig):
    """``cheap_phase_stages`` of the fixed-point path from the Q-format
    samples (R, S) int32 on."""
    means, n_ev, _ = events.detect_quantized(xq, cfg)
    return cheap_from_events(means, n_ev, index, cfg)


def cheap_from_events(means: torch.Tensor, n_ev: torch.Tensor,
                      index: Dict[str, torch.Tensor], cfg: MarsConfig,
                      gather: Optional[Callable] = None,
                      query_fn: Optional[Callable] = None):
    """The stages after detect: quantize, seed, query and vote."""
    st = {"events": means, "n_events": n_ev}
    st = stages.seed_ref(stages.quantize_ref(st, cfg, index), cfg, index)
    return cheap_from_keys(st["keys"], st["seed_valid"], n_ev, index, cfg,
                           gather, query_fn)


def cheap_from_keys(keys: torch.Tensor, seed_valid: torch.Tensor,
                    n_ev: torch.Tensor, index: Dict[str, torch.Tensor],
                    cfg: MarsConfig, gather: Optional[Callable] = None,
                    query_fn: Optional[Callable] = None):
    """The query and vote stages from the seed keys on: ``query_fn`` (the
    plan's query stage body) when its backend is no gather, else
    ``stages.query_with`` with ``gather``."""
    st = {"keys": keys, "seed_valid": seed_valid,
          "counters": {"n_events": n_ev}}
    if query_fn is None:
        st = stages.query_with(st, cfg, index, gather=gather)
    else:
        st = query_fn(st, cfg, index)
    st = stages.vote_ref(st, cfg, index)
    return st["q_pos"], st["t_pos"], st["hit_valid"], st["counters"]
