"""Plain PyTorch version of the fused cheap-phase kernel: the per-stage
cheap phase (core/cheap.py), from the Q-format samples on, flattened to
the kernel's output planes."""
from __future__ import annotations

import torch

from repro_torch.core import cheap
from repro_torch.core.config import MarsConfig

# Column order of the per-read counter plane (the reference package's
# kernels/cheap_fused/cheap_fused.py::COUNTER_COLS).
COUNTER_COLS = (
    "n_events", "n_seeds", "n_bucket_probes", "n_hits_raw",
    "n_hits_postfreq", "n_hits_exact", "n_votes_cast",
    "n_anchors_postvote", "n_votes_clipped",
)


def cheap_fused_rows_ref(xq: torch.Tensor, bucket_start: torch.Tensor,
                         entries_packed: torch.Tensor, cfg: MarsConfig):
    """xq: (R, S) int32 Q-format samples.  Returns (t_pos (R, E*H) int32,
    keep (R, E*H) int32, counters (R, 9) int32 in COUNTER_COLS order)."""
    index = {"bucket_start": bucket_start, "entries_packed": entries_packed}
    _, t_pos, keep, counters = cheap.cheap_stages_quantized(xq, index, cfg)
    R = xq.shape[0]
    cnt = torch.stack([counters[k].to(torch.int32) for k in COUNTER_COLS],
                      dim=1)
    return (t_pos.reshape(R, -1), keep.reshape(R, -1).to(torch.int32), cnt)


def cheap_fused_ref(signals: torch.Tensor, index, cfg: MarsConfig):
    """The reference package's oracle: the cheap phase of raw ``signals``
    (R, S) f32 through the reference plan's stage bodies
    (``pipeline.cheap_phase_vmap``): (q_pos, t_pos, hit_valid,
    counters)."""
    from repro_torch.core import pipeline, stages
    plan = stages.resolve_plan(cfg, stages.REFERENCE)
    return pipeline.cheap_phase_vmap(signals, index, cfg, plan)
