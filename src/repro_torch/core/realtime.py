"""Real-time incremental mapping with early termination (Read Until).

A mapping decision made BEFORE the full read is sequenced lets the
sequencer eject the molecule — saving pore time and enabling targeted
sequencing (paper Section 1; the UNCALLED / Readfish / RawHash use-case).
This module maps each read incrementally over growing signal prefixes and
stops at the first confident decision.

Each prefix length runs the same pipeline at its own shapes
(``stage_cfg``); the host advances only unresolved reads to the next stage,
as a sequencer streams chunks per channel.  Chunking, padding and device
streaming go through the driver (core/driver.py), and each stage's chunk
program is a ``Mapper`` over ONE resident index (``Mapper.with_cfg``), so
the serving driver's ladder (core/server.py) runs the same programs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import driver
from repro_torch.core.config import MarsConfig
from repro_torch.core.index import Index
from repro_torch.core.pipeline import Mapper


@dataclasses.dataclass
class RealtimeResult:
    t_start: np.ndarray       # (R,) final mapping position
    score: np.ndarray         # (R,)
    mapped: np.ndarray        # (R,) bool
    samples_used: np.ndarray  # (R,) samples consumed before the decision
    stage_of: np.ndarray      # (R,) stage index of the decision (-1 = full)

    @property
    def mean_fraction_used(self) -> float:
        return float(self.samples_used.mean() / self.samples_used.max())


def stage_cfg(cfg: MarsConfig, length: int) -> MarsConfig:
    """The per-prefix-length pipeline config shared by ``map_realtime`` and
    the serving driver's early-termination ladder (core/server.py): the
    same config gives the same programs, so both paths make bit-identical
    early decisions."""
    return cfg.replace(signal_len=length,
                       max_events=max(32, min(cfg.max_events, length // 5)))


def map_realtime(signals: np.ndarray, index: Index, cfg: MarsConfig,
                 stages: Sequence[int] = (256, 512, 768, 1024),
                 min_score: float = 8.0, chunk: int = 64,
                 use_kernels: bool = False, device="cuda",
                 backend: Optional[str] = None,
                 mesh=None) -> RealtimeResult:
    """signals: (R, S) f32.  ``stages`` are prefix lengths (last == S).

    A read is resolved at the earliest stage where it maps with
    score >= min_score; unresolved reads fall through to the full-length
    decision (scored with cfg.min_chain_score as usual).

    ``use_kernels`` / ``backend`` / ``device`` / ``mesh`` select the chunk
    program as in ``Mapper`` (CUDA unless the caller asks for the CPU; with
    a mesh, ``chunk`` must divide over its ranks).
    """
    R, S = signals.shape
    assert stages[-1] == S, (stages, S)
    # ONE index upload; the per-stage Mappers share it
    base = Mapper(index, cfg, use_kernels=use_kernels, backend=backend,
                  device=device, mesh=mesh)

    t_start = np.zeros(R, np.int64)
    score = np.zeros(R, np.float32)
    mapped = np.zeros(R, bool)
    samples_used = np.full(R, S, np.int64)
    stage_of = np.full(R, -1, np.int32)
    unresolved = np.ones(R, bool)

    for si, L in enumerate(stages):
        idxs = np.nonzero(unresolved)[0]
        if idxs.size == 0:
            break
        scfg = stage_cfg(cfg, L)
        last = si == len(stages) - 1
        thresh = scfg.min_chain_score if last else min_score
        fn = base.with_cfg(scfg).chunk_fn()

        def sel_chunks():
            # slice the unresolved rows lazily, one chunk at a time
            for ci, lo in enumerate(range(0, idxs.size, chunk)):
                sel = idxs[lo:lo + chunk]
                part = np.asarray(signals[sel, :L], np.float32)
                yield ci, sel.size, driver.pad_rows(part, chunk)

        for ci, n_valid, out in driver.stream_map(fn, sel_chunks()):
            sel = idxs[ci * chunk:ci * chunk + n_valid]
            o_t = np.asarray(out.t_start)
            o_s = np.asarray(out.score)
            o_m = np.asarray(out.mapped)
            decide = (o_m & (o_s >= thresh)) if not last else o_m
            done = sel[decide]
            t_start[done] = o_t[decide]
            score[done] = o_s[decide]
            mapped[done] = True
            samples_used[done] = L
            stage_of[done] = si
            unresolved[done] = False
            if last:
                rest = sel[~decide]
                samples_used[rest] = L
                unresolved[rest] = False
    return RealtimeResult(t_start=t_start, score=score, mapped=mapped,
                          samples_used=samples_used, stage_of=stage_of)
