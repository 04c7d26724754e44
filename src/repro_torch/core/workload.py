"""Workload-count extraction: pipeline counters -> hardware-model inputs.

The analytic SSD model (ssd_model.py) consumes *workload counts* — how many
samples were segmented, seeds hashed, buckets probed, anchors sorted, DP
pairs evaluated, and bytes moved between stages.  We measure these on the
real pipeline over a benchmark read set, then linearly extrapolate
per-read averages to the paper-scale datasets (datasets.py), exactly how
MQSim-style simulation drives component models.

The JAX package's ``repro.core.workload``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import stages
from repro_torch.core.config import MarsConfig


@dataclasses.dataclass
class Workload:
    n_reads: int
    n_samples: int            # raw signal samples
    n_events: int             # detected events
    n_seeds: int              # valid seed keys hashed
    n_lookups: int            # hash-table queries (seeds probed)
    n_hits_raw: int           # seed hits before the frequency filter (capped)
    n_hits_exact: int         # uncapped exact hits (unbounded-baseline load)
    n_hits_postfreq: int
    n_votes: int              # votes cast by seed-and-vote
    n_anchors_postvote: int
    n_sorted: int             # anchors entering the sorter
    n_dp_pairs: int           # band DP (i,j) evaluations
    bytes_raw: int            # raw signal bytes read from flash
    bytes_index: int          # index bytes resident/streamed
    bytes_intermediate: int   # inter-stage traffic inside DRAM
    fixed_point: bool

    def scale(self, factor: float) -> "Workload":
        d = dataclasses.asdict(self)
        fixed = d.pop("fixed_point")
        scaled = {k: int(round(v * factor)) for k, v in d.items()}
        return Workload(fixed_point=fixed, **scaled)


def from_counters(counters: Dict[str, int], cfg: MarsConfig,
                  index_bytes: int) -> Workload:
    """Build a Workload from MapOutput.counters (the uniform per-chunk
    schema stages.CHUNK_COUNTER_SCHEMA every backend plan must emit)."""
    missing = [k for k in stages.CHUNK_COUNTER_SCHEMA if k not in counters]
    if missing:
        raise ValueError(f"counters missing {missing}; got {sorted(counters)}")
    n_reads = int(counters["n_reads"])
    n_samples = int(counters["n_samples"])
    n_events = int(counters["n_events"])
    n_seeds = int(counters["n_seeds"])
    n_hits_raw = int(counters["n_hits_raw"])
    n_hits_exact = int(counters.get("n_hits_exact", n_hits_raw))
    n_hits_postfreq = int(counters["n_hits_postfreq"])
    n_votes = int(counters.get("n_votes_cast", 0))
    n_postvote = int(counters["n_anchors_postvote"])
    n_sorted = int(counters["n_sorted"])
    n_dp = int(counters["n_dp_pairs"])

    sample_bytes = 2                       # raw signal stored as int16 DAC
    ev_bytes = 2 if cfg.fixed_point else 4
    bytes_raw = n_samples * sample_bytes
    bytes_intermediate = (
        n_events * ev_bytes                # events written back
        + n_seeds * 4                      # hash keys
        + n_hits_raw * 8                   # (t_pos, q_pos) anchors
        + n_sorted * 4                     # sort keys to controller + back
        + n_dp * 0                         # DP reads counted as AU ops
    )
    return Workload(
        n_reads=n_reads, n_samples=n_samples, n_events=n_events,
        n_seeds=n_seeds, n_lookups=n_seeds, n_hits_raw=n_hits_raw,
        n_hits_exact=n_hits_exact,
        n_hits_postfreq=n_hits_postfreq, n_votes=n_votes,
        n_anchors_postvote=n_postvote, n_sorted=n_sorted, n_dp_pairs=n_dp,
        bytes_raw=bytes_raw, bytes_index=index_bytes,
        bytes_intermediate=bytes_intermediate, fixed_point=cfg.fixed_point)
