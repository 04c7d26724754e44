"""Configuration for the MARS RSGA pipeline.

All bounds are static shapes fixed per run; thresholds follow the
paper (Section 5.1): small genomes (thresh_freq, thresh_voting, voting_window)
= (2000, 5, 256), large genomes (20000, 2, 256).  Our datasets are scaled-down
synthetics, so thresh_freq scales with them (it is dataset-specific in the
paper as well).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Pipeline modes (paper Section 7, "Evaluated Systems").
MODE_RH2 = "rh2"            # RawHash2 baseline: late quantization, float, no filters.
MODE_MS_FLOAT = "ms_float"  # MARS software: filters + early quantization, float.
MODE_MS_FIXED = "ms_fixed"  # MARS software: filters + early quantization, fixed point.

MODES = (MODE_RH2, MODE_MS_FLOAT, MODE_MS_FIXED)


@dataclasses.dataclass(frozen=True)
class MarsConfig:
    """Static configuration for one mapping run.  Frozen and hashable, so a
    resolved backend plan can be cached per config."""

    # ---- signal / event detection -------------------------------------------------
    signal_len: int = 1024          # samples per read chunk (S)
    max_events: int = 192           # E: static bound on events per read
    tstat_window: int = 4           # w: half-window for the two-sample t-statistic
    tstat_threshold: float = 2.5    # boundary threshold on the t-stat
    peak_window: int = 3            # local-max suppression radius
    min_dwell: int = 1              # min samples per segment (1 = rely on
                                    # peak_window; keeps the kernel scan-free)

    # ---- quantization (paper Section 5.2) -----------------------------------------
    quant_bits: int = 3             # q: bits per event symbol (8 levels)
    quant_clip_sigma: float = 3.0   # quantize over [-clip, +clip] sigmas
    frac_bits: int = 8              # fixed-point fractional bits (Q7.8 -> int16)
    early_quantization: bool = True  # MARS: quantize raw signal BEFORE event detection
    fixed_point: bool = True        # MARS: int16/int32 arithmetic after quantization

    # ---- seeding -------------------------------------------------------------------
    seed_width: int = 7             # w: events per seed
    hash_bits: int = 18             # h: direct-address bucket table = 2^h buckets
    max_hits_per_seed: int = 16     # H: static bound on hits gathered per seed
    minimizer_radius: int = 0       # winnowing subsample radius (0 = off);
                                    # applied identically to reads + index

    # ---- filters (paper Section 5.1) -----------------------------------------------
    use_freq_filter: bool = True
    thresh_freq: int = 12           # drop seeds with > thresh_freq hits (scaled)
    use_vote_filter: bool = True
    thresh_voting: int = 4          # min votes per window
    voting_window_log2: int = 8     # window = 256 (events ~ bases)
    vote_bins: int = 4096           # mod-hash bins for window votes

    # ---- chaining -------------------------------------------------------------------
    max_anchors: int = 512          # A: anchors kept after sort-compaction
    chain_band: int = 32            # B: DP band (look-back window in sorted order)
    max_gap: int = 128              # max gap (events) between chained anchors
    gap_cost: float = 0.3           # beta: |gap_t - gap_q| penalty
    skip_cost: float = 0.05         # alpha: min(gap) penalty
    anchor_score: float = 1.0       # w_i: score per chained anchor
    min_chain_score: float = 4.0    # report threshold
    map_ratio: float = 1.25         # best/second-best score ratio to call unique

    # ---- chaining fast path (filter-aware; core/pipeline.py) -----------------------
    chain_compaction: bool = True   # gate chaining to reads with anchors left
    chain_capacity_frac: float = 0.75  # compacted chain batch = ceil(frac * R)
    chain_widths: Tuple[int, ...] = (64, 128)  # select-then-sort width ladder
    anchor_select: str = "count"    # smallest-key selection: "count" | "topk"

    # ---- bookkeeping ----------------------------------------------------------------
    mode: str = MODE_MS_FIXED

    # ------------------------------------------------------------------------------
    @property
    def quant_levels(self) -> int:
        return 1 << self.quant_bits

    @property
    def n_buckets(self) -> int:
        return 1 << self.hash_bits

    @property
    def voting_window(self) -> int:
        return 1 << self.voting_window_log2

    def with_mode(self, mode: str) -> "MarsConfig":
        """Derive the per-system variants of paper Section 7.

        RH2 keeps its own frequency filter (RawHash2 ships one — the paper's
        novelty is the freq+vote COMBINATION plus early quantization), but
        no seed-and-vote, float arithmetic, late quantization.

        All three modes run in this package: ``ms_fixed`` through the fused
        cheap-phase kernel under the kernels plan, the float modes through
        the per-stage cheap phase (core/events.py, core/quantization.py)."""
        if mode == MODE_RH2:
            return dataclasses.replace(
                self, mode=mode, early_quantization=False, fixed_point=False,
                use_freq_filter=True, use_vote_filter=False)
        if mode == MODE_MS_FLOAT:
            return dataclasses.replace(
                self, mode=mode, early_quantization=True, fixed_point=False,
                use_freq_filter=True, use_vote_filter=True)
        if mode == MODE_MS_FIXED:
            return dataclasses.replace(
                self, mode=mode, early_quantization=True, fixed_point=True,
                use_freq_filter=True, use_vote_filter=True)
        raise ValueError(f"unknown mode {mode!r}")

    def replace(self, **kw) -> "MarsConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = MarsConfig()
