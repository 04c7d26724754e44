"""Synthetic nanopore raw-signal simulator.

Generates a random reference genome, samples reads from both strands and
synthesizes their raw current signals with per-base dwell times and Gaussian
noise, mirroring how RawHash2's evaluation datasets behave.  The simulator is
the ground-truth oracle for the accuracy experiments (paper Table 3).

Coordinate convention ("double genome"): the reference event sequence is the
concatenation of forward-strand events (length Le) and reverse-complement
events (length Le).  A target position t in [0, Le) is forward; t in
[Le, 2*Le) is reverse.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core import pore_model as pm


@dataclasses.dataclass
class Reference:
    bases: np.ndarray          # (L,) int8 in {0..3}
    events_fwd: np.ndarray     # (Le,) float32 expected levels, forward strand
    events_rc: np.ndarray      # (Le,) float32 expected levels, reverse strand
    table: np.ndarray          # (4096,) pore model

    @property
    def n_events(self) -> int:
        return int(self.events_fwd.shape[0])

    @property
    def events_concat(self) -> np.ndarray:
        return np.concatenate([self.events_fwd, self.events_rc])


@dataclasses.dataclass
class ReadSet:
    signals: np.ndarray        # (R, S) float32 raw signal
    true_pos: np.ndarray       # (R,) int32 forward-strand start (event coords)
    true_strand: np.ndarray    # (R,) int8 0=fwd, 1=rev
    n_bases: np.ndarray        # (R,) int32 bases consumed by each signal
    mappable: np.ndarray       # (R,) bool — False for junk/random reads


def make_reference(length: int, seed: int = 0) -> Reference:
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=length, dtype=np.int8)
    table = pm.pore_table()
    ev_f = pm.expected_events(bases, table)
    ev_r = pm.expected_events(pm.revcomp(bases), table)
    return Reference(bases=bases, events_fwd=ev_f, events_rc=ev_r, table=table)


def _signal_for_bases(levels: np.ndarray, signal_len: int, dwell_lo: int,
                      dwell_hi: int, noise_sigma: float,
                      rng: np.random.Generator) -> Tuple[np.ndarray, int]:
    """Emit `signal_len` samples walking `levels` with random dwell."""
    dwells = rng.integers(dwell_lo, dwell_hi + 1, size=levels.shape[0])
    reps = np.repeat(levels, dwells)
    n_bases = levels.shape[0]
    if reps.shape[0] < signal_len:                      # pad by re-walking
        reps = np.concatenate([reps, np.full(signal_len - reps.shape[0], reps[-1])])
    else:
        # how many full events fit
        csum = np.cumsum(dwells)
        n_bases = int(np.searchsorted(csum, signal_len, side="right")) + 1
        reps = reps[:signal_len]
    sig = reps + rng.normal(0.0, noise_sigma, size=signal_len)
    return sig.astype(np.float32), n_bases


def sample_reads(ref: Reference, n_reads: int, signal_len: int = 1024,
                 seed: int = 1, dwell: Tuple[int, int] = (5, 11),
                 noise_sigma: float = 1.5, junk_frac: float = 0.0) -> ReadSet:
    """Sample reads uniformly from both strands; optionally add unmappable
    junk reads (random signal) to exercise precision."""
    rng = np.random.default_rng(seed)
    Le = ref.n_events
    # enough bases that dwell-walking always fills signal_len
    span = signal_len // dwell[0] + pm.K + 2
    signals = np.zeros((n_reads, signal_len), np.float32)
    true_pos = np.zeros(n_reads, np.int32)
    true_strand = np.zeros(n_reads, np.int8)
    n_bases = np.zeros(n_reads, np.int32)
    mappable = np.ones(n_reads, bool)
    n_junk = int(round(junk_frac * n_reads))
    for i in range(n_reads):
        if i < n_junk:
            signals[i] = rng.normal(pm.LEVEL_MEAN, pm.LEVEL_SPAN / 4,
                                    size=signal_len).astype(np.float32)
            mappable[i] = False
            true_pos[i] = -1
            continue
        strand = int(rng.integers(0, 2))
        start = int(rng.integers(0, Le - span))
        if strand == 0:
            levels = ref.events_fwd[start:start + span]
        else:
            levels = ref.events_rc[start:start + span]
        sig, nb = _signal_for_bases(levels, signal_len, dwell[0], dwell[1],
                                    noise_sigma, rng)
        signals[i] = sig
        n_bases[i] = nb
        true_strand[i] = strand
        # ground truth in forward coordinates
        if strand == 0:
            true_pos[i] = start
        else:
            true_pos[i] = Le - 1 - (start + nb - 1)  # fwd coord of read end
    return ReadSet(signals=signals, true_pos=true_pos, true_strand=true_strand,
                   n_bases=n_bases, mappable=mappable)


def to_forward_coord(t_pos: np.ndarray, span: np.ndarray, n_events: int):
    """Convert double-genome target coords to (forward_pos, strand)."""
    t_pos = np.asarray(t_pos)
    strand = (t_pos >= n_events).astype(np.int8)
    fwd = np.where(strand == 0, t_pos,
                   n_events - 1 - ((t_pos - n_events) + span - 1))
    return fwd.astype(np.int64), strand
