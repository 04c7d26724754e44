"""The benchmark's inputs, made from ``--seed``: a synthetic reference genome
and its expected event levels, and a pool of raw-signal reads.

A frozen copy of the port's simulator (``signal/simulate.py``) and pore
model (``core/pore_model.py``), the reads drawn in bulk on the card: a
random genome (numpy), reads drawn from both strands with a per-base dwell
of ``dwell`` samples and Gaussian noise, and a share of junk reads (random
signal).  Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

K = 6                      # k-mer length of the pore model
N_KMERS = 4 ** K
LEVEL_MEAN = 100.0         # ~pA, the R9 scale
LEVEL_SPAN = 60.0          # levels uniform in [70, 130]
PORE_SEED = 7              # the pore model's fixed table seed
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_BLOCK = 8192              # reads generated at a time


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    z = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return z ^ (z >> np.uint64(31))


def pore_table() -> np.ndarray:
    """(4096,) f32 expected current level of every 6-mer."""
    idx = (np.arange(N_KMERS, dtype=np.uint64)
           + np.uint64(PORE_SEED) * np.uint64(N_KMERS))
    u = (_splitmix64(idx) >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return (LEVEL_MEAN - LEVEL_SPAN / 2 + u * LEVEL_SPAN).astype(np.float32)


def expected_events(bases: np.ndarray, table: np.ndarray) -> np.ndarray:
    """(L,) bases in {0..3} -> (L-K+1,) f32 expected event levels."""
    n = bases.shape[0] - K + 1
    ids = np.zeros(n, np.int64)
    for j in range(K):
        ids = ids * 4 + bases[j:j + n].astype(np.int64)
    return table[ids]


@dataclasses.dataclass
class Genome:
    events_fwd: np.ndarray     # (Le,) f32 forward strand
    events_rc: np.ndarray      # (Le,) f32 reverse complement

    @property
    def n_events(self) -> int:
        return int(self.events_fwd.shape[0])

    @property
    def events_concat(self) -> np.ndarray:
        """The double genome: forward ++ reverse events, (2 Le,) f32."""
        return np.concatenate([self.events_fwd, self.events_rc])


def make_genome(length: int, seed: int) -> Genome:
    rng = np.random.default_rng([int(seed) % (1 << 64), 0])
    bases = rng.integers(0, 4, size=length, dtype=np.int8)
    table = pore_table()
    return Genome(events_fwd=expected_events(bases, table),
                  events_rc=expected_events((3 - bases)[::-1], table))


def make_pool(genome: Genome, n_reads: int, signal_len: int, seed: int,
              dwell=(5, 11), noise_sigma: float = 1.5,
              junk_frac: float = 0.08, device="cpu") -> np.ndarray:
    """(n_reads, signal_len) f32 raw signals in host memory, drawn on
    ``device`` by a ``torch.Generator`` seeded with ``seed``, in bulk: each
    read walks the levels of a random strand from a random start, each
    level for a random dwell, plus Gaussian noise; round(junk_frac * n)
    reads at random places are junk (random signal).  One device type
    gives the same pool for the same seed."""
    import torch
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    R, S = n_reads, signal_len
    span = S // dwell[0] + K + 2          # enough levels to fill S samples
    strand = torch.randint(0, 2, (R,), generator=g, device=dev)
    start = torch.randint(0, genome.n_events - span, (R,), generator=g,
                          device=dev)
    junk = torch.zeros(R, dtype=torch.bool, device=dev)
    junk[torch.randperm(R, generator=g, device=dev)[
        :int(round(junk_frac * R))]] = True
    levels = torch.from_numpy(np.stack([genome.events_fwd,
                                        genome.events_rc])).to(dev)
    out = np.empty((R, S), np.float32)
    samples = torch.arange(S, device=dev)
    for b in range(0, R, _BLOCK):            # bounds the index planes
        n = min(_BLOCK, R - b)
        dw = torch.randint(dwell[0], dwell[1] + 1, (n, span), generator=g,
                           device=dev)
        # sample s shows level j = #(cumulative dwells <= s)
        lvl = torch.searchsorted(torch.cumsum(dw, 1),
                                 samples.expand(n, S).contiguous(),
                                 right=True)
        x = levels[strand[b:b + n, None], start[b:b + n, None] + lvl]
        x += torch.randn((n, S), generator=g, device=dev) * noise_sigma
        noise = LEVEL_MEAN + torch.randn((n, S), generator=g,
                                         device=dev) * (LEVEL_SPAN / 4)
        out[b:b + n] = torch.where(junk[b:b + n, None], noise, x).cpu().numpy()
    return out
