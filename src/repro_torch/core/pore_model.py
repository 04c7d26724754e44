"""Nanopore pore model: k-mer -> expected current level.

A deterministic stand-in for the ONT 6-mer model used by RawHash2/Sigmap.
Levels are drawn from a fixed-seed hash so the simulator, the reference
index and the tests all agree without shipping a real model file.
"""
from __future__ import annotations

import numpy as np

K = 6                      # k-mer length of the pore model
N_KMERS = 4 ** K           # 4096
LEVEL_MEAN = 100.0         # ~pA, matches ONT R9 scale
LEVEL_SPAN = 60.0          # levels uniform in [70, 130]


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (SplitMix64)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def pore_table(seed: int = 7) -> np.ndarray:
    """(4096,) float32 expected current level for every 6-mer."""
    idx = np.arange(N_KMERS, dtype=np.uint64) + np.uint64(seed) * np.uint64(N_KMERS)
    h = _splitmix64(idx)
    u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)   # uniform [0,1)
    levels = LEVEL_MEAN - LEVEL_SPAN / 2 + u * LEVEL_SPAN
    return levels.astype(np.float32)


def kmer_ids(bases: np.ndarray) -> np.ndarray:
    """bases: (L,) int in {0..3} -> (L-K+1,) int32 k-mer ids (forward strand)."""
    L = bases.shape[0]
    n = L - K + 1
    if n <= 0:
        return np.zeros((0,), np.int32)
    ids = np.zeros(n, dtype=np.int64)
    for j in range(K):
        ids = ids * 4 + bases[j:j + n].astype(np.int64)
    return ids.astype(np.int32)


def revcomp(bases: np.ndarray) -> np.ndarray:
    """Reverse complement (A<->T, C<->G with A=0,C=1,G=2,T=3)."""
    return (3 - bases)[::-1]


def expected_events(bases: np.ndarray, table: np.ndarray) -> np.ndarray:
    """(L,) bases -> (L-K+1,) float32 expected event levels."""
    return table[kmer_ids(bases)]
