"""Dataset registry mirroring the paper's Table 2 (scaled for CPU).

The paper evaluates five real datasets (SARS-CoV-2 .. human HG001).  Our
reproduction generates synthetic equivalents: the genome LENGTH is scaled,
while `paper_*` fields keep the original magnitudes so the analytic
hardware model can extrapolate measured per-read workload counts to paper
scale (workload.Workload.scale).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.config import MarsConfig
from repro_torch.signal import simulate


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    key: str
    organism: str
    genome_len: int            # scaled synthetic genome (bases)
    paper_genome_len: int      # real genome size (bp, Table 2)
    paper_reads: int           # Table 2
    paper_bases: float         # Table 2 (bases sequenced)
    paper_bytes: float         # Table 2 dataset size (raw signal bytes)
    bench_reads: int           # reads to simulate for benchmarks
    large: bool                # 'large genome' filter thresholds (Section 5.1)
    seed: int = 0

    @property
    def scale_factor(self) -> float:
        """Deprecated read-count factor; prefer bytes_scale_factor."""
        return self.paper_reads / self.bench_reads

    def bytes_scale_factor(self, bench_bytes_raw: int) -> float:
        """paper raw bytes / bench raw bytes — the extrapolation factor for
        the analytic HW model (workload counts scale with signal volume)."""
        return float(self.paper_bytes) / float(bench_bytes_raw)

    @property
    def genome_scale_factor(self) -> float:
        """paper genome size / scaled genome size — collision-driven counts
        (spurious seed hits in the unfiltered baseline) grow with genome
        size; used to extrapolate the uncapped hit counter."""
        return self.paper_genome_len / self.genome_len


DATASETS: Dict[str, DatasetSpec] = {
    "D1": DatasetSpec("D1", "SARS-CoV-2", 29_903, 29_903, 1_382_016,
                      594e6, 11e9, 128, large=False, seed=11),
    "D2": DatasetSpec("D2", "E. coli", 400_000, 5_000_000, 353_317,
                      2_365e6, 27e9, 128, large=False, seed=12),
    "D3": DatasetSpec("D3", "Yeast", 600_000, 12_000_000, 49_989,
                      380e6, 39e9, 96, large=False, seed=13),
    "D4": DatasetSpec("D4", "Green Algae", 1_000_000, 111_000_000, 29_933,
                      609e6, 74e9, 96, large=True, seed=14),
    "D5": DatasetSpec("D5", "Human HG001", 2_000_000, 3_117_000_000, 269_507,
                      1_584e6, 39e9, 64, large=True, seed=15),
}


def config_for(spec: DatasetSpec, base: MarsConfig = MarsConfig()) -> MarsConfig:
    """Dataset-dependent thresholds (Section 5.1): (freq, vote, window) =
    (2000,5,256) small / (20000,2,256) large, scaled to our genome sizes.
    The scaled freq thresholds keep the same *fraction* of the index as the
    paper's absolute values do at paper scale."""
    if spec.large:
        return base.replace(thresh_freq=24, thresh_voting=2)
    return base.replace(thresh_freq=12, thresh_voting=4)


def build(spec: DatasetSpec, cfg: MarsConfig, signal_len: int = 1024):
    """The dataset's synthetic reference and its ``bench_reads`` reads."""
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    reads = simulate.sample_reads(ref, spec.bench_reads,
                                  signal_len=signal_len,
                                  seed=spec.seed + 1, junk_frac=0.08)
    return ref, reads
