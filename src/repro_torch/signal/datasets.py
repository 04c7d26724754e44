"""Dataset registry mirroring the paper's Table 2 (scaled for CPU).

The paper evaluates five real datasets (SARS-CoV-2 .. human HG001).  Our
reproduction generates synthetic equivalents: the genome LENGTH is scaled,
while `paper_*` fields keep the original magnitudes.
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

