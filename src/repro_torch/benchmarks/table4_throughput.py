"""Paper Table 4: MARS throughput (bp/s) vs real-time requirements
(single nanopore 450 bp/s; full MinION 230,400 bp/s), modeled by the
analytic SSD model over the measured workloads."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import ssd_model
from repro_torch.signal import datasets

PAPER = dict(D1=46_655_128, D2=5_274_148, D3=1_202_660, D4=1_277_764,
             D5=286_728)
MINION = 230_400


def run(emit, device=None) -> None:
    for ds, spec in datasets.DATASETS.items():
        w = common.workload_for(ds, "ms_fixed", device)
        lat = ssd_model.system_latency_energy("MARS", w)
        bases = spec.paper_bases
        tp = bases / lat["total"]
        emit(common.csv_line(
            f"table4/{ds}", lat["total"] * 1e6,
            f"bp_per_s={tp:.0f};x_minion={tp/MINION:.1f};"
            f"paper_bp_per_s={PAPER[ds]};ratio_to_paper={tp/PAPER[ds]:.2f}"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv)


if __name__ == "__main__":
    main()
