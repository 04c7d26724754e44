"""Paper Fig. 5: RawHash2 runtime breakdown (I/O, event detection, seeding,
chaining) per dataset, from the calibrated host model over measured
workloads."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import ssd_model
from repro_torch.signal import datasets


def run(emit, device=None) -> None:
    rates = common.calibrated_host(device)
    for ds in datasets.DATASETS:
        w = common.workload_for(ds, "rh2", device)
        t = ssd_model.host_latency(w, rates)
        tot = t["total"]
        paper = common.FIG5_FRACTIONS[ds]
        emit(common.csv_line(
            f"fig5/{ds}", tot * 1e6,
            f"io={t['io']/tot:.2f};event={t['event']/tot:.2f};"
            f"seed={t['seed']/tot:.2f};chain={t['chain']/tot:.2f};"
            f"paper=io{paper[0]:.2f}/ev{paper[1]:.2f}/"
            f"se{paper[2]:.2f}/ch{paper[3]:.2f}"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv)


if __name__ == "__main__":
    main()
