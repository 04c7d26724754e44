"""Paper Fig. 6: I/O share of end-to-end runtime as seeding+chaining are
accelerated by 10%..100% — the motivation study for in-storage processing."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import ssd_model
from repro_torch.signal import datasets


def run(emit, device=None) -> None:
    rates = common.calibrated_host(device)
    for ds in datasets.DATASETS:
        w = common.workload_for(ds, "rh2", device)
        t = ssd_model.host_latency(w, rates)
        shares = []
        for red in (0.0, 0.5, 0.9, 1.0):
            acc = t["seed"] * (1 - red) + t["chain"] * (1 - red)
            total = t["io"] + t["event"] + acc
            shares.append(t["io"] / total)
        emit(common.csv_line(
            f"fig6/{ds}", t["total"] * 1e6,
            f"io_share_0%={shares[0]:.2f};50%={shares[1]:.2f};"
            f"90%={shares[2]:.2f};100%={shares[3]:.2f}"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv)


if __name__ == "__main__":
    main()
