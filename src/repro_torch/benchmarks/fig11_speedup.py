"""Paper Fig. 11: end-to-end speedup of every evaluated system over RH2.

Each system's latency is modeled from the workload measured in its OWN
pipeline mode (rh2 for RH2/BC, ms_float for MS-CPU_Float, ms_fixed for the
hardware systems).

``model`` ("analytic" or "sim") selects the performance backend through
the unified ``core/costmodel.py`` interface: the closed forms (default) or
the discrete-event in-storage simulator for the MARS path (host baselines
are analytic either way — see costmodel docstring)."""
from __future__ import annotations

import statistics

from repro_torch.benchmarks import common
from repro_torch.core import costmodel, ssd_model
from repro_torch.signal import datasets

MODE_FOR = {"BC": "rh2", "RH2": "rh2", "MS-CPU_Float": "ms_float",
            "MS-CPU_Fixed": "ms_fixed", "MS-EXT": "ms_fixed",
            "MS-SIMDRAM": "ms_fixed", "GenPIP": "rh2",
            "MS-SmartSSD": "ms_fixed", "MARS": "ms_fixed"}

PAPER_AVG = {"MARS/RH2": 28.0, "MARS/BC": 93.0, "MARS/GenPIP": 40.0,
             "MARS/MS-EXT": 3.1, "MARS/MS-SIMDRAM": 21.4}


def results(model="analytic", device=None):
    m = costmodel.get_model(model)
    rates = common.calibrated_host(device)
    out = {}
    for ds in datasets.DATASETS:
        row = {}
        for system in ssd_model.SYSTEMS:
            w = common.workload_for(ds, MODE_FOR[system], device)
            row[system] = m.system_latency_energy(system, w, rates)
        out[ds] = row
    return out


def run(emit, model="analytic", device=None) -> None:
    res = results(model, device)
    ratios = {k: [] for k in PAPER_AVG}
    for ds, row in res.items():
        rh2 = row["RH2"]["total"]
        parts = [f"{s}={rh2/row[s]['total']:.1f}x"
                 for s in ssd_model.SYSTEMS if s != "RH2"]
        emit(common.csv_line(f"fig11/{ds}", row["MARS"]["total"] * 1e6,
                             ";".join(parts)))
        m = row["MARS"]["total"]
        ratios["MARS/RH2"].append(rh2 / m)
        ratios["MARS/BC"].append(row["BC"]["total"] / m)
        ratios["MARS/GenPIP"].append(row["GenPIP"]["total"] / m)
        ratios["MARS/MS-EXT"].append(row["MS-EXT"]["total"] / m)
        ratios["MARS/MS-SIMDRAM"].append(row["MS-SIMDRAM"]["total"] / m)
    for k, vals in ratios.items():
        emit(common.csv_line(
            f"fig11/avg/{k}", 0.0,
            f"ours={statistics.mean(vals):.1f}x;paper={PAPER_AVG[k]:.1f}x"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv, model=True)


if __name__ == "__main__":
    main()
