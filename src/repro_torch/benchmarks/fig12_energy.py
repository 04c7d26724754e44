"""Paper Fig. 12: energy reduction of each system over RH2.

``model`` selects the costmodel backend (sim charges static power over
the simulated runtime; dynamic energies are shared)."""
from __future__ import annotations

import statistics

from repro_torch.benchmarks import common
from repro_torch.benchmarks.fig11_speedup import results
from repro_torch.core import ssd_model

PAPER_AVG = {"MARS/RH2": 79.4, "MARS/BC": 427.0, "MARS/GenPIP": 72.0,
             "MS-EXT/RH2": 22.3}


def run(emit, model="analytic", device=None) -> None:
    res = results(model, device)
    acc = {k: [] for k in PAPER_AVG}
    for ds, row in res.items():
        rh2 = row["RH2"]["energy"]
        parts = [f"{s}={rh2/row[s]['energy']:.1f}x"
                 for s in ssd_model.SYSTEMS if s != "RH2"]
        emit(common.csv_line(f"fig12/{ds}", row["MARS"]["energy"], ";".join(parts)))
        acc["MARS/RH2"].append(rh2 / row["MARS"]["energy"])
        acc["MARS/BC"].append(row["BC"]["energy"] / row["MARS"]["energy"])
        acc["MARS/GenPIP"].append(row["GenPIP"]["energy"] / row["MARS"]["energy"])
        acc["MS-EXT/RH2"].append(rh2 / row["MS-EXT"]["energy"])
    for k, vals in acc.items():
        emit(common.csv_line(
            f"fig12/avg/{k}", 0.0,
            f"ours={statistics.mean(vals):.1f}x;paper={PAPER_AVG[k]:.1f}x"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv, model=True)


if __name__ == "__main__":
    main()
