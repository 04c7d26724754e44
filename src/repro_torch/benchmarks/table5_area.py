"""Paper Table 5: area per MARS component (as published; Synopsys DC is not
re-run — the table is the paper's own, checked for internal consistency)."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import ssd_model


def run(emit, device=None) -> None:
    """``device`` is unused: the table reads no pipeline record."""
    total_dram = 0.0
    total_ctrl = 0.0
    for name, row in ssd_model.area_table().items():
        emit(common.csv_line(
            f"table5/{name}", 0.0,
            f"instances={row['instances']};per_unit_mm2={row['per_unit']};"
            f"total_mm2={row['total']:.3f}"))
        if name in ("Arithmetic", "Querying"):
            total_dram += row["total"]
        else:
            total_ctrl += row["total"]
    emit(common.csv_line(
        "table5/summary", 0.0,
        f"dram_overhead_mm2={total_dram:.2f};paper=16.78;"
        f"controller_mm2={total_ctrl:.2f};ssd_area_budget_mm2=6400"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv)


if __name__ == "__main__":
    main()
