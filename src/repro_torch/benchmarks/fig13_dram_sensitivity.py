"""Paper Fig. 13: MARS runtime sensitivity to SSD-internal DRAM size
(2/4/8 GB).  Paper: ~1.70x average speedup per doubling.

``model`` routes the sweep through the unified ``core/costmodel.py``
interface (closed forms vs the discrete-event in-storage simulator)."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import costmodel
from repro_torch.signal import datasets


def run(emit, model="analytic", device=None) -> None:
    m = costmodel.get_model(model)
    for ds in datasets.DATASETS:
        w = common.workload_for(ds, "ms_fixed", device)
        sens = m.dram_sensitivity(w)
        t2, t4, t8 = (sens[2 << 30], sens[4 << 30], sens[8 << 30])
        emit(common.csv_line(
            f"fig13/{ds}", t4 * 1e6,
            f"t_2GB={t2:.2f}s;t_4GB={t4:.2f}s;t_8GB={t8:.2f}s;"
            f"speedup_2to4={t2/t4:.2f};4to8={t4/t8:.2f};paper_avg=1.70"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv, model=True)


if __name__ == "__main__":
    main()
