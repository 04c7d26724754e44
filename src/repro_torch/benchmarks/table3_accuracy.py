"""Paper Table 3: mapping accuracy of RH2 / MS-CPU_Fixed / MS-CPU_Float
across the five datasets (measured end-to-end on the real pipeline)."""
from __future__ import annotations

import time

from repro_torch.benchmarks import common
from repro_torch.signal import datasets

# paper Table 3 F1 values for qualitative comparison
PAPER_F1 = {
    ("D1", "rh2"): 0.9267, ("D1", "ms_fixed"): 0.9803, ("D1", "ms_float"): 0.9867,
    ("D2", "rh2"): 0.9282, ("D2", "ms_fixed"): 0.9712, ("D2", "ms_float"): 0.9753,
    ("D3", "rh2"): 0.9079, ("D3", "ms_fixed"): 0.9588, ("D3", "ms_float"): 0.9603,
    ("D4", "rh2"): 0.8139, ("D4", "ms_fixed"): 0.9141, ("D4", "ms_float"): 0.9354,
    ("D5", "rh2"): 0.5582, ("D5", "ms_fixed"): 0.7300, ("D5", "ms_float"): 0.7612,
}


def run(emit, device=None) -> None:
    for ds in datasets.DATASETS:
        for mode in ("rh2", "ms_float", "ms_fixed"):
            t0 = time.time()
            rec = common.pipeline_run(ds, mode, device=device)
            us = (time.time() - t0) * 1e6
            a = rec["accuracy"]
            paper = PAPER_F1.get((ds, mode), float("nan"))
            emit(common.csv_line(
                f"table3/{ds}/{mode}", us,
                f"P={a['precision']:.3f};R={a['recall']:.3f};"
                f"F1={a['f1']:.3f};paper_F1={paper:.3f}"))


def main(argv=None) -> None:
    common.main(run, __doc__, argv)


if __name__ == "__main__":
    main()
