"""The dry-run golden from the JAX package, for hosts without JAX.

``jax_dryrun_golden.json`` holds, under ``cells``, every cell of the JAX
package's dry run (``repro.launch.dryrun.lower_cell``: the ten
architectures x four shapes on the single (16, 16) and the multi-pod
(2, 16, 16) mesh in the 2d layout, and mars-rsga ``map_8k`` on both),
keyed ``{arch}__{shape}__{mesh}`` like the launcher's files, each the
JAX ``CellResult.to_dict()``: ``chips``, ``status`` and ``note`` (a skip's
reason), ``tokens``, ``model_flops`` and its basis, the HLO counts
(``flops_per_device``, ``bytes_per_device``, ``wire_bytes_per_device``,
``collective_detail``), ``peak_memory_per_device`` from XLA's
``memory_analysis``, and the roofline fields derived on the TPU row
(``t_compute``, ``t_memory``, ``t_collective``, ``bottleneck``,
``useful_flops_ratio``, ``roofline_fraction``, ``suggestion``, the
global flops and bytes).  ``source`` says how the cells were lowered:
JAX's ``make_mesh`` builds Explicit axes, which the model refuses, so the
golden's script swaps in a mesh of Auto axes.

The dry run's parity rule for ``flops_per_device`` (``ROADMAP.md``) is
measured against these cells (``tests/torch_dryrun_cases.py
--deviations --write``): ``flops_ratio`` holds the port's meta-device
count over the JAX cell's HLO count on every ``ok`` LM cell.  A cell's
ratio lies within ``flops_tolerance`` (a factor: [1/t, t]), or the cell is
in ``flops_explained`` with the products where the two counts part, traced
by ``--trace`` (a product that GSPMD replicates and the port splits, or
the reverse); an explained cell is pinned to its measured ratio within
``PIN`` (``cell_bounds``), not bounded by a wider tolerance.  What the
port holds exactly against the golden: the cell list and names,
``chips``, skips and notes, ``tokens``, ``model_flops`` and basis, and the
TPU row's derived fields from the cell's own inputs.

``tests/torch_dryrun_cases.py`` writes the file; the tests only read it.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional, Tuple

PATH = pathlib.Path(__file__).resolve().parent / "jax_dryrun_golden.json"
# port / JAX flops a device within [1/t, t]: the largest deviation of the
# cells no traced cause explains, 1/0.7540 (h2o-danube-1.8b train_4k),
# rounded up (PERF.md §6)
FLOPS_TOLERANCE = 1.33
PIN = 1e-2          # an explained cell: its measured ratio within 1%


def load() -> Dict:
    return json.loads(PATH.read_text())


def cell_bounds(key: str, gold: Optional[Dict] = None) -> Tuple[float, float]:
    """The (lo, hi) the port's flops ratio of cell ``key`` must lie in."""
    gold = gold or load()
    if key in gold["flops_explained"]:
        r = gold["flops_ratio"][key]
        return r * (1 - PIN), r * (1 + PIN)
    t = gold["flops_tolerance"]
    return 1 / t, t
