"""Discrete-event in-storage simulator (the `sim` CostModel backend).

Three layers:

  * ``engine``   — the deterministic event heap + ``Component`` resource
    (k servers, FIFO queue, per-component busy/idle/queue-delay stats);
  * ``ssdsim``   — the MARS SSD model built on it: flash channels x dies
    with per-die busy windows, controller-sequenced PNM compute units
    (AU/QU/sorter), internal-DRAM bandwidth accounting, host link;
  * ``serve_sim`` — virtual-time serving twins: replay of ``ServeDriver``
    chunk-event traces and event-driven M/D/c / batch-server queues.

The analytic closed forms in ``core/ssd_model.py`` stay the calibration
oracle: degenerate (no-contention) configs must agree to <1%
(tests/test_sim.py, scripts/bench_sim.py); contended configs add the
per-component breakdown the closed forms cannot express.

The JAX package's ``repro.core.sim``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from repro_torch.core.sim.engine import Component, Simulator  # noqa: F401
from repro_torch.core.sim.ssdsim import (simulate_array_latency,  # noqa: F401
                                   simulate_batch,
                                   simulate_dram_sensitivity)
from repro_torch.core.sim.serve_sim import (replay_chunk_trace,  # noqa: F401
                                      simulate_serving,
                                      simulate_serving_virtual)
