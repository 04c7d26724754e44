"""The paper's evaluation from the port: one module per table or figure
(``run.py`` prints them all), the serving calibration and the cost
models' pinned agreement gates (``bench_sim.py``).

Each module's numbers equal the JAX package's ``benchmarks/`` bit for bit
over the same pipeline records.  Table 3's ``us_per_call`` is the time to
obtain a record on the device; every other figure is an output of the
cost models, not a time measured on that device.
"""
