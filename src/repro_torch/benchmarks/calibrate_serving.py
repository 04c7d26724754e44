"""Calibrate the analytic serving-latency model against measured
``ServeDriver`` virtual-time traces.

``ssd_model.serving_latency`` predicts p50/p99 sojourn from an M/D/c
queueing core; ``ServeDriver`` (core/server.py) *measures* per-read
sojourn on its virtual clock (every dispatched chunk costs ``chunk_cost``
and completes up to ``chunk`` reads).  ``serving_latency_virtual`` maps
the same core onto the driver's clock — c = chunk parallel servers of
deterministic service ``chunk_cost`` — so the two are directly
comparable: run a Poisson arrival trace at a fraction of chunk capacity
through the real pipeline, pool the admitted per-read latencies, and
compare percentiles against the model.  Every number is in virtual
units: the device the pipeline runs on decides no number, only which
reads map.

    PYTHONPATH=src python -m repro_torch.benchmarks.calibrate_serving \
        [--device cpu] [--model sim]
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np


def measure_trace(mapper, chunk: int, offered_load: float, n_reads: int,
                  n_streams: int = 4, chunk_cost: float = 1.0,
                  seed: int = 0) -> Dict[str, float]:
    """Serve one Poisson arrival trace (rate ``offered_load`` reads per
    virtual unit) through a fresh ``ServeDriver`` over ``mapper`` and pool
    the admitted finite per-read virtual latencies across streams.

    Returns measured p50/p99/mean plus the trace size.  Deterministic
    given ``seed``: arrivals, stream assignment and the driver's packing
    are all reproducible.
    """
    from repro_torch.core.server import ServeDriver

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / offered_load, n_reads))
    signals = mapper_signals(mapper, n_reads, seed + 1)
    trace = [(float(arrivals[k]), f"s{k % n_streams}", signals[k])
             for k in range(n_reads)]
    sd = ServeDriver(mapper, chunk=chunk, chunk_cost=chunk_cost)
    sd.serve_trace(trace)
    lat = np.asarray([l for st in sd._streams.values()
                      for l, a in zip(st.latency, st.admitted)
                      if a and math.isfinite(l)], np.float64)
    return dict(p50=float(np.percentile(lat, 50)),
                p99=float(np.percentile(lat, 99)),
                mean=float(lat.mean()), n=int(lat.size),
                n_chunks=sd.n_chunks)


def mapper_signals(mapper, n_reads: int, seed: int) -> np.ndarray:
    """Reads shaped for ``mapper.cfg`` from the shared simulator (sampled
    against an arbitrary small reference — the latency calibration only
    needs realistic per-chunk work, not mapping accuracy)."""
    from repro_torch.signal import simulate
    ref = simulate.make_reference(4_000, seed=seed)
    return simulate.sample_reads(ref, n_reads,
                                 signal_len=mapper.cfg.signal_len,
                                 seed=seed + 1).signals


def calibrate(mapper, chunk: int = 8, load_fracs: Sequence[float] =
              (0.3, 0.5, 0.7), n_reads: int = 96, chunk_cost: float = 1.0,
              seed: int = 0, model="analytic"):
    """Measured-vs-modeled rows, one per offered-load fraction of the
    driver's chunk capacity (chunk/chunk_cost reads per virtual unit).
    ``model`` selects the costmodel backend the measured trace is compared
    against (analytic M/D/c closed form or the discrete-event serving
    simulator)."""
    from repro_torch.core import costmodel

    cm = costmodel.get_model(model)
    capacity = chunk / chunk_cost
    rows = []
    for f in load_fracs:
        load = f * capacity
        m = measure_trace(mapper, chunk, load, n_reads,
                          chunk_cost=chunk_cost, seed=seed)
        model = cm.serving_virtual(chunk, load, chunk_cost)
        rows.append(dict(load_frac=f, offered_load=load,
                         measured_p50=m["p50"], model_p50=model["p50"],
                         measured_p99=m["p99"], model_p99=model["p99"],
                         measured_mean=m["mean"], model_mean=model["mean"],
                         p50_ratio=model["p50"] / m["p50"],
                         n_reads=m["n"], n_chunks=m["n_chunks"],
                         saturated=model["saturated"]))
    return rows


def default_mapper(hash_bits: int = 12, ref_events: int = 8_000,
                   seed: int = 3, device=None, use_kernels: bool = False):
    """An ``ms_fixed`` Mapper over a small synthetic reference, on CUDA
    unless ``device`` says otherwise."""
    from repro_torch.core import MarsConfig, Mapper, build_index
    from repro_torch.signal import simulate

    cfg = MarsConfig(hash_bits=hash_bits).with_mode("ms_fixed")
    ref = simulate.make_reference(ref_events, seed=seed)
    idx = build_index(ref.events_concat, ref.n_events, cfg)
    return Mapper(idx, cfg, use_kernels=use_kernels,
                  device="cuda" if device is None else device)


def main(argv=None) -> None:
    import argparse

    from repro_torch.core import costmodel
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="analytic",
                    choices=sorted(costmodel.MODELS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = calibrate(default_mapper(device=args.device), model=args.model)
    hdr = ("load  measured_p50  model_p50  ratio   measured_p99  model_p99"
           "   chunks")
    print(hdr)
    for r in rows:
        print(f"{r['load_frac']:.2f}  {r['measured_p50']:12.3f}  "
              f"{r['model_p50']:9.3f}  {r['p50_ratio']:5.2f}  "
              f"{r['measured_p99']:12.3f}  {r['model_p99']:9.3f}  "
              f"{r['n_chunks']:7d}")


if __name__ == "__main__":
    main()
