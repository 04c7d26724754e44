"""RSGA serving launcher on PyTorch: multi-stream read mapping at an
offered load.

Simulates K concurrent client streams (sequencer channels / tenants)
submitting reads as a Poisson arrival trace, serves them through the
continuous-batching ``ServeDriver`` (core/server.py) over the stage
engine, and reports per-stream latency percentiles, aggregate
streams/sec + reads/sec, and — for context — the analytic multi-SSD
serving percentiles from ``ssd_model.serving_latency`` at the same
offered load.

    PYTHONPATH=src python -m repro_torch.launch.serve_rsga --dataset D1 \
        --streams 8 --reads-per-stream 16 --load 0.7 --use-kernels

(`--load` is the offered load as a fraction of the measured service
capacity; >1 exercises the bounded-queue backpressure path.)  Runs on the
CUDA card unless ``--device cpu`` is given (no card and no ``--device cpu``
raises).  It prints the lines the JAX package's launcher prints, and its
reports equal that launcher's bit for bit.

Degraded-mode serving: ``--fault-plan SEED`` maps through the tiered
index (``--tiles`` host-resident tiles paged into ``--cache-slots`` device
slots, ``--cache-replicas`` more for the hottest tiles, core/tiered.py)
with a seeded ``core/faults.FaultPlan`` injected at tile page-in
(checksummed retry and backoff, in virtual time), and prints the
``[storage]`` and ``[skew]`` lines; ``--shed`` closes the admission loop
(SLO classes + saturation-aware shedding); ``--load-sweep
0.5,0.9,1.3,1.8`` serves the same trace shape at several offered loads,
printing the shed-rate vs p50/p99 curve.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, NamedTuple, Optional

import numpy as np

from repro_torch.core import (FaultPlan, Mapper, ServeDriver, SLOClass,
                              TenantBudget, build_index, costmodel,
                              ssd_model, workload)
from repro_torch.core.pipeline import check_device
from repro_torch.signal import datasets, simulate


def build_trace(signals: np.ndarray, n_streams: int, reads_per_stream: int,
                arrival_rate: float, seed: int = 0,
                priorities=(0,), slos=None, tenants: int = 0,
                skew: float = 0.0) -> list:
    """A Poisson arrival trace over ``n_streams`` streams: each stream
    submits ``reads_per_stream`` single-read requests; inter-arrival
    times are exponential with the given aggregate rate (virtual-time
    units = chunk services).  With ``slos`` each stream is tagged with
    the SLO class name ``slos[stream % len(slos)]`` (priority/deadline
    come from the class).

    ``tenants`` > 0 assigns stream k to tenant ``t{k % tenants}`` (rows
    grow the tenant column ``ServeDriver.serve_trace`` binds on).
    ``skew`` > 0 draws each read's owning stream from a Zipf-like
    distribution (stream k weighted ``(k+1)**-skew``) instead of the
    balanced split, so low-numbered streams — and their tenants — hog
    the trace; 0 keeps the legacy balanced trace bit-exactly."""
    rng = np.random.default_rng(seed)
    n = n_streams * reads_per_stream
    gaps = rng.exponential(1.0 / max(arrival_rate, 1e-9), n)
    times = np.cumsum(gaps)
    if skew > 0:
        p = (1.0 + np.arange(n_streams)) ** -float(skew)
        owners = rng.choice(n_streams, size=n, p=p / p.sum())
    else:
        owners = rng.permutation(np.repeat(np.arange(n_streams),
                                           reads_per_stream))
    trace = []
    for k in range(n):
        sid = f"s{owners[k]}"
        sig = signals[k % signals.shape[0]]
        tenant = f"t{int(owners[k]) % tenants}" if tenants else None
        if tenants:
            prio = (None if slos is not None
                    else int(priorities[owners[k] % len(priorities)]))
            slo = None if slos is None else slos[int(owners[k]) % len(slos)]
            trace.append((float(times[k]), sid, sig, prio, None, slo,
                          tenant))
        elif slos is None:
            trace.append((float(times[k]), sid, sig,
                          int(priorities[owners[k] % len(priorities)])))
        else:
            trace.append((float(times[k]), sid, sig, None, None,
                          slos[int(owners[k]) % len(slos)]))
    return trace


# The two-tier serving contract the --shed path demonstrates: latency-
# sensitive streams are never shed; bulk streams absorb the overload.
SHED_CLASSES = (SLOClass("gold", priority=1, deadline=64.0, sheddable=False),
                SLOClass("best_effort", priority=0))


class Served(NamedTuple):
    """One launcher run: the driver after ``serve_trace`` (its events,
    virtual clock and counters), its per-stream reports, the arrival
    trace, the host-clock seconds ``serve_trace`` took, the config, the
    simulated reads, the index and the driver's keyword arguments."""
    driver: ServeDriver
    reports: Dict
    trace: list
    wall_s: float
    cfg: object
    reads: object
    index: object
    serve_kw: Dict


def main(argv=None):
    """The launcher: prints its report lines and returns the per-stream
    reports (None for ``--load-sweep``)."""
    served = run(argv)
    return None if served is None else served.reports


def run(argv=None) -> Optional[Served]:
    """``main``'s run, returning the whole ``Served`` record (None for
    ``--load-sweep``)."""
    ap = argparse.ArgumentParser(
        description="MARS RSGA serving launcher: continuous-batching "
                    "multi-stream read mapping (ServeDriver).")
    ap.add_argument("--dataset", default="D1",
                    choices=sorted(datasets.DATASETS))
    ap.add_argument("--mode", default="ms_fixed",
                    choices=("rh2", "ms_float", "ms_fixed"))
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--reads-per-stream", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--load", type=float, default=0.7,
                    help="offered load as a fraction of service capacity "
                         "(1 chunk per virtual time unit)")
    ap.add_argument("--max-queue", type=int, default=4096,
                    help="bounded ready queue (reads); overload beyond it "
                         "is rejected by priority")
    ap.add_argument("--early-term", action="store_true",
                    help="realtime prefix ladder: confident early reads "
                         "free their slot before full length")
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--model", default="analytic",
                    choices=sorted(costmodel.MODELS),
                    help="performance backend for the array report and the "
                         "shed controller (core/costmodel.py): closed "
                         "forms or the discrete-event in-storage simulator")
    ap.add_argument("--n-ssds", type=int, default=4,
                    help="drives in the multi-SSD array report")
    ap.add_argument("--n-failed", type=int, default=0, choices=(0, 1),
                    help="degraded analytic array: one drive lost, index "
                         "rebalanced N -> N/2 (repartition_index)")
    ap.add_argument("--fault-plan", type=int, default=None, metavar="SEED",
                    help="serve through the tiered storage path with a "
                         "seeded FaultPlan (read errors + corruption + "
                         "latency spikes) injected at tile page-in")
    ap.add_argument("--tiles", type=int, default=8,
                    help="host-resident index tiles (with --fault-plan)")
    ap.add_argument("--cache-slots", type=int, default=4,
                    help="device tile-cache slots (with --fault-plan)")
    ap.add_argument("--cache-replicas", type=int, default=0,
                    help="pinned replica slots for the hottest tiles "
                         "(with --fault-plan): traffic-driven, result-"
                         "invisible; the [model] line prices the win")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="assign streams round-robin to N tenants with "
                         "fair-share shed budgets (capacity/N reads per "
                         "virtual unit each) and print the per-tenant "
                         "report; 0 = tenant-free legacy driver")
    ap.add_argument("--skew", type=float, default=0.0, metavar="ALPHA",
                    help="Zipf exponent skewing trace volume toward low-"
                         "numbered streams/tenants (0 = balanced); with "
                         "--tenants the hot tenant overruns its budget "
                         "and is shed first")
    ap.add_argument("--shed", action="store_true",
                    help="closed-loop admission: SLO classes (gold / "
                         "best_effort) + saturation-aware load shedding")
    ap.add_argument("--shed-window", type=float, default=8.0)
    ap.add_argument("--load-sweep", default=None, metavar="L1,L2,...",
                    help="serve the trace shape at several offered loads "
                         "and print the shed-rate vs p50/p99 curve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to map on (default cuda; 'cpu' runs "
                         "the plain torch versions of the kernels)")
    args = ap.parse_args(argv)
    check_device(args.device)

    spec = datasets.DATASETS[args.dataset]
    cfg = datasets.config_for(spec).with_mode(args.mode)
    t0 = time.time()
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    n_reads = args.streams * args.reads_per_stream
    rs = simulate.sample_reads(ref, n_reads, signal_len=cfg.signal_len,
                               seed=spec.seed + 1, junk_frac=0.08)
    index = build_index(ref.events_concat, ref.n_events, cfg)
    print(f"[setup] genome={spec.genome_len}bp streams={args.streams} "
          f"reads/stream={args.reads_per_stream} "
          f"index={index.n_entries} entries {time.time()-t0:.1f}s")

    def make_mapper():
        if args.fault_plan is None:
            return Mapper(index, cfg, use_kernels=args.use_kernels,
                          device=args.device)
        plan = FaultPlan(seed=args.fault_plan, p_read_error=0.02,
                         p_corrupt=0.02, p_latency=0.05, latency_units=2.0)
        return Mapper(index, cfg, backend="tiered", tiles=args.tiles,
                      cache_slots=args.cache_slots,
                      cache_replicas=args.cache_replicas, fault_plan=plan,
                      device=args.device)

    slos = None
    serve_kw = dict(chunk=args.chunk, max_queue=args.max_queue,
                    early_term=args.early_term, cost_model=args.model)
    if args.shed:
        serve_kw.update(shed=True, shed_window=args.shed_window,
                        slo_classes=SHED_CLASSES)
        slos = [c.name for c in SHED_CLASSES]
    if args.tenants:
        # fair share of service capacity (`chunk` reads per virtual unit)
        serve_kw.update(tenant_budgets=tuple(
            TenantBudget(f"t{i}", rate=args.chunk / args.tenants)
            for i in range(args.tenants)))

    def run_once(load, verbose=True):
        # offered load in reads per virtual time unit: one unit serves one
        # chunk, i.e. `chunk` reads at capacity
        mapper = make_mapper()
        trace = build_trace(rs.signals, args.streams, args.reads_per_stream,
                            arrival_rate=load * args.chunk, seed=args.seed,
                            slos=slos, tenants=args.tenants, skew=args.skew)
        sd = ServeDriver(mapper, **serve_kw)
        t0 = time.time()
        reports = sd.serve_trace(trace)
        wall = time.time() - t0
        if verbose:
            print(f"[serve] {n_reads} reads over {args.streams} streams in "
                  f"{wall:.2f}s wall ({n_reads/max(wall, 1e-9):.1f} reads/s, "
                  f"{args.streams/max(wall, 1e-9):.2f} streams/s); "
                  f"{sd.n_chunks} chunks, {sd.n_pad_rows} pad rows, "
                  f"virtual makespan {sd.clock:.1f}")
            for sid in sorted(reports, key=lambda s: int(s[1:])):
                r = reports[sid]
                print(f"  {sid}: reads={r.n_reads} mapped={r.n_mapped} "
                      f"rejected={r.n_rejected} shed={r.n_shed} "
                      f"latency p50={r.p50_latency:.2f} "
                      f"p99={r.p99_latency:.2f} mean={r.mean_latency:.2f} "
                      f"(virtual units)")
            if args.shed:
                for name, c in sorted(sd.class_report().items(),
                                      key=lambda kv: str(kv[0])):
                    print(f"  [class {name}] reads={c.n_reads} "
                          f"mapped={c.n_mapped} shed={c.n_shed} "
                          f"p50={c.p50_latency:.2f} p99={c.p99_latency:.2f}")
            if args.tenants:
                for name, r in sorted(sd.tenant_report().items(),
                                      key=lambda kv: str(kv[0])):
                    tokens = (sd.tenant_tokens(name)
                              if name in sd.tenant_budgets else math.nan)
                    print(f"  [tenant {name}] reads={r.n_reads} "
                          f"mapped={r.n_mapped} shed={r.n_shed} "
                          f"over_budget={r.n_over_budget} "
                          f"p50={r.p50_latency:.2f} p99={r.p99_latency:.2f} "
                          f"tokens_left={tokens:.1f}")
            if mapper.cache is not None:
                c = mapper.cache
                print(f"[storage] tiles paged={c.misses} retries={c.retries} "
                      f"corruptions healed={c.corruptions} "
                      f"vtime lost to backoff={c.vtime_penalty:.1f}")
        return sd, reports, trace, wall

    if args.load_sweep:
        loads = [float(x) for x in args.load_sweep.split(",") if x]
        print(f"[sweep] shed-rate vs latency over loads {loads}")
        print("  load   shed%   rejected%   p50     p99")
        for load in loads:
            sd, reports, _, _ = run_once(load, verbose=False)
            lat = np.asarray([l for st in sd._streams.values()
                              for l, a in zip(st.latency, st.admitted)
                              if a and math.isfinite(l)])
            total = sum(r.n_reads for r in reports.values())
            shed = sum(r.n_shed for r in reports.values())
            rej = sum(r.n_rejected for r in reports.values())
            p50 = float(np.percentile(lat, 50)) if lat.size else math.nan
            p99 = float(np.percentile(lat, 99)) if lat.size else math.nan
            print(f"  {load:5.2f}  {100*shed/max(total,1):5.1f}  "
                  f"{100*rej/max(total,1):9.1f}  {p50:6.2f}  {p99:6.2f}")
        return None

    sd, reports, trace, wall = run_once(args.load)

    # modeled multi-SSD serving percentiles at the matching offered load,
    # through the selected costmodel backend (--model)
    w = workload.from_counters(sd.counters, cfg, index_bytes=index.nbytes)
    if w.n_reads:
        cm = costmodel.get_model(args.model)
        arr = ssd_model.SSDArrayConfig(n_ssds=args.n_ssds,
                                       n_failed=args.n_failed)
        batch = cm.array_latency(w, arr)
        cap = w.n_reads / batch["total"]          # reads/s at saturation
        sv = cm.serving(w, offered_load=args.load * cap, arr=arr)
        tag = f"{args.n_ssds}-SSD array [{cm.name}]"
        if args.n_failed:
            tag += f" (DEGRADED: {arr.n_serving} serving)"
        print(f"[model] {tag}: batch={batch['total']*1e3:.2f}ms "
              f"service={sv['service']*1e6:.1f}us/read rho={sv['utilization']:.2f} "
              f"p50={sv['p50']*1e6:.1f}us p99={sv['p99']*1e6:.1f}us"
              + (" SATURATED" if sv["saturated"] else ""))
        cache = sd.mapper.cache
        if cache is not None:
            # price the measured tile-traffic skew + the replication win
            sk = cm.skewed_serving(w, cache.tile_traffic(),
                                   replicas=cache.n_replicas)
            print(f"[skew] tile-traffic imbalance x{sk['factor']:.2f}; "
                  f"{cache.n_replicas} replica(s) -> "
                  f"x{sk['factor_replicated']:.2f}; modeled replication "
                  f"speedup {sk['replication_speedup']:.2f}x "
                  f"(replica loads={cache.replica_loads})")
    return Served(driver=sd, reports=reports, trace=trace, wall_s=wall,
                  cfg=cfg, reads=rs, index=index, serve_kw=serve_kw)


if __name__ == "__main__":
    main()
