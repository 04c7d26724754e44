#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device    — the card's name, and its name and power limit as nvidia-smi
               reports them;
2. build     — compile the CUDA kernels of ``src/repro_torch/csrc`` (nvcc,
               one process per source) and print ptxas's register and
               shared-memory summary;
3. map       — the main path (``ms_fixed``): end to end through
               ``Mapper(..., use_kernels=True)`` and the streaming driver at
               D1 (29,903 bases) and D5 (2,000,000 bases), 4096 reads in
               chunks of 512.  Launch counts and the chaining gate's route
               counts (``pipeline.CHAIN_ROUTES``) are zeroed just before
               each run and read just after; the path's kernels
               (cheap_fused, bitonic_sort, chain_dp) must have launched and
               the per-stage ones must not, and the routes each chunk took
               are printed.  The first chunk's outputs and counters must
               equal the plain path's on the card; reads/s, F1 and peak
               device memory are reported;
   float     — the same runs for the float modes ``ms_float`` and ``rh2``
               (per-stage cheap phase: the reference detection with the
               in-order segment_sum helper, the two pluto_lookup gathers,
               bitonic_sort and chain_dp; cheap_fused and event_detect must
               not launch); the plain path they are held against
               launches no kernel (its segment sums are the plain loop);
               the cheap phase of chunk 0's first 64 reads must equal the
               same program run on the CPU;
   perstage  — ``cheap_phase(..., use_fused=False)`` under the kernels plan
               (event_detect and both lookups) on D1's and D5's first chunk
               must equal the fused kernel and the reference plan;
4. routes    — one chunk per route through the chaining gate (full or
               compacted chunk, at the 64 and 128 ladder widths and at the
               full E*H = 3072; a chunk with no anchors), picked by anchor
               count; each must take its route and equal the plain path;
5. kernels   — each kernel against its plain PyTorch version on the card:
               cheap_fused and event_detect on D5's first chunk (512 reads
               of 1024 samples, E=192 events, H=16 hits), the two lookups
               on the indices D5's query issues for it, segment_sum on its
               ms_float detection, the sort and the DP on the very inputs
               each route of phase 4 gave them.  Tolerance: exact.
               Times from warmed CUDA events; ``bound_ms`` is the least time
               the card could take (bytes over 3.35 TB/s, operations over
               67 T/s scalar), from this run's inputs;
6. profile   — torch.profiler over one streamed pass at each size (and at
               D5 in each float mode): device time by kernel, the device's
               busy share of the wall time, host time by op (traces in
               ``chiprun_out/``); then the D1 runs through the launcher
               (``repro_torch.launch.map_reads --use-kernels``, ``ms_fixed``
               and ``--mode rh2``);
7. summary   — one JSON line of per-kernel results, then the last line
               ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
READS, CHUNK = 4096, 512
REPEATS = 5                     # timed passes of each end-to-end run
SLEEP_CYCLES = 50_000_000       # ~25 ms at the H100's clocks: time_ms's lead
FLOAT_MODES = ("ms_float", "rh2")
# The kernels each path launches, and those it must not.
FUSED_PATH = ("cheap_fused", "bitonic_sort", "chain_dp")
FLOAT_PATH = ("pluto_lookup", "pluto_lookup_rows", "segment_sum",
              "bitonic_sort", "chain_dp")
PERSTAGE_PATH = ("event_detect", "pluto_lookup", "pluto_lookup_rows")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` warmed calls, by CUDA
    events.  A sleep kernel holds the stream while the host enqueues the
    calls, so a call whose host side (wrapper, launch) outlasts its kernel
    is still timed back to back on the device; a plain version whose host
    work outlasts the sleep is timed as the host paces it."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean host-clock time of one call over ``reps`` warmed calls, ended
    by a synchronisation (host dispatch included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assert_equal(name: str, got, want) -> float:
    """Exact equality of two tensors (same dtype and shape); returns the max
    absolute difference (0.0)."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs()
        raise AssertionError(f"{name}: {int((got != want).sum())} elements "
                             f"differ, max abs diff {float(diff.max())}")
    return 0.0


def check_launches(label: str, launches, expected) -> None:
    """Every kernel of ``expected`` launched, every other kernel did not."""
    missing = [k for k in expected if launches[k] == 0]
    extra = [k for k, v in launches.items() if v and k not in expected]
    if missing or extra:
        raise AssertionError(f"{label}: kernels never launched {missing}, "
                             f"launched off their path {extra} "
                             f"({launches})")


def equal_cheap(label: str, got, want) -> None:
    """Exact equality of two cheap-phase results (q_pos, t_pos, hit_valid,
    counters)."""
    for n, g, w in zip(("q_pos", "t_pos", "hit_valid"), got[:3], want[:3]):
        assert_equal(f"{label} {n}", g, w)
    if set(got[3]) != set(want[3]):
        raise AssertionError(f"{label}: counter keys differ")
    for k in want[3]:
        assert_equal(f"{label} counter {k}", got[3][k], want[3][k])


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] torch: {name} (count {torch.cuda.device_count()}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return name, smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    build.lib()
    nvcc = (f"{build.BUILD_SECONDS:.1f}s" if build.BUILD_SECONDS is not None
            else "cached library")
    log(f"[build] {time.time() - t0:.1f}s (nvcc: {nvcc})")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                log(f"[build] {name}: {line.strip()}")


def make_dataset(key: str):
    from repro_torch.core import build_index
    from repro_torch.signal import datasets, simulate
    spec = datasets.DATASETS[key]
    cfg = datasets.config_for(spec).with_mode("ms_fixed")
    t0 = time.time()
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    reads = simulate.sample_reads(ref, READS, signal_len=cfg.signal_len,
                                  seed=spec.seed + 1, junk_frac=0.08)
    index = build_index(ref.events_concat, ref.n_events, cfg)
    log(f"[setup] {key}: genome {spec.genome_len} bases, {READS} reads, "
        f"index {index.n_entries} entries "
        f"({(index.bucket_start.nbytes + index.entries_packed.nbytes) / 1e6:.1f}"
        f" MB packed), {time.time() - t0:.1f}s")
    return cfg, ref, reads, index


def anchor_counts(cfg, reads, arrays, dev):
    """Each read's post-vote anchor count, from the kernels' cheap phase."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline, stages
    plan = stages.resolve_plan(cfg, stages.KERNELS)
    out = [pipeline.cheap_phase(torch.from_numpy(reads.signals[i:i + CHUNK])
                                .to(dev), arrays, cfg, plan)[3][
                                    "n_anchors_postvote"]
           for i in range(0, len(reads.signals), CHUNK)]
    return torch.cat(out).cpu().numpy().astype(np.int64)


# The routes through the chaining gate that phase_routes forces, one chunk
# each: (dataset, branch, sort width; None = the full E*H).  "full" chunks
# hold CHUNK reads with anchors (above the 384-read capacity), "compact"
# chunks CHUNK/2, "empty" none.
ROUTES = (("D1", "full", 64), ("D1", "full", 128), ("D5", "full", None),
          ("D1", "compact", 64), ("D1", "compact", 128),
          ("D5", "compact", None), ("D1", "empty", 0))


def phase_routes(data, dev):
    """Chunks of CHUNK reads, picked by their post-vote anchor counts, that
    drive each route of ROUTES through ``map_chunk`` on the kernels.  The
    reads with anchors are real reads whose largest count selects the
    width; the rest are the dataset's zero-anchor reads, topped up with
    flat signals (no events, so no anchors), in a shuffled order so the
    compacted gather and scatter-back see scattered rows.  Each chunk must
    take its route (``pipeline.CHAIN_ROUTES``) and equal the plain path on
    the card.  The sort and DP inputs each route hands the kernels are kept
    for phase_kernels, through a plan whose sort and dp primitives record
    their inputs and call the kernel wrappers."""
    import numpy as np
    import torch
    from repro_torch.core import map_chunk, pipeline, stages
    from repro_torch.core.index import index_arrays
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    from repro_torch.kernels.chain_dp import ops as dp_ops

    captured = {}

    def sort(keys):
        captured["sort"] = (keys.clone(),)
        return sort_ops.sort_rows(keys)

    def dp(q, t, v, cfg):
        captured["dp"] = (q.clone(), t.clone(), v.clone())
        return dp_ops.chain_dp(q, t, v, cfg)
    stages.register_backend("sort", "capture", sort)
    stages.register_backend("dp", "capture", dp)

    rng = np.random.default_rng(0)
    per_set = {}
    inputs, results = {}, {}
    for key, branch, width in ROUTES:
        cfg, _, reads, index = data[key]
        if key not in per_set:
            arrays = index_arrays(index, dev)
            per_set[key] = (arrays, anchor_counts(cfg, reads, arrays, dev))
            c = per_set[key][1]
            junk = c[~reads.mappable]
            dist = {"reads": len(c), "none": int((c == 0).sum()),
                    "1..64": int(((c >= 1) & (c <= 64)).sum()),
                    "65..128": int(((c >= 65) & (c <= 128)).sum()),
                    "above 128": int((c > 128).sum()),
                    "median with anchors": float(np.median(c[c > 0])),
                    "junk reads with anchors": int((junk > 0).sum()),
                    "junk reads": len(junk)}
            results[f"{key} anchor counts"] = dist
            log(f"[routes] {key} post-vote anchor counts: {dist}")
        arrays, cnt = per_set[key]
        EH = cfg.max_events * cfg.max_hits_per_seed
        lo, hi = {64: (1, 64), 128: (65, 128), None: (129, EH),
                  0: (0, 0)}[width]
        n_surv = {"full": CHUNK, "compact": CHUNK // 2, "empty": 0}[branch]
        pool = np.flatnonzero((cnt >= lo) & (cnt <= hi))
        if n_surv and not pool.size:
            raise AssertionError(f"{key}: no read with {lo}..{hi} anchors "
                                 f"to force the {branch}/{width} route")
        zero_real = reads.signals[cnt == 0][:CHUNK - n_surv]
        flat = np.full((CHUNK - n_surv - len(zero_real), cfg.signal_len),
                       np.median(reads.signals), np.float32)
        sig = np.concatenate([reads.signals[np.resize(pool, n_surv)],
                              zero_real, flat])[rng.permutation(CHUNK)]
        x = torch.from_numpy(np.ascontiguousarray(sig)).to(dev)
        plan = tuple((s, "capture" if s in ("sort", "dp") else b)
                     for s, b in stages.resolve_plan(cfg, stages.KERNELS))
        captured.clear()
        pipeline.CHAIN_ROUTES.clear()
        got = map_chunk(x, arrays, cfg, plan=plan)
        routes = dict(pipeline.CHAIN_ROUTES)
        want = map_chunk(x, arrays, cfg, use_kernels=False)
        torch.cuda.synchronize()
        w = EH if width is None else width
        expect = (("empty", 0, 0) if branch == "empty" else
                  (branch, CHUNK if branch == "full" else n_surv, w))
        if routes != {expect: 1}:
            raise AssertionError(f"{key} {branch}/{w}: chunk took {routes}, "
                                 f"expected {expect}")
        for f in ("t_start", "score", "mapped", "n_events"):
            assert_equal(f"{key} {branch}/{w} {f}", getattr(got, f),
                         getattr(want, f))
        for k in want.counters:
            assert_equal(f"{key} {branch}/{w} counter {k}", got.counters[k],
                         want.counters[k])
        label = f"{key} {branch}/{w}"
        if captured:
            inputs[label] = dict(captured)
        results[label] = dict(route=list(expect), reads_with_anchors=n_surv,
                              zero_anchor_reads=len(zero_real),
                              flat_reads=len(flat),
                              mapped=int(got.mapped.sum()))
        log(f"[routes] {label}: {n_surv} reads with {lo}..{hi} anchors, "
            f"{len(zero_real)} zero-anchor reads, {len(flat)} flat signals "
            f"-> route {expect}, {int(got.mapped.sum())} mapped; equals the "
            f"plain path")
    return inputs, results


def phase_kernels(cfg, reads, index, inputs, main_routes, dev):
    """Each kernel against its plain version: cheap_fused on D5's first
    chunk; the sort and the DP on the inputs each route of phase_routes
    handed them.  ``main_routes`` holds the (dataset, branch, width) of
    each route the main-path runs took."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import events, hashing, quantization
    from repro_torch.core.index import index_arrays
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref
    from repro_torch.kernels.chain_dp import ops as dp_ops
    from repro_torch.kernels.chain_dp.ref import chain_dp_ref
    from repro_torch.kernels.cheap_fused import ops as cf_ops
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref

    arrays = index_arrays(index, dev)
    bs, ent = arrays["bucket_start"], arrays["entries_packed"]
    R, E, H = CHUNK, cfg.max_events, cfg.max_hits_per_seed
    EH = E * H
    sig = torch.from_numpy(reads.signals[:R]).to(dev)
    xq = events.early_quantize(sig, cfg)
    S = xq.shape[1]
    results = {}

    # ---- cheap_fused ------------------------------------------------------
    got = cf_ops.cheap_fused_rows(xq, bs, ent, cfg)
    want = cheap_fused_rows_ref(xq, bs, ent, cfg)
    torch.cuda.synchronize()
    err = max(assert_equal(f"cheap_fused {n}", g, w) for n, g, w in
              zip(("t_pos", "keep", "counters"), got, want))
    k_ms = time_ms(lambda: cf_ops.cheap_fused_rows(xq, bs, ent, cfg), 20)
    p_ms = time_ms(lambda: cheap_fused_rows_ref(xq, bs, ent, cfg), 3)
    # bytes this run's data needs: samples in, planes out, and the distinct
    # bucket offsets and entry rows its seeds probe
    means, nev, _ = events.detect_quantized(xq, cfg)
    ev_valid = torch.arange(E, device=dev) < nev.unsqueeze(-1)
    sym = quantization.quantize_events(means, ev_valid, cfg)
    keys, _ = hashing.pack_seeds(sym, nev, cfg)
    bkt = (keys & (cfg.n_buckets - 1)).reshape(-1)
    n_bs = torch.unique(torch.cat([bkt, bkt + 1])).numel()
    idx = (bs[bkt].to(torch.int64)[:, None]
           + torch.arange(H, device=dev)).clamp(max=ent.shape[1] - 1)
    n_ent = torch.unique(idx.reshape(-1)).numel()
    n_bytes = 4 * R * S + 2 * 4 * R * EH + 4 * R * 9 + 4 * n_bs + 8 * n_ent
    n_ops = R * (S * (4 * cfg.tstat_window + 16 + 4 * cfg.peak_window)
                 + E * (2 * cfg.seed_width + 24 * 4 + 16) + EH * 24)
    b_ms, b_by = bound(n_bytes, n_ops)
    results["cheap_fused"] = dict(
        shape=f"D5 chunk 0: xq ({R}, {S}) int32, E*H = {EH}, index "
              f"{ent.shape[1]} entries", max_abs_err=err, ms=k_ms,
        plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[kernels] cheap_fused equal; kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})")

    # ---- bitonic_sort and chain_dp: each route's own inputs ---------------
    sort_shapes, dp_shapes = [], []
    for label, cap in inputs.items():
        key, bw = label.split()
        branch, w = bw.split("/")
        main = (key, branch, int(w)) in main_routes
        rows, = cap["sort"]
        N, L = rows.shape
        g = sort_ops.sort_rows(rows)
        want = sort_rows_ref(rows)
        torch.cuda.synchronize()
        err = assert_equal(f"bitonic_sort {label}", g, want)
        Lp = max(128, sort_ops._next_pow2(L))
        k_ms = time_ms(lambda: sort_ops.sort_rows(rows), 20)
        p_ms = time_ms(lambda: sort_rows_ref(rows), 20)
        l_ms = time_ms(lambda: torch.sort(rows, dim=-1), 20)
        stages_ = int(math.log2(Lp)) * (int(math.log2(Lp)) + 1) // 2
        b_ms, b_by = bound(2 * 4 * N * L, 2 * N * (Lp // 2) * stages_)
        sort_shapes.append(dict(
            route=label, on_main_path=main,
            shape=f"({N}, {L}) -> {Lp} lanes", max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"[kernels] bitonic_sort {label} ({N}, {L}) equal; kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.sort {l_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}){' [main path]' if main else ''}")

        sq, st, sv = cap["dp"]
        A = sq.shape[1]
        g = dp_ops.chain_dp(sq, st, sv, cfg)
        want = chain_dp_ref(sq, st, sv, cfg)
        torch.cuda.synchronize()
        err = max(assert_equal(f"chain_dp {label} {n}", a, b)
                  for n, a, b in zip(("f", "diag0"), g, want))
        k_ms = time_ms(lambda: dp_ops.chain_dp(sq, st, sv, cfg), 20)
        p_ms = time_ms(lambda: chain_dp_ref(sq, st, sv, cfg), 1)
        b_ms, b_by = bound(N * A * (4 + 4 + 1 + 4 + 4),
                           15 * N * A * cfg.chain_band)
        dp_shapes.append(dict(
            route=label, on_main_path=main,
            shape=f"({N}, {A}), B={cfg.chain_band}", max_abs_err=err,
            ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
            bound_by=b_by))
        log(f"[kernels] chain_dp {label} ({N}, {A}) equal; kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.5f} ms "
            f"({b_by}){' [main path]' if main else ''}")
    # the summary line's figures: D5's full chunk at full width, the route
    # every D5 main-path chunk takes
    primary = f"D5 full/{EH}"
    for name, shapes in (("bitonic_sort", sort_shapes),
                         ("chain_dp", dp_shapes)):
        first = next(r for r in shapes if r["route"] == primary)
        results[name] = dict(first, by_shape=shapes)
    K.reset_launches()
    return results


def run_map(key, cfg, ref, reads, index, dev, expected=FUSED_PATH):
    """One end-to-end run through Mapper + the streaming driver; the
    kernels of ``expected`` must launch and no other."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import Mapper, driver, map_chunk, pipeline
    from repro_torch.core import score_accuracy

    mapper = Mapper(index, cfg, use_kernels=True, device=dev)
    fn = mapper.chunk_fn()
    sig = reads.signals

    def stream():
        out = driver.collect(driver.stream_map(
            fn, driver.array_chunks(sig, CHUNK)))
        torch.cuda.synchronize()
        return out

    fn(sig[:CHUNK], CHUNK)                      # warm: library, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    pipeline.CHAIN_ROUTES.clear()
    t0 = time.time()
    out = stream()                              # the counted run
    walls = [time.time() - t0]
    launches = dict(K.LAUNCHES)
    routes = dict(pipeline.CHAIN_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    for _ in range(REPEATS - 1):                # host-clock spread
        t0 = time.time()
        stream()
        walls.append(time.time() - t0)
    K.reset_launches()
    dt = sorted(walls)[len(walls) // 2]
    label = f"{key} {cfg.mode}"
    check_launches(label, launches, expected)
    if sum(routes.values()) != READS // CHUNK:
        raise AssertionError(f"{key}: chain routes {routes} do not cover "
                             f"{READS // CHUNK} chunks")
    if out.t_start.shape != (READS,) or not np.isfinite(out.score).all():
        raise AssertionError(f"{key}: malformed outputs")
    acc = score_accuracy(out, reads.true_pos, reads.true_strand,
                         reads.mappable, reads.n_bases, ref.n_events)

    # the first chunk against the plain path, on the card
    x = torch.from_numpy(sig[:CHUNK]).to(dev)
    got = map_chunk(x, mapper.arrays, cfg, use_kernels=True)
    torch.cuda.synchronize()
    K.reset_launches()
    want = map_chunk(x, mapper.arrays, cfg, use_kernels=False)
    torch.cuda.synchronize()
    check_launches(f"{label} plain path", K.LAUNCHES, ())
    for f in ("t_start", "score", "mapped", "n_events"):
        assert_equal(f"{label} chunk 0 {f}", getattr(got, f),
                     getattr(want, f))
    if set(got.counters) != set(want.counters):
        raise AssertionError(f"{label}: counter keys differ")
    for k in want.counters:
        assert_equal(f"{label} chunk 0 counter {k}", got.counters[k],
                     want.counters[k])
    if not torch.equal(got.t_start.cpu(),
                       torch.from_numpy(out.t_start[:CHUNK])):
        raise AssertionError(f"{label}: streamed chunk 0 differs from a "
                             "direct map_chunk")
    res = dict(mode=cfg.mode, reads=READS, chunk=CHUNK, seconds=dt,
               walls=walls,
               reads_per_s=READS / dt,
               precision=acc["precision"], recall=acc["recall"],
               f1=acc["f1"], max_memory_allocated=peak, launches=launches,
               chain_routes={f"{b}/{r}x{w}": n
                             for (b, r, w), n in sorted(routes.items())},
               route_keys=sorted(routes),
               counters=out.counters)
    log(f"[map] {label}: {READS} reads in {dt:.4f}s (median of "
        f"{[round(w, 4) for w in walls]} s) "
        f"({READS / dt:.1f} reads/s), P={acc['precision']:.3f} "
        f"R={acc['recall']:.3f} "
        f"F1={acc['f1']:.3f}, peak {peak / 1e6:.1f} MB, launches {launches};"
        f" chunk 0 equals the plain path")
    log(f"[map] {label}: chain routes (branch/rows x sort width: chunks) "
        f"{res['chain_routes']}")
    return res


def phase_float(data, dev):
    """The float modes end to end (``run_map``), and the cheap phase of
    chunk 0's first 64 reads on the card against the same program on the
    CPU (the f32 evaluation order must not depend on the device)."""
    import torch
    from repro_torch.core import pipeline, stages
    from repro_torch.core.index import index_arrays
    out = {}
    for mode in FLOAT_MODES:
        for key in ("D1", "D5"):
            cfg, ref, reads, index = data[key]
            cfg_m = cfg.with_mode(mode)
            res = run_map(key, cfg_m, ref, reads, index, dev,
                          expected=FLOAT_PATH)
            plan = stages.resolve_plan(cfg_m, stages.KERNELS)
            x = torch.from_numpy(reads.signals[:64])
            got = pipeline.cheap_phase(x.to(dev), index_arrays(index, dev),
                                       cfg_m, plan)
            want = pipeline.cheap_phase(x, index_arrays(index, "cpu"),
                                        cfg_m, plan)
            equal_cheap(f"{key} {mode} card vs CPU",
                        [g.cpu() for g in got[:3]]
                        + [{k: v.cpu() for k, v in got[3].items()}], want)
            log(f"[float] {key} {mode}: the cheap phase of 64 reads on the "
                f"card equals the CPU's ({int(want[3]['n_events'].sum())} "
                f"events, {int(want[3]['n_anchors_postvote'].sum())} "
                f"anchors)")
            out[f"{key} {mode}"] = res
    return out


def phase_perstage(data, dev):
    """``cheap_phase(..., use_fused=False)`` under the kernels plan on each
    dataset's first chunk: event_detect and both lookups launch (counts
    zeroed just before, read just after), and the result equals the fused
    kernel's and the reference plan's.  Both levels are timed."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import pipeline, stages
    from repro_torch.core.index import index_arrays
    out = {}
    for key in ("D1", "D5"):
        cfg, _, reads, index = data[key]
        arrays = index_arrays(index, dev)
        x = torch.from_numpy(reads.signals[:CHUNK]).to(dev)
        plan = stages.resolve_plan(cfg, stages.KERNELS)
        torch.cuda.synchronize()
        K.reset_launches()
        got = pipeline.cheap_phase(x, arrays, cfg, plan, use_fused=False)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        check_launches(f"{key} per-stage", launches, PERSTAGE_PATH)
        fused = pipeline.cheap_phase(x, arrays, cfg, plan)
        ref = pipeline.cheap_phase(x, arrays, cfg, stages.resolve_plan(
            cfg, stages.REFERENCE))
        torch.cuda.synchronize()
        equal_cheap(f"{key} per-stage vs fused", got, fused)
        equal_cheap(f"{key} per-stage vs reference plan", got, ref)
        ms = wall_ms(lambda: pipeline.cheap_phase(x, arrays, cfg, plan,
                                                  use_fused=False), 10)
        fused_ms = wall_ms(lambda: pipeline.cheap_phase(x, arrays, cfg,
                                                        plan), 10)
        K.reset_launches()
        out[key] = dict(launches=launches, perstage_ms=ms, fused_ms=fused_ms)
        log(f"[perstage] {key}: use_fused=False launches {launches}; equals "
            f"the fused kernel and the reference plan; wall per chunk of "
            f"{CHUNK}: per-stage {ms:.3f} ms, fused {fused_ms:.3f} ms")
    return out


def phase_new_kernels(cfg, reads, index, dev):
    """event_detect, the two lookups and the segment_sum helper against
    their plain versions on D5's first chunk, timed with their bounds and
    the library call that computes the same function."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import events, hashing, quantization, seeding
    from repro_torch.core.index import index_arrays
    from repro_torch.kernels.event_detect import ops as ed_ops
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    from repro_torch.kernels.pluto_lookup import ops as pl_ops
    from repro_torch.kernels.pluto_lookup.ref import lookup_ref
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref

    arrays = index_arrays(index, dev)
    bs, ent = arrays["bucket_start"], arrays["entries_packed"]
    R, E, H = CHUNK, cfg.max_events, cfg.max_hits_per_seed
    xq = events.early_quantize(torch.from_numpy(reads.signals[:R]).to(dev),
                               cfg)
    S = xq.shape[1]
    results = {}

    # ---- event_detect -----------------------------------------------------
    got = ed_ops.event_detect_rows(xq, cfg)
    want = event_detect_rows_ref(xq, cfg)
    torch.cuda.synchronize()
    err = max(assert_equal(f"event_detect {n}", g, w)
              for n, g, w in zip(("means", "n_events"), got, want))
    k_ms = time_ms(lambda: ed_ops.event_detect_rows(xq, cfg), 20)
    p_ms = time_ms(lambda: event_detect_rows_ref(xq, cfg), 5)
    b_ms, b_by = bound(4 * R * S + 4 * R * E + 4 * R,
                       R * (S * (4 * cfg.tstat_window + 16
                                 + 4 * cfg.peak_window) + 2 * E))
    results["event_detect"] = dict(
        shape=f"D5 chunk 0: xq ({R}, {S}) int32 -> means ({R}, {E})",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"[kernels] event_detect equal; kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})")

    # ---- the two lookups, on the indices D5's query issues ----------------
    means, nev = want
    valid = torch.arange(E, device=dev) < nev.unsqueeze(-1)
    keys, _ = hashing.pack_seeds(quantization.quantize_events(means, valid,
                                                              cfg), nev, cfg)
    bucket = (keys & (cfg.n_buckets - 1)).to(torch.int32)
    bidx = torch.stack([bucket, bucket + 1])
    start = seeding._take_clip(bs, bidx)[0]
    idx = torch.clamp(start.unsqueeze(-1)
                      + torch.arange(H, dtype=torch.int32, device=dev),
                      max=ent.shape[1] - 1)
    for name, table, i in (("pluto_lookup", bs, bidx),
                           ("pluto_lookup_rows", ent, idx)):
        got = pl_ops.lookup(table, i)
        want_l = lookup_ref(table, i)
        torch.cuda.synchronize()
        err = assert_equal(name, got, want_l)
        flat = i.reshape(-1).contiguous()
        W = table.shape[0] if table.ndim == 2 else 1
        Q = flat.numel()
        n_words = torch.unique(flat).numel()
        k_ms = time_ms(lambda: pl_ops.lookup(table, i), 20)
        p_ms = time_ms(lambda: lookup_ref(table, i), 20)
        if table.ndim == 1:
            flat64 = flat.to(torch.int64)      # take wants int64 indices
            l_ms = time_ms(lambda: torch.take(table, flat64), 20)
            lib = "torch.take"
        else:
            l_ms = time_ms(lambda: table.index_select(1, flat), 20)
            lib = "index_select"
        b_ms, b_by = bound(4 * Q + 4 * W * Q + 4 * W * n_words, 3 * Q)
        results[name] = dict(
            shape=f"D5 chunk 0: table {tuple(table.shape)}, {Q} indices "
                  f"({n_words} distinct)", max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
            library=lib)
        log(f"[kernels] {name} equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, {lib} {l_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by})")

    # ---- segment_sum, on D5 chunk 0's ms_float detection ------------------
    cfg_f = cfg.with_mode("ms_float")
    x = events.dequantize_fixed(xq, cfg.frac_bits)
    eid = events._event_ids(events.boundary_mask_float(x, cfg_f), E)
    got = ss_ops.segment_sum(x, eid, E, S)
    want_s = segment_sum_ref(x, eid, E, S)
    torch.cuda.synchronize()
    err = max(assert_equal(f"segment_sum {n}", g, w)
              for n, g, w in zip(("sums", "counts"), got, want_s))
    k_ms = time_ms(lambda: ss_ops.segment_sum(x, eid, E, S), 20)
    p_ms = time_ms(lambda: segment_sum_ref(x, eid, E, S), 2)
    flat_e = (eid + E * torch.arange(R, device=dev, dtype=torch.int32)[
        :, None]).reshape(-1)
    flat_x = x.reshape(-1)
    l_ms = time_ms(lambda: torch.zeros(R * E, device=dev).index_add_(
        0, flat_e, flat_x), 20)
    b_ms, b_by = bound(8 * R * S + 8 * R * E, 2 * R * S)
    results["segment_sum"] = dict(
        shape=f"D5 chunk 0 (ms_float): x ({R}, {S}) f32 -> ({R}, {E})",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=l_ms, library="index_add_ (atomic order)")
    log(f"[kernels] segment_sum equal; kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.3f} ms, index_add_ {l_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    K.reset_launches()
    return results


def phase_profile(key, cfg, ref, reads, index, dev):
    """torch.profiler over one streamed pass (8 chunks): device time by
    kernel, the device's busy share of the wall time, host time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.core import Mapper, driver

    fn = Mapper(index, cfg, use_kernels=True, device=dev).chunk_fn()

    def stream():
        driver.collect(driver.stream_map(
            fn, driver.array_chunks(reads.signals, CHUNK)))
        torch.cuda.synchronize()

    stream()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        stream()
        wall = time.time() - t0
    K.reset_launches()
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in ev) / 1e6
    calls = {e.key: e.count for e in ev}
    syncs = calls.get("cudaStreamSynchronize", 0)
    launches = calls.get("cudaLaunchKernel", 0)
    log(f"[profile] {key} {cfg.mode}: wall {wall * 1e3:.3f} ms under the "
        f"profiler, "
        f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), "
        f"{syncs} stream syncs and {launches} kernel launches for "
        f"{READS // CHUNK} chunks")
    for e in sorted(ev, key=dev_us, reverse=True)[:12]:
        if dev_us(e):
            log(f"[profile]   device {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5} "
                f"{e.key[:90]}")
    for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5} {e.key[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / f"trace_{key}_{cfg.mode}.json"))
    return dict(wall_s=wall, device_busy_s=busy, stream_syncs=syncs,
                kernel_launches=launches)


def phase_launcher():
    """The D1 runs through the launcher's own entry point: ``ms_fixed``
    (the fused path) and ``--mode rh2`` (the per-stage float path)."""
    from repro_torch import kernels as K
    from repro_torch.launch import map_reads
    out = {}
    for mode, expected, min_f1 in (("ms_fixed", FUSED_PATH, 0.85),
                                   ("rh2", FLOAT_PATH, 0.0)):
        wd = ROOT / "chiprun_out" / f"smoke_map_reads_{mode}"
        K.reset_launches()
        acc = map_reads.main(["--dataset", "D1", "--reads", str(READS),
                              "--chunk", str(CHUNK), "--use-kernels",
                              "--mode", mode, "--workdir", str(wd),
                              "--out", str(wd / "D1.paf")])
        launches = dict(K.LAUNCHES)
        check_launches(f"launcher {mode}", launches, expected)
        if acc["f1"] < min_f1:
            raise AssertionError(f"launcher: D1 {mode} F1 {acc['f1']:.3f} "
                                 f"< {min_f1}")
        log(f"[launcher] D1 {mode} F1 {acc['f1']:.3f}, launches {launches}")
        out[mode] = dict(f1=acc["f1"], launches=launches)
    K.reset_launches()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.time()

    name, smi = phase_device()
    phase_build()
    data = {k: make_dataset(k) for k in ("D1", "D5")}
    maps = {k: run_map(k, *data[k], dev) for k in ("D1", "D5")}
    floats = phase_float(data, dev)
    perstage = phase_perstage(data, dev)
    main_routes = {(k, b, w) for k in maps
                   for (b, _, w) in maps[k]["route_keys"]}
    inputs, routes = phase_routes(data, dev)
    kern = phase_kernels(*[data["D5"][i] for i in (0, 2, 3)], inputs,
                         main_routes, dev)
    kern.update(phase_new_kernels(*[data["D5"][i] for i in (0, 2, 3)], dev))
    for k in maps:
        maps[k]["profile"] = phase_profile(k, *data[k], dev)
    for mode in FLOAT_MODES:
        cfg, ref, reads, index = data["D5"]
        floats[f"D5 {mode}"]["profile"] = phase_profile(
            "D5", cfg.with_mode(mode), ref, reads, index, dev)
    launcher = phase_launcher()

    # name: (source, the TPU kernel it replaces, the run whose launches
    # count: the main path that drives it)
    runs = {**{f"{d} ms_fixed": maps[d]["launches"] for d in maps},
            **{k: v["launches"] for k, v in floats.items()},
            **{f"{d} per-stage": v["launches"] for d, v in perstage.items()}}
    sources = {
        "cheap_fused": ("src/repro_torch/csrc/cheap_fused.cu",
                        "src/repro/kernels/cheap_fused/cheap_fused.py:367",
                        "D5 ms_fixed"),
        "bitonic_sort": ("src/repro_torch/csrc/bitonic_sort.cu",
                         "src/repro/kernels/bitonic_sort/bitonic_sort.py:64",
                         "D5 ms_fixed"),
        "chain_dp": ("src/repro_torch/csrc/chain_dp.cu",
                     "src/repro/kernels/chain_dp/chain_dp.py:89",
                     "D5 ms_fixed"),
        "event_detect": ("src/repro_torch/csrc/event_detect.cu",
                         "src/repro/kernels/event_detect/event_detect.py:124",
                         "D5 per-stage"),
        "pluto_lookup_rows": (
            "src/repro_torch/csrc/pluto_lookup.cu",
            "src/repro/kernels/pluto_lookup/pluto_lookup.py:97",
            "D5 ms_float"),
        "pluto_lookup": ("src/repro_torch/csrc/pluto_lookup.cu",
                         "src/repro/kernels/pluto_lookup/pluto_lookup.py:125",
                         "D5 ms_float"),
        # a helper of the float detection, not the port of a TPU kernel:
        # it stands for the reference's jax.ops.segment_sum
        "segment_sum": ("src/repro_torch/csrc/segment_sum.cu",
                        "src/repro/core/events.py:301", "D5 ms_float"),
    }
    summary = []
    for k, (src, rep, run) in sources.items():
        r = kern[k]
        summary.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=runs[run][k], launches_run=run,
            launches_by_run={n: v[k] for n, v in runs.items()},
            equal=True, max_abs_err=r["max_abs_err"], ms=r["ms"],
            kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], library=r.get("library"),
            shape=r["shape"], by_shape=r.get("by_shape"),
            helper=k == "segment_sum"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(device=name, nvidia_smi=smi, kernels=summary, map=maps,
             float=floats, perstage=perstage, launcher=launcher,
             routes=routes, seconds=time.time() - t_all), indent=1,
        default=str))
    log(f"[map-summary] " + json.dumps(
        {name_: {k: res[k] for k in ("reads_per_s", "f1",
                                     "max_memory_allocated")}
         for name_, res in [*((f"{d} ms_fixed", maps[d]) for d in maps),
                            *floats.items()]}))
    log(f"[seconds] {time.time() - t_all:.1f}")
    log(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
