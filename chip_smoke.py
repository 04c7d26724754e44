#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device    — the card's name, and its name and power limit as nvidia-smi
               reports them;
2. build     — compile the CUDA kernels of ``src/repro_torch/csrc`` (nvcc,
               one process per source) and print ptxas's register and
               shared-memory summary, and the SASS instruction counts of
               the DP's anchor loop, of the sort for 4096 lanes, of the
               fused cheap phase's shipped instance, of the segment sum,
               of the event detection's shipped instance and of the 1-D
               lookup (IDIV: integer divisions by a runtime value, one
               I2F.U32.RP each);
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
   perread   — the per-read stage engine under the kernels plan: on D1's
               and D5's first chunk ``cheap_phase_vmap`` (the stage
               bodies: event_detect and both lookups once each, no
               cheap_fused) must equal the fused ladder and the reference
               plan, and ``map_chunk`` with ``chain_compaction`` off (the
               whole-graph route: those and bitonic_sort and chain_dp once
               each) the reference plan's whole graph and the compacted
               kernels path; D5 ``ms_float`` and ``rh2``: the stage bodies
               (segment_sum and both lookups) equal the reference plan;
               ``map_read`` of 8 D5 reads equals their rows; the median
               pass of a 2 s window of the whole graph, the stage bodies'
               cheap phase and the shipped ladder on D5 is recorded;
   tiered    — the out-of-core index at D5 (16 tiles): the streaming
               build must equal ``tier_index(build_index(...))`` byte for
               byte; ``Mapper(backend="tiered")`` over 4096 reads (16
               slots, 4 slots, 4 random slots + 4 replicas, no pre-pass
               reuse) and 1024 ``ms_float`` reads must equal the resident
               kernels plan chunk by chunk and launch no hand-written
               kernel; healed faults must equal it too, a sticky
               corruption must raise ``TileReadError``; the page-in from
               pinned and pageable memory, the pre-pass, paged bytes, hit
               rates, reads/s against the resident reference plan and peak
               memory are reported; ``serve_rsga --fault-plan 0
               --early-term`` at D1 must give the driver state of the same
               run on the CPU;
4. routes    — one chunk per route through the chaining gate (full or
               compacted chunk, at the 64 and 128 ladder widths and at the
               full E*H = 3072; a chunk with no anchors), picked by anchor
               count; each must take its route and equal the plain path;
5. kernels   — each kernel against its plain PyTorch version on the card:
               cheap_fused and event_detect on D5's first chunk (512 reads
               of 1024 samples, E=192 events, H=16 hits; both also in their
               generic instances: cheap_fused at H=12 and 3000 vote bins,
               event_detect at tw=3, peak_r=2, each also on edge reads),
               the two lookups on the indices D5's query issues for it
               (pluto_lookup also on edge indices), segment_sum
               on its ms_float and rh2 detections, the sort and the DP on
               the very inputs
               each route of phase 4 gave them, and on inputs built to
               break them (the sort's edge rows at 512 x 4096 and 512 x
               8192, the DP's tie-heavy anchors at 512 x 512); the DP's
               band kernel at B = 16 and 64 on D5's anchors, tie-heavy
               anchors and anchors whose tying predecessors share a lane
               (and at B = 128 and 300 on the last two), and rows of 16384
               keys through the sort wrapper's counted torch.sort route.
               Tolerance: exact.
               Times from warmed CUDA events; ``bound_ms`` is the least time
               the card could take (bytes over 3.35 TB/s, operations over
               67 T/s scalar), from this run's inputs; the launch floor is
               an empty kernel timed the same way (one CTA, and at the
               grids of event_detect and pluto_lookup);
6. profile   — torch.profiler over one streamed pass at each size (and at
               D5 in each float mode): device time by kernel, the device's
               busy share of the wall time (the union of the trace's kernel
               and copy intervals), host time by op (traces in
               ``chiprun_out/``); then the D1 runs through the launcher
               (``repro_torch.launch.map_reads --use-kernels``, ``ms_fixed``
               and ``--mode rh2``), and the port's examples and scripts
               (quickstart, map_reads_e2e, kernel_support, smoke_core at
               20,000 bases and 32 reads, smoke_ssdmodel, fault_sweep at 5
               plans), each of which must exit 0;
7. serve     — the serving path (SERVE_RUNS): ``serve_rsga`` with the
               early-termination ladder, 32 streams x 64 reads in chunks of
               32, at D5 and D1 ``ms_fixed`` (load 0.7, and 1.3 with
               shedding and 4 tenants) and D5 ``ms_float``.  Launch counts
               are zeroed just before each run and read just after; every
               ladder stage must resolve the full-length plan; the run's
               driver state must equal the same trace through the
               reference plan on the card, and every admitted read
               ``map_realtime``'s result.  Then a profiled D5 pass, and
               each kernel against its plain version at every prefix's
               shapes (R = 32, S = 256..1024, E = 51..192);
8. sharded   — the multi-device mapper (``Mapper(mesh=...)``): the
               single-device runs first, then 4 ranks sharing the card
               through gloo (mesh (2, 2) ('data', 'model'), spawned by
               ``launch/mesh.run_ranks``; each rank only loads the built
               library): the kernels plan over D5's 4096 reads in chunks
               of 512 (cheap_fused, bitonic_sort and chain_dp must launch
               on every rank, the per-stage kernels on none), ring, a2a
               and the tiered plan (16 tiles, 4 slots) over 1024 reads (no
               hand kernel may launch), and a D1 serving trace (8 streams
               x 16 reads, chunks of 32, the prefix ladder) through the
               kernels plan and a2a.  Every rank must equal the single
               device chunk by chunk, and the serving driver state too.
               Reads/s against the single device, collective bytes a chunk
               by kind, the host staging of gloo's payloads, peak memory
               and the backend of each rank are reported; then every rank
               maps the kernels plan's reads again at its pinned thread
               count and at the parent's, and once under torch.profiler
               (``[sharded-profile]``: its host time inside collective
               calls, staging, blocked on its device and dispatching,
               beside the device's busy time).  On a host with 2 or more
               cards the same runs follow on one NCCL rank a card;
9. paper     — the paper's evaluation (``repro_torch.benchmarks``):
               Table 3 maps all 15 (dataset, mode) records, D1-D5 in
               rh2, ms_float and ms_fixed at chunk 32 (datasets.build),
               under the reference plan into a fresh record cache, then
               the kernels plan maps them again (launch counts zeroed just
               before each run and read just after: ms_fixed must launch
               the fused path, the float modes the float path, the
               reference plan nothing); every record of both plans must
               equal the JAX package's (``jax_records.json``: counters,
               P/R/F1, index and raw bytes).  Every table and figure
               module (Figs. 11-13 under both cost models) then runs from
               those records and each ``derived`` field must equal the
               JAX package's; the serving calibration through the kernels
               plan must give the host CPU's rows; ``bench_sim.check``
               must pass on the committed ``BENCH_sim.json`` (those rows
               are virtual-clock numbers that no mapped output changes, so
               the calibration mapper's own reads are held too, card
               against host); D1-D5 in each mode (chunks of 32) and the
               filter ablation's five variants (400,000 bases, 96 reads):
               every read under the kernels plan must equal the reference
               plan on the card.  ``[paper-summary]``: each record's F1
               and peak device memory (with what earlier phases still held
               when the phase began), the kernels plan's reads/s a record
               (the median pass of a 2 s window, with the fastest and
               slowest), the Table 3 lines as the card ran them, the
               phase's seconds;
10. summary  — one JSON line of per-kernel results, then the last line
               ``{"ok": true, "device": {...}}``.  Every log line also goes
               to ``chiprun_out/chip_smoke.log``.

``python3 chip_smoke.py --sharded-only`` runs phases 1-2, the datasets and
phase 8 alone (the NCCL run too on a host of several cards), records them
in ``chiprun_out/chip_smoke_sharded.json`` and prints no result line.

It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import math
import os
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


LOG_LINES = []       # every log line, kept in chiprun_out/chip_smoke.log


def log(msg: str) -> None:
    print(msg, flush=True)
    LOG_LINES.append(msg)


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


def cheap_fused_bound(xq, bs, ent, c):
    """Bytes this run's data needs (samples in, planes out, and the
    distinct bucket offsets and entry rows its seeds probe) and the
    operations of the detect..vote chain."""
    import torch
    from repro_torch.core import events, hashing, quantization
    R, S = xq.shape
    E, H = c.max_events, c.max_hits_per_seed
    means, nev, _ = events.detect_quantized(xq, c)
    ev_valid = torch.arange(E, device=xq.device) < nev.unsqueeze(-1)
    sym = quantization.quantize_events(means, ev_valid, c)
    keys, _ = hashing.pack_seeds(sym, nev, c)
    bkt = (keys & (c.n_buckets - 1)).reshape(-1)
    n_bs = torch.unique(torch.cat([bkt, bkt + 1])).numel()
    idx = (bs[bkt].to(torch.int64)[:, None]
           + torch.arange(H, device=xq.device)).clamp(max=ent.shape[1] - 1)
    n_ent = torch.unique(idx.reshape(-1)).numel()
    n_bytes = 4 * R * S + 2 * 4 * R * E * H + 4 * R * 9 + 4 * n_bs + 8 * n_ent
    n_ops = R * (S * (4 * c.tstat_window + 16 + 4 * c.peak_window)
                 + E * (2 * c.seed_width + 24 * 4 + 16) + E * H * 24)
    return bound(n_bytes, n_ops)


def sort_bound(N: int, L: int):
    """Keys read and written once; compare-exchanges of the bitonic network
    over the padded row."""
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    Lp = max(128, sort_ops._next_pow2(L))
    lg = int(math.log2(Lp))
    return bound(2 * 4 * N * L, 2 * N * (Lp // 2) * lg * (lg + 1) // 2)


def dp_bound(N: int, A: int, band: int):
    return bound(N * A * (4 + 4 + 1 + 4 + 4), 15 * N * A * band)


def event_detect_bound(R: int, S: int, c):
    E = c.max_events
    return bound(4 * R * S + 4 * R * E + 4 * R,
                 R * (S * (4 * c.tstat_window + 16 + 4 * c.peak_window)
                      + 2 * E))


def lookup_bound(table, idx):
    """Indices in, one word a plane out, and the distinct table words."""
    import torch
    flat = idx.reshape(-1)
    W = table.shape[0] if table.ndim == 2 else 1
    Q = flat.numel()
    n_words = torch.unique(flat).numel()
    return bound(4 * Q + 4 * W * Q + 4 * W * n_words, 3 * Q), Q, n_words


def segment_sum_bound(R: int, S: int, E: int):
    return bound(8 * R * S + 8 * R * E, 2 * R * S)


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


def ptxas_summary(log: str):
    """Registers, spills and stack of each kernel in one source's
    ``nvcc -Xptxas -v`` output, keyed by the kernel's mangled name."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                     map(int, m.groups())))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


SASS_OPS = ("SHFL", "REDUX", "BAR", "IMNMX", "FFMA", "FSEL", "FSETP", "FADD",
            "ATOMS", "LDG", "LDS", "MUFU")


def sass_counts(lib_path) -> dict:
    """Instruction counts from the library's SASS (``cuobjdump -sass``):
    the DP kernel's innermost loop (the unrolled anchor steps), and the
    whole of the sort instance for rows of 4096 lanes, of the fused cheap
    phase's shipped instance, of the segment sum, of the event detection's
    shipped instance and of the 1-D lookup, by opcode family, in total,
    and the integer divisions by a runtime value (IDIV)."""
    import re
    from repro_torch.kernels import build
    text = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        # /*addr*/ [@predicate] OPCODE operands
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2),
                                m.group(3)))
    dp = next(v for k, v in funcs.items() if "chain_dp_kernel" in k)
    # innermost loop: a backward branch's span that holds no other one
    spans = []
    for i, (addr, op, rest) in enumerate(dp):
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            target = int(m.group(1), 16)
            spans.append((next(j for j, x in enumerate(dp) if x[0] >= target),
                          i))
    inner = [(a, b) for a, b in spans
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in spans)]
    a, b = max(inner, key=lambda ab: ab[1] - ab[0])

    def count(instrs):
        out = {op: sum(1 for _, o, _ in instrs
                       if o.split(".")[0].lstrip("V") == op)
               for op in SASS_OPS}
        out["IDIV"] = sum(1 for _, o, _ in instrs if o == "I2F.U32.RP")
        out["total"] = len(instrs)
        return out

    def func(pattern):
        return next(v for k, v in funcs.items() if pattern in k)
    return {"chain_dp loop": count(dp[a:b + 1]),
            "bitonic_sort<4096>": count(func("bitonic_sort_kernelILi4096E")),
            "cheap_fused<16,4096,192,4,3>": count(func(
                "cheap_fused_kernelILi16ELi4096ELi192ELi4ELi3E")),
            "segment_sum": count(func("segment_sum_kernel")),
            "event_detect<4,3>": count(func(
                "event_detect_kernelILi4ELi3E")),
            "pluto_lookup": count(func("13lookup_kernel"))}


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
    # the kernels redesigned for Hopper: ptxas's registers and spills, and
    # their SASS instruction counts
    record = {src: ptxas_summary(build.BUILD_LOG.get(src, ""))
              for src in ("bitonic_sort.cu", "chain_dp.cu", "cheap_fused.cu",
                          "segment_sum.cu", "event_detect.cu",
                          "pluto_lookup.cu")}
    record["sass"] = sass_counts(build.build())
    for k, v in record["sass"].items():
        log(f"[build] SASS {k}: " + ", ".join(f"{n} {c}"
                                              for n, c in v.items()))
    return record


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


_CAPTURED = {}


def capture_backends() -> dict:
    """Register (once) the "capture" backend of the sort and dp stages: it
    keeps a copy of the inputs each call gets (in the returned dict) and
    calls the kernel wrapper."""
    from repro_torch.core import stages
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    from repro_torch.kernels.chain_dp import ops as dp_ops
    if ("sort", "capture") in stages._REGISTRY:
        return _CAPTURED

    def sort(keys):
        _CAPTURED["sort"] = (keys.clone(),)
        return sort_ops.sort_rows(keys)

    def dp(q, t, v, cfg):
        _CAPTURED["dp"] = (q.clone(), t.clone(), v.clone())
        return dp_ops.chain_dp(q, t, v, cfg)
    stages.register_backend(
        "sort", "capture",
        lambda st, cfg, index: stages.sort_with(st, cfg, index, sorter=sort),
        primitive=sort)
    stages.register_backend(
        "dp", "capture",
        lambda st, cfg, index: stages.dp_with(
            st, cfg, index, dp=lambda q, t, v: dp(q, t, v, cfg)),
        primitive=dp)
    return _CAPTURED


def capture_plan(cfg):
    """The kernels plan of ``cfg`` with its sort and dp captured."""
    from repro_torch.core import stages
    return tuple((s, "capture" if s in ("sort", "dp") else b)
                 for s, b in stages.resolve_plan(cfg, stages.KERNELS))


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
    from repro_torch.core import map_chunk, pipeline
    from repro_torch.core.index import index_arrays

    captured = capture_backends()
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
        plan = capture_plan(cfg)
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
    from repro_torch.core import events
    from repro_torch.core.index import index_arrays
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref
    from repro_torch.kernels.chain_dp import ops as dp_ops
    from repro_torch.kernels.chain_dp.ref import chain_dp_ref
    from repro_torch.kernels.cheap_fused import ops as cf_ops
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref

    arrays = index_arrays(index, dev)
    bs, ent = arrays["bucket_start"], arrays["entries_packed"]
    R, E = CHUNK, cfg.max_events
    EH = E * cfg.max_hits_per_seed
    sig = torch.from_numpy(reads.signals[:R]).to(dev)
    xq = events.early_quantize(sig, cfg)
    S = xq.shape[1]
    results = {}

    # ---- cheap_fused: the shipped config's instance and the generic one --
    cheap_shapes = []
    for label, c in (("shipped", cfg),
                     ("generic", cfg.replace(max_hits_per_seed=12,
                                             vote_bins=3000))):
        Hc = c.max_hits_per_seed
        got = cf_ops.cheap_fused_rows(xq, bs, ent, c)
        want = cheap_fused_rows_ref(xq, bs, ent, c)
        torch.cuda.synchronize()
        err = max(assert_equal(f"cheap_fused {label} {n}", g, w) for n, g, w
                  in zip(("t_pos", "keep", "counters"), got, want))
        k_ms = time_ms(lambda: cf_ops.cheap_fused_rows(xq, bs, ent, c), 20)
        p_ms = time_ms(lambda: cheap_fused_rows_ref(xq, bs, ent, c), 3)
        b_ms, b_by = cheap_fused_bound(xq, bs, ent, c)
        cheap_shapes.append(dict(
            route=label, on_main_path=label == "shipped",
            shape=f"D5 chunk 0: xq ({R}, {S}) int32, E*H = {E}*{Hc}, "
                  f"{c.vote_bins} vote bins, index {ent.shape[1]} entries",
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        log(f"[kernels] cheap_fused {label} instance (H={Hc}, "
            f"{c.vote_bins} bins) equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})")
    results["cheap_fused"] = dict(cheap_shapes[0], by_shape=cheap_shapes)

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
        b_ms, b_by = sort_bound(N, L)
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
        b_ms, b_by = dp_bound(N, A, cfg.chain_band)
        dp_shapes.append(dict(
            route=label, on_main_path=main,
            shape=f"({N}, {A}), B={cfg.chain_band}", max_abs_err=err,
            ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
            bound_by=b_by))
        log(f"[kernels] chain_dp {label} ({N}, {A}) equal; kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.5f} ms "
            f"({b_by}){' [main path]' if main else ''}")
    # inputs built to break the two redesigned kernels: the sort's edge rows
    # at 4096 keys and at the wrapper's limit of 8192, the DP's tie-heavy
    # anchors (ties decided by the oldest-slot rule, anchors max_gap apart)
    import numpy as np
    from repro_torch.kernels.fixtures import edge_rows, tie_anchors
    for L in (4096, 8192):
        rows = torch.from_numpy(edge_rows(np.random.default_rng(L), R,
                                          L)).to(dev)
        g = sort_ops.sort_rows(rows)
        torch.cuda.synchronize()
        err = assert_equal(f"bitonic_sort edge rows ({R}, {L})", g,
                           sort_rows_ref(rows))
        k_ms = time_ms(lambda: sort_ops.sort_rows(rows), 20)
        l_ms = time_ms(lambda: torch.sort(rows, dim=-1), 20)
        b_ms, b_by = sort_bound(R, L)
        sort_shapes.append(dict(
            route=f"edge rows {R}x{L}", on_main_path=False,
            shape=f"({R}, {L}) -> {L} lanes", max_abs_err=err, ms=k_ms,
            plain_ms=l_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"[kernels] bitonic_sort edge rows ({R}, {L}) equal; kernel "
            f"{k_ms:.4f} ms, torch.sort {l_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by})")
    A = cfg.max_anchors
    q, t, v = tie_anchors(np.random.default_rng(0), R, A,
                          max_gap=cfg.max_gap)
    v[1] = False
    sq, st, sv = (torch.from_numpy(x).to(dev) for x in (q, t, v))
    g = dp_ops.chain_dp(sq, st, sv, cfg)
    want = chain_dp_ref(sq, st, sv, cfg)
    torch.cuda.synchronize()
    err = max(assert_equal(f"chain_dp tie rows {n}", a, b)
              for n, a, b in zip(("f", "diag0"), g, want))
    k_ms = time_ms(lambda: dp_ops.chain_dp(sq, st, sv, cfg), 20)
    b_ms, b_by = dp_bound(R, A, cfg.chain_band)
    dp_shapes.append(dict(
        route=f"tie rows {R}x{A}", on_main_path=False,
        shape=f"({R}, {A}), B={cfg.chain_band}", max_abs_err=err, ms=k_ms,
        plain_ms=None, library_ms=None, bound_ms=b_ms, bound_by=b_by))
    log(f"[kernels] chain_dp tie rows ({R}, {A}) equal; kernel {k_ms:.4f} "
        f"ms, bound {b_ms:.5f} ms ({b_by})")
    # the summary line's figures: D5's full chunk at full width, the route
    # every D5 main-path chunk takes
    primary = f"D5 full/{EH}"
    # the shipped B = 32 instance again at the main path's inputs: its
    # spread between repeats, the noise its time is read against
    d5 = inputs[primary]["dp"]
    b32 = [time_ms(lambda: dp_ops.chain_dp(*d5, cfg), 20) for _ in range(3)]
    log(f"[kernels] chain_dp B=32 D5 full ({R}, {A}) repeats "
        f"{[round(x, 5) for x in b32]} ms")
    # the band kernel (any chain_band but 32): D5's full-width anchors,
    # tie-heavy anchors, and anchors whose tying predecessors lie 32 apart
    # (one lane of the band kernel decides the tie); B = 16 and 64 keep the
    # band in registers (1 and 2 slots a lane), B = 128 and 300 in the
    # scratch row
    from repro_torch.kernels.fixtures import lane_tie_anchors
    lane = (torch.from_numpy(x).to(dev) for x in lane_tie_anchors(R, A))
    cases = dict(full=d5, ties=(sq, st, sv), lane_ties=tuple(lane))
    for B in (16, 64, 128, 300):
        cb = cfg.replace(chain_band=B)
        for label, (bq, bt, bv) in cases.items():
            if B > 64 and label == "full":
                continue
            K.reset_launches()
            g = dp_ops.chain_dp(bq, bt, bv, cb)
            want = chain_dp_ref(bq, bt, bv, cb)
            torch.cuda.synchronize()
            check_launches(f"chain_dp B={B} {label}", K.LAUNCHES,
                           ("chain_dp",))
            err = max(assert_equal(f"chain_dp B={B} {label} {n}", a, b)
                      for n, a, b in zip(("f", "diag0"), g, want))
            k_ms = time_ms(lambda: dp_ops.chain_dp(bq, bt, bv, cb), 20)
            p_ms = (time_ms(lambda: chain_dp_ref(bq, bt, bv, cb), 1)
                    if label == "full" else None)
            b_ms, b_by = dp_bound(R, A, B)
            dp_shapes.append(dict(
                route=f"B={B} {label} {R}x{A}", on_main_path=False,
                shape=f"({R}, {A}), B={B}", max_abs_err=err, ms=k_ms,
                plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by))
            log(f"[kernels] chain_dp B={B} {label} ({R}, {A}) equal; "
                f"kernel {k_ms:.4f} ms"
                + (f", plain {p_ms:.3f} ms" if p_ms is not None else "")
                + f", bound {b_ms:.5f} ms ({b_by})")
    # rows past one kernel block: the sort wrapper's counted torch.sort
    # route, as the reference's sort_batch takes jnp.sort there.  Not a
    # hand kernel, so it stays out of the kernels line; it is held against
    # numpy's sort on the host (tests/test_torch_chain.py holds it against
    # the reference's sort_batch)
    L = 16384
    host_rows = edge_rows(np.random.default_rng(L), R, L)
    rows = torch.from_numpy(host_rows).to(dev)
    K.reset_launches()
    g = sort_ops.sort_rows(rows)
    torch.cuda.synchronize()
    if K.LAUNCHES["sort_rows_library"] != 1 or K.LAUNCHES["bitonic_sort"]:
        raise AssertionError(f"sort rows of {L}: launches {K.LAUNCHES}")
    err = assert_equal(f"sort library route ({R}, {L})", g.cpu(),
                       torch.from_numpy(np.sort(host_rows, axis=1)))
    k_ms = time_ms(lambda: sort_ops.sort_rows(rows), 20)
    b_ms, b_by = sort_bound(R, L)
    results["sort_rows_library"] = dict(
        route="library", call="torch.sort", shape=f"({R}, {L})",
        max_abs_err=err, ms=k_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"[kernels] sort_rows ({R}, {L}) took the counted torch.sort route "
        f"(no hand kernel) and equals numpy's sort; {k_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    for name, shapes in (("bitonic_sort", sort_shapes),
                         ("chain_dp", dp_shapes)):
        first = next(r for r in shapes if r["route"] == primary)
        results[name] = dict(first, by_shape=shapes)
    results["chain_dp"]["b32_repeats_ms"] = b32
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


# ---- the per-read stage engine ---------------------------------------------
# The whole-graph route's launches a chunk under the kernels plan (ms_fixed)
PERREAD_PATH = PERSTAGE_PATH + ("bitonic_sort", "chain_dp")
# the float modes' cheap stage bodies: the reference detection with the
# segment_sum helper, and the two lookups
PERREAD_FLOAT = ("pluto_lookup", "pluto_lookup_rows", "segment_sum")
MAP_READ_READS = 8
WINDOW_S = 2.0        # a timed window of repeated passes, each synced
MIN_PASSES = 5


def check_once(label: str, launches, expected) -> None:
    """Every kernel of ``expected`` launched exactly once, no other."""
    check_launches(label, launches, expected)
    many = {k: launches[k] for k in expected if launches[k] != 1}
    if many:
        raise AssertionError(f"{label}: kernels launched more than once "
                             f"{many} ({launches})")


def equal_map(label: str, got, want) -> None:
    """Two ``MapOutput``s on the device, field and counter."""
    for f in ("t_start", "score", "mapped", "n_events"):
        assert_equal(f"{label} {f}", getattr(got, f), getattr(want, f))
    if set(got.counters) != set(want.counters):
        raise AssertionError(f"{label}: counter keys differ")
    for k in want.counters:
        assert_equal(f"{label} counter {k}", got.counters[k],
                     want.counters[k])


def window(fn) -> dict:
    """Passes of ``fn`` (each ended by a device sync) for WINDOW_S seconds,
    at least MIN_PASSES: the median, fastest and slowest pass in ms, on
    the host clock.  A single pass of a few ms on the host clock is launch
    overhead and noise, not a measurement."""
    import torch
    fn()
    torch.cuda.synchronize()
    passes = []
    t_end = time.perf_counter() + WINDOW_S
    while len(passes) < MIN_PASSES or time.perf_counter() < t_end:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) * 1e3)
    passes.sort()
    return dict(median_ms=passes[len(passes) // 2], fastest_ms=passes[0],
                slowest_ms=passes[-1], passes=len(passes))


def phase_perread(data, dev, smi):
    """The per-read stage engine under the kernels plan on the card.

    D1 and D5 ``ms_fixed``, chunk 0 (CHUNK reads): ``cheap_phase_vmap``
    (the stage bodies) must launch event_detect and both lookups once each
    and no cheap_fused, and equal the fused ladder and the reference
    plan's per-stage path in every output and per-read counter;
    ``map_chunk`` with ``chain_compaction`` off (the whole-graph route)
    must launch those and bitonic_sort and chain_dp once each, take the
    "graph" route, and equal the reference plan's whole graph and the
    compacted kernels path in every field and counter.  D5 ``ms_float``
    and ``rh2``: ``cheap_phase_vmap`` launches the float stage bodies'
    kernels and equals the reference plan's.  ``map_read`` of D5's first
    MAP_READ_READS reads equals their rows of the whole-graph chunk.  Then
    the median pass of a WINDOW_S window of three D5 routes: the
    whole-graph chunk, ``cheap_phase_vmap``, and the shipped ladder
    (``map_chunk``, fused cheap phase and compaction), a record beside the
    card's name and power limit, not a claim."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import map_chunk, map_read, pipeline, stages
    from repro_torch.core.index import index_arrays
    out = dict(launches={}, card=smi)
    for key in ("D1", "D5"):
        cfg, _, reads, index = data[key]
        arrays = index_arrays(index, dev)
        x = torch.from_numpy(reads.signals[:CHUNK]).to(dev)
        kern = stages.resolve_plan(cfg, stages.KERNELS)
        ref = stages.resolve_plan(cfg, stages.REFERENCE)
        torch.cuda.synchronize()
        K.reset_launches()
        got = pipeline.cheap_phase_vmap(x, arrays, cfg, kern)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        check_once(f"{key} cheap_phase_vmap", launches, PERSTAGE_PATH)
        out["launches"][f"{key} perread cheap"] = launches
        equal_cheap(f"{key} cheap_phase_vmap vs fused", got,
                    pipeline.cheap_phase(x, arrays, cfg, kern))
        equal_cheap(f"{key} cheap_phase_vmap vs reference per-stage", got,
                    pipeline.cheap_phase(x, arrays, cfg, ref))

        cfg_g = cfg.replace(chain_compaction=False)
        EH = cfg.max_events * cfg.max_hits_per_seed
        torch.cuda.synchronize()
        K.reset_launches()
        pipeline.CHAIN_ROUTES.clear()
        graph = map_chunk(x, arrays, cfg_g, use_kernels=True)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        routes = dict(pipeline.CHAIN_ROUTES)
        check_once(f"{key} whole graph", launches, PERREAD_PATH)
        if routes != {("graph", CHUNK, EH): 1}:
            raise AssertionError(f"{key} whole graph: routes {routes}")
        out["launches"][f"{key} perread graph"] = launches
        K.reset_launches()
        want = map_chunk(x, arrays, cfg_g, use_kernels=False)
        torch.cuda.synchronize()
        check_launches(f"{key} whole graph, reference plan", K.LAUNCHES, ())
        equal_map(f"{key} whole graph vs reference plan", graph, want)
        equal_map(f"{key} whole graph vs compacted kernels path", graph,
                  map_chunk(x, arrays, cfg, use_kernels=True))
        log(f"[perread] {key} ms_fixed chunk 0: cheap_phase_vmap launches "
            f"{out['launches'][f'{key} perread cheap']}, equals the fused "
            f"ladder and the reference plan; the whole graph launches "
            f"{launches}, route {routes}, equals the reference plan's and "
            f"the compacted kernels path ({int(graph.mapped.sum())} mapped)")
        if key != "D5":
            continue
        for i in range(MAP_READ_READS):
            K.reset_launches()
            res, cnt = map_read(x[i], arrays, cfg, kern)
            torch.cuda.synchronize()
            check_once(f"D5 map_read {i}", dict(K.LAUNCHES), PERREAD_PATH)
            for f, g in (("t_start", res.t_start), ("score", res.score),
                         ("mapped", res.mapped)):
                assert_equal(f"D5 map_read {i} {f}", g, getattr(graph, f)[i])
            assert_equal(f"D5 map_read {i} n_events", cnt["n_events"],
                         graph.n_events[i])
        log(f"[perread] D5 map_read of reads 0..{MAP_READ_READS - 1}: each "
            f"launches {list(PERREAD_PATH)} once and equals its row of the "
            "whole-graph chunk")
        times = {
            "whole graph (map_chunk, chain_compaction off)":
                window(lambda: map_chunk(x, arrays, cfg_g, use_kernels=True)),
            "cheap_phase_vmap": window(
                lambda: pipeline.cheap_phase_vmap(x, arrays, cfg, kern)),
            "shipped ladder (map_chunk)":
                window(lambda: map_chunk(x, arrays, cfg, use_kernels=True)),
        }
        K.reset_launches()
        out["d5_ms_fixed_ms"] = times
        log(f"[perread] D5 ms_fixed chunk of {CHUNK} reads, median pass of "
            f"a {WINDOW_S:.0f} s window (fastest-slowest), {smi}: "
            + "; ".join(f"{k} {v['median_ms']:.3f} ms ({v['fastest_ms']:.3f}"
                        f"-{v['slowest_ms']:.3f}, {v['passes']} passes)"
                        for k, v in times.items()))
    cfg, _, reads, index = data["D5"]
    arrays = index_arrays(index, dev)
    x = torch.from_numpy(reads.signals[:CHUNK]).to(dev)
    for mode in FLOAT_MODES:
        cfg_m = cfg.with_mode(mode)
        torch.cuda.synchronize()
        K.reset_launches()
        got = pipeline.cheap_phase_vmap(
            x, arrays, cfg_m, stages.resolve_plan(cfg_m, stages.KERNELS))
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        check_once(f"D5 {mode} cheap_phase_vmap", launches, PERREAD_FLOAT)
        out["launches"][f"D5 {mode} perread cheap"] = launches
        equal_cheap(f"D5 {mode} cheap_phase_vmap vs reference plan", got,
                    pipeline.cheap_phase_vmap(x, arrays, cfg_m,
                                              stages.resolve_plan(
                                                  cfg_m, stages.REFERENCE)))
        log(f"[perread] D5 {mode} chunk 0: cheap_phase_vmap launches "
            f"{launches}, equals the reference plan's")
    K.reset_launches()
    return out


# ---- the out-of-core tiered index -----------------------------------------
TIERS = 16
# (label, Mapper arguments beyond backend="tiered", tiles=TIERS)
TIERED_RUNS = (("16 slots", dict(cache_slots=16)),
               ("4 slots", dict(cache_slots=4)),
               ("4 slots random +4 replicas",
                dict(cache_slots=4, cache_policy="random", cache_seed=1,
                     cache_replicas=4)),
               ("16 slots no pre-pass reuse",
                dict(cache_slots=16, reuse_prepass=False)))
TIERED_FLOAT_READS = 1024
# read errors and bit flips that the retries heal, then a tile that
# corrupts on every attempt
HEALED_FAULTS = dict(seed=7, p_read_error=0.3, p_corrupt=0.3)
TIERED_SERVE_ARGS = ("--dataset", "D1", "--streams", "16",
                     "--reads-per-stream", "16", "--chunk", "32",
                     "--early-term", "--fault-plan", "0", "--tiles",
                     str(TIERS), "--cache-slots", "4")


def chunked(mapper, sig, prefetch=False):
    """``Mapper.map_signals``'s stream kept chunk by chunk (with the tiered
    index's prefetch of the next chunk's tiles when asked)."""
    import torch
    from repro_torch.core import driver
    pre = None
    if prefetch:
        cache, cfg, plan = mapper.cache, mapper.cfg, mapper.plan
        pre = lambda s, nv: cache.prefetch(s, cfg, plan)  # noqa: E731
    out = list(driver.stream_map(mapper.chunk_fn(),
                                 driver.array_chunks(sig, CHUNK),
                                 prefetch=pre))
    torch.cuda.synchronize()
    return out


def equal_chunks(label, got, want) -> None:
    """Every chunk's MapOutput fields and counters equal."""
    import numpy as np
    if [c[:2] for c in got] != [c[:2] for c in want]:
        raise AssertionError(f"{label}: chunk lists differ")
    for (ci, _, g), (_, _, w) in zip(got, want):
        for f in ("t_start", "score", "mapped", "n_events"):
            gf, wf = getattr(g, f), getattr(w, f)
            if gf.dtype != wf.dtype or not np.array_equal(gf, wf):
                raise AssertionError(f"{label}: chunk {ci} {f} differs")
        if g.counters != w.counters:
            raise AssertionError(f"{label}: chunk {ci} counters differ: "
                                 f"{g.counters} vs {w.counters}")


def page_in_times(cache, dev):
    """One tile's page-in (both planes) into a device slot, from the
    cache's pinned host tiles and from pageable copies of them, by CUDA
    events over 20 back-to-back copies."""
    import numpy as np
    import torch
    reps = 20
    t = 0
    dst_b, dst_e = cache._dev_bstart[0], cache._dev_ent[:, 0]
    out = {}
    for kind in ("pinned", "pageable"):
        src_b, src_e = cache._host_bstart[t], cache._host_ent[t]
        if kind == "pageable":
            src_b = torch.from_numpy(np.array(src_b.numpy()))
            src_e = torch.from_numpy(np.array(src_e.numpy()))
        pinned = src_b.is_pinned() and src_e.is_pinned()
        if pinned != (kind == "pinned"):
            raise AssertionError(f"page-in source {kind}: is_pinned "
                                 f"{pinned}")

        def copy():
            dst_b.copy_(src_b, non_blocking=pinned)
            dst_e[0].copy_(src_e[0], non_blocking=pinned)
            dst_e[1].copy_(src_e[1], non_blocking=pinned)
        copy()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            copy()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        out[kind] = dict(ms=ms, gb_per_s=cache.tiered.tile_nbytes / ms / 1e6)
    torch.cuda.synchronize()
    if not (torch.equal(dst_b.cpu(), cache._host_bstart[t])
            and torch.equal(dst_e.cpu(), cache._host_ent[t])):
        raise AssertionError("page-in: the slot does not hold the tile")
    return out


def timed_chain(fn):
    """Run ``fn`` with the chain phase (``pipeline._chain_outputs``) timed
    between synchronisations; returns (fn's result, chain seconds)."""
    import torch
    from repro_torch.core import pipeline
    inner, spent = pipeline._chain_outputs, [0.0]

    def chain(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out
    pipeline._chain_outputs = chain
    try:
        return fn(), spent[0]
    finally:
        pipeline._chain_outputs = inner


def phase_tiered(data, dev):
    """The tiered index on the card: the streaming build at D5, the tiered
    Mapper in four cache setups and in ms_float against the resident
    kernels plan chunk by chunk, healed and sticky faults, and the
    launcher's --fault-plan path against the same run on the CPU.  No
    hand-written kernel may launch in a tiered run."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import FaultPlan, Mapper, TileReadError, stages
    from repro_torch.core import tiered
    from repro_torch.core.index import build_index_streaming, tier_index
    from repro_torch.launch import serve_rsga
    cfg, ref, reads, index = data["D5"]
    res = {}

    # the streaming build against tier_index(build_index(...))
    t0 = time.time()
    want = tier_index(index, TIERS)
    t_tier = time.time() - t0
    t0 = time.time()
    got = build_index_streaming(ref.events_concat, ref.n_events, cfg, TIERS)
    t_stream = time.time() - t0
    for name in ("tile_bucket_start", "tile_entries_packed",
                 "tile_n_entries", "tile_checksums"):
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"tiered build: {name} differs")
    res["build"] = dict(tiles=TIERS, entries=got.n_entries,
                        buckets_per_tile=got.buckets_per_tile,
                        emax=got.emax, tile_nbytes=got.tile_nbytes,
                        host_nbytes=got.nbytes, streaming_s=t_stream,
                        tier_index_s=t_tier)
    log(f"[tiered] D5 build: {TIERS} tiles of {got.buckets_per_tile} "
        f"buckets, {got.n_entries} entries, emax {got.emax} "
        f"({got.tile_nbytes / 1e6:.2f} MB a tile); build_index_streaming "
        f"{t_stream:.1f} s equals tier_index(build_index) ({t_tier:.1f} s) "
        f"byte for byte, CRCs included")

    # the resident index: the kernels plan (what every tiered run must
    # equal) and the reference plan (the tiered plan's own stages)
    sig = reads.signals
    resident_k = Mapper(index, cfg, use_kernels=True, device=dev)
    chunked(resident_k, sig[:CHUNK])                 # warm
    want = chunked(resident_k, sig)
    resident_r = Mapper(index, cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    (plain, chain_s) = timed_chain(lambda: chunked(resident_r, sig))
    wall_r = time.time() - t0
    peak_r = torch.cuda.max_memory_allocated()
    equal_chunks("D5 resident reference plan vs kernels plan", plain, want)
    res["resident_reference"] = dict(
        seconds=wall_r, reads_per_s=READS / wall_r, chain_s=chain_s,
        chain_share=chain_s / wall_r, max_memory_allocated=peak_r)
    log(f"[tiered] D5 resident index, reference plan: {READS} reads in "
        f"{wall_r:.2f} s ({READS / wall_r:.1f} reads/s; chain phase "
        f"{chain_s:.2f} s, {100 * chain_s / wall_r:.1f}% of the wall), "
        f"peak {peak_r / 1e6:.1f} MB; equals the kernels plan")

    runs = {}
    for label, kw in TIERED_RUNS:
        m = Mapper(index, cfg, backend="tiered", tiles=TIERS, device=dev,
                   **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.time()
        (out, chain_s) = timed_chain(lambda: chunked(m, sig, prefetch=True))
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"tiered {label}", launches, ())
        equal_chunks(f"D5 tiered {label}", out, want)
        c = m.cache
        n = c.n_chunks
        runs[label] = r = dict(
            seconds=wall, reads_per_s=READS / wall, chain_s=chain_s,
            chain_share=chain_s / wall, max_memory_allocated=peak,
            n_chunks=n, hits=c.hits, misses=c.misses,
            hit_rate=c.hit_rate, paged_bytes=c.paged_bytes,
            paged_bytes_per_chunk=c.paged_bytes / n,
            replica_loads=c.replica_loads, replica_bytes=c.replica_bytes,
            tiles_per_chunk=(c.hits + c.misses) / n,
            cache_nbytes=c.cache_nbytes, launches=launches)
        log(f"[tiered] D5 {label}: {READS} reads in {wall:.2f} s "
            f"({READS / wall:.1f} reads/s; chain phase {chain_s:.2f} s, "
            f"{100 * chain_s / wall:.1f}%), {n} chunks touching "
            f"{r['tiles_per_chunk']:.2f} tiles each, hit rate "
            f"{c.hit_rate:.3f}, paged {c.paged_bytes / n / 1e6:.2f} MB a "
            f"chunk (+{c.replica_bytes / 1e6:.2f} MB replicas), peak "
            f"{peak / 1e6:.1f} MB; no kernel launched; every chunk equals "
            f"the resident kernels plan")
    res["runs"] = runs

    # the pre-pass and the page-ins, timed
    m = Mapper(index, cfg, backend="tiered", tiles=TIERS, cache_slots=4,
               device=dev)
    x = torch.from_numpy(sig[:CHUNK]).to(dev)
    res["prepass_ms"] = wall_ms(
        lambda: tiered.prepass(x, cfg, m.plan, TIERS), 10)
    res["page_in"] = page_in_times(m.cache, dev)
    pin, pag = res["page_in"]["pinned"], res["page_in"]["pageable"]
    log(f"[tiered] pre-pass {res['prepass_ms']:.3f} ms a chunk of {CHUNK} "
        f"(host clock, its histogram's sync included); one tile's page-in "
        f"({m.cache.tiered.tile_nbytes / 1e6:.2f} MB): pinned "
        f"{pin['ms']:.4f} ms ({pin['gb_per_s']:.1f} GB/s), pageable "
        f"{pag['ms']:.4f} ms ({pag['gb_per_s']:.1f} GB/s)")

    # ms_float: the tiered plan's reference detection with the reference
    # segment sum, against the resident kernels plan
    cfg_f = cfg.with_mode("ms_float")
    sig_f = sig[:TIERED_FLOAT_READS]
    want_f = chunked(Mapper(index, cfg_f, use_kernels=True, device=dev),
                     sig_f)
    m = Mapper(index, cfg_f, backend="tiered", tiles=TIERS, cache_slots=4,
               device=dev)
    K.reset_launches()
    t0 = time.time()
    out = chunked(m, sig_f, prefetch=True)
    wall = time.time() - t0
    check_launches("tiered ms_float", dict(K.LAUNCHES), ())
    equal_chunks("D5 tiered ms_float", out, want_f)
    res["float"] = dict(reads=TIERED_FLOAT_READS, seconds=wall,
                        hit_rate=m.cache.hit_rate)
    log(f"[tiered] D5 ms_float: {TIERED_FLOAT_READS} reads in {wall:.2f} s,"
        f" no kernel launched; every chunk equals the resident kernels "
        f"plan")

    # faults: healed by the retries, then sticky
    sig_h = sig[:TIERED_FLOAT_READS]
    m = Mapper(index, cfg, backend="tiered", tiles=TIERS, cache_slots=4,
               fault_plan=FaultPlan(**HEALED_FAULTS), cache_retries=32,
               device=dev)
    K.reset_launches()
    out = chunked(m, sig_h, prefetch=True)
    check_launches("tiered faults", dict(K.LAUNCHES), ())
    equal_chunks("D5 tiered healed faults", out,
                 want[:TIERED_FLOAT_READS // CHUNK])
    c = m.cache
    if not (c.retries > 0 and c.corruptions > 0):
        raise AssertionError(f"tiered faults: retries {c.retries}, "
                             f"corruptions {c.corruptions}")
    res["faults"] = dict(plan=HEALED_FAULTS, retries=c.retries,
                         corruptions=c.corruptions,
                         vtime_penalty=c.vtime_penalty)
    m = Mapper(index, cfg, backend="tiered", tiles=TIERS, cache_slots=4,
               fault_plan=FaultPlan(seed=1, sticky_corrupt_tiles=range(
                   TIERS)), device=dev)
    try:
        chunked(m, sig_h, prefetch=True)
    except TileReadError as e:
        sticky = str(e)
    else:
        raise AssertionError("tiered sticky corruption: no TileReadError")
    res["faults"]["sticky"] = dict(error=sticky,
                                   corruptions=m.cache.corruptions)
    log(f"[tiered] faults {HEALED_FAULTS}: healed ({c.retries} retries, "
        f"{c.corruptions} corruptions caught, {c.vtime_penalty:.2f} virtual "
        f"units lost), outputs equal; sticky corruption raised "
        f"TileReadError ({sticky})")

    # the launcher's --fault-plan path, on the card and on the CPU
    K.reset_launches()
    served = serve_rsga.run(list(TIERED_SERVE_ARGS))
    torch.cuda.synchronize()
    check_launches("tiered serve", dict(K.LAUNCHES), ())
    host = serve_rsga.run(list(TIERED_SERVE_ARGS) + ["--device", "cpu"])
    sd, sd_cpu = served.driver, host.driver
    if driver_state(sd) != driver_state(sd_cpu):
        raise AssertionError("tiered serve: the card's driver state differs "
                             "from the CPU's")
    storage = [(d.mapper.cache.misses, d.mapper.cache.retries,
                d.mapper.cache.corruptions, d.mapper.cache.vtime_penalty,
                d.mapper.cache.hits) for d in (sd, sd_cpu)]
    if storage[0] != storage[1] or sd.counters.get("n_reads", 0) <= 0:
        raise AssertionError(f"tiered serve: [storage] {storage}")
    res["serve"] = dict(args=list(TIERED_SERVE_ARGS), wall_s=served.wall_s,
                        cpu_wall_s=host.wall_s, n_chunks=sd.n_chunks,
                        virtual_makespan=sd.clock,
                        storage=dict(zip(("misses", "retries",
                                          "corruptions", "vtime_penalty",
                                          "hits"), storage[0])))
    log(f"[tiered] serve_rsga {' '.join(TIERED_SERVE_ARGS)}: card "
        f"{served.wall_s:.2f} s, CPU {host.wall_s:.2f} s, {sd.n_chunks} "
        f"chunks, virtual makespan {sd.clock:.2f}; driver state and "
        f"[storage] counts equal the CPU run's {res['serve']['storage']}")
    K.reset_launches()
    return res


def event_detect_edges(label, xq, cfg, dev):
    """event_detect against its plain version on reads built to break it:
    all-zero reads (one event), levels of alternating sign (more
    boundaries than E: the E-1 clamp), rows of 1000 and 1001 samples (not
    a multiple of the thread count; rows not 16-byte aligned), of 3 samples
    (under one thread's run) and of 3072 (three passes of the shipped
    instance)."""
    import numpy as np
    import torch
    from repro_torch.core import events
    from repro_torch.kernels.event_detect import ops as ed_ops
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    E, S = cfg.max_events, xq.shape[1]
    rng = np.random.default_rng(2)
    levels = rng.uniform(0.8, 2.0, (64, S // 5 + 1)) * np.where(
        np.arange(S // 5 + 1) % 2, 1.0, -1.0)
    sig = np.repeat(levels, 5, axis=1)[:, :S] + rng.normal(0, .01, (64, S))
    edges = {
        "all zero": torch.zeros_like(xq[:64]),
        "alternating levels": events.early_quantize(
            torch.from_numpy(sig.astype(np.float32)).to(dev), cfg),
        "S=1000": xq[:, :1000].contiguous(),
        "S=1001": xq[:, :1001].contiguous(),
        "S=3": xq[:, :3].contiguous(),
        "S=3072": torch.cat([xq, xq.flip(0), xq.roll(7, 0)], 1).contiguous()}
    for name, x in edges.items():
        got = ed_ops.event_detect_rows(x, cfg)
        want = event_detect_rows_ref(x, cfg)
        torch.cuda.synchronize()
        for n, g, w in zip(("means", "n_events"), got, want):
            assert_equal(f"event_detect {label} {name} {n}", g, w)
        if name == "all zero" and not bool((want[1] == 1).all()):
            raise AssertionError("event_detect edge: all-zero reads must "
                                 "hold one event")
        if name == "alternating levels" and not bool((want[1] == E).all()):
            raise AssertionError("event_detect edge: alternating levels "
                                 "must fill all E events")
    log(f"[kernels] event_detect {label} instance equal on edge reads: "
        + ", ".join(f"{n} ({x.shape[0]} x {x.shape[1]})"
                    for n, x in edges.items()))


def query_indices(xq, c, bs, ent):
    """The indices the query issues for the reads ``xq``: the stacked
    (bucket, bucket + 1) offsets into ``bucket_start`` and the H entry
    columns from each bucket's start."""
    import torch
    from repro_torch.core import hashing, quantization, seeding
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    means, nev = event_detect_rows_ref(xq, c)
    valid = torch.arange(c.max_events, device=xq.device) < nev.unsqueeze(-1)
    keys, _ = hashing.pack_seeds(quantization.quantize_events(means, valid,
                                                              c), nev, c)
    bucket = (keys & (c.n_buckets - 1)).to(torch.int32)
    bidx = torch.stack([bucket, bucket + 1])
    idx = torch.clamp(seeding._take_clip(bs, bidx)[0].unsqueeze(-1)
                      + torch.arange(c.max_hits_per_seed, dtype=torch.int32,
                                     device=xq.device),
                      max=ent.shape[1] - 1)
    return bidx, idx


def pluto_lookup_edges(table, dev):
    """pluto_lookup against its plain version on indices far outside
    [0, N-1], at Q = 1, 7 and 196,609 (odd: one query left over), and on an
    index view at storage offset 1."""
    import torch
    from repro_torch.kernels.pluto_lookup import ops as pl_ops
    from repro_torch.kernels.pluto_lookup.ref import lookup_ref
    g = torch.Generator().manual_seed(15)
    edges = {f"Q={q}": torch.randint(-2**31, 2**31 - 1, (q,), generator=g,
                                     dtype=torch.int32).to(dev)
             for q in (1, 7, 196_609)}
    edges["offset 1"] = torch.randint(
        -1000, table.numel() + 1000, (196_610,), generator=g,
        dtype=torch.int32).to(dev)[1:]
    for name, i in edges.items():
        got = pl_ops.lookup(table, i)
        torch.cuda.synchronize()
        assert_equal(f"pluto_lookup {name}", got, lookup_ref(table, i))
    log(f"[kernels] pluto_lookup equal on edge indices: "
        + ", ".join(edges))


def launch_floor(dev):
    """Mean device time of an empty kernel over 20 back-to-back launches
    (time_ms, as the kernels are timed): one CTA of 32 threads, and at the
    grids of event_detect (512 CTAs of 256) and pluto_lookup (192 of
    256) on a D5 chunk."""
    import torch
    from repro_torch.kernels import build
    lib = build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty(blocks, threads):
        build.check(lib.repro_empty_launch(blocks, threads, stream),
                    "empty kernel")
    out = {f"{b}x{n}": time_ms(lambda: empty(b, n), 20)
           for b, n in ((1, 32), (512, 256), (192, 256))}
    log(f"[kernels] launch floor: empty kernel " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def phase_new_kernels(cfg, reads, index, dev):
    """event_detect, the two lookups and the segment_sum helper against
    their plain versions on D5's first chunk, timed with their bounds and
    the library call that computes the same function."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import events
    from repro_torch.core.index import index_arrays
    from repro_torch.kernels.event_detect import ops as ed_ops
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    from repro_torch.kernels.pluto_lookup import ops as pl_ops
    from repro_torch.kernels.pluto_lookup.ref import lookup_ref
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref

    arrays = index_arrays(index, dev)
    bs, ent = arrays["bucket_start"], arrays["entries_packed"]
    R, E = CHUNK, cfg.max_events
    xq = events.early_quantize(torch.from_numpy(reads.signals[:R]).to(dev),
                               cfg)
    S = xq.shape[1]
    results = {}

    # ---- event_detect: the shipped windows' instance and the generic one --
    ed_shapes = []
    for label, c in (("shipped", cfg),
                     ("generic", cfg.replace(tstat_window=3, peak_window=2))):
        got = ed_ops.event_detect_rows(xq, c)
        want = event_detect_rows_ref(xq, c)
        torch.cuda.synchronize()
        err = max(assert_equal(f"event_detect {label} {n}", g, w)
                  for n, g, w in zip(("means", "n_events"), got, want))
        k_ms = time_ms(lambda: ed_ops.event_detect_rows(xq, c), 20)
        p_ms = time_ms(lambda: event_detect_rows_ref(xq, c), 5)
        b_ms, b_by = event_detect_bound(R, S, c)
        ed_shapes.append(dict(
            route=label, on_main_path=label == "shipped",
            shape=f"D5 chunk 0: xq ({R}, {S}) int32 -> means ({R}, {E}), "
                  f"tw={c.tstat_window}, peak_r={c.peak_window}",
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))
        log(f"[kernels] event_detect {label} instance (tw={c.tstat_window}, "
            f"peak_r={c.peak_window}) equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})")
        event_detect_edges(label, xq, c, dev)
    results["event_detect"] = dict(ed_shapes[0], by_shape=ed_shapes)

    # ---- the two lookups, on the indices D5's query issues ----------------
    bidx, idx = query_indices(xq, cfg, bs, ent)
    pluto_lookup_edges(bs, dev)
    for name, table, i in (("pluto_lookup", bs, bidx),
                           ("pluto_lookup_rows", ent, idx)):
        got = pl_ops.lookup(table, i)
        want_l = lookup_ref(table, i)
        torch.cuda.synchronize()
        err = assert_equal(name, got, want_l)
        flat = i.reshape(-1).contiguous()
        (b_ms, b_by), Q, n_words = lookup_bound(table, i)
        k_ms = time_ms(lambda: pl_ops.lookup(table, i), 20)
        p_ms = time_ms(lambda: lookup_ref(table, i), 20)
        if table.ndim == 1:
            flat64 = flat.to(torch.int64)      # take wants int64 indices
            l_ms = time_ms(lambda: torch.take(table, flat64), 20)
            lib = "torch.take"
        else:
            l_ms = time_ms(lambda: table.index_select(1, flat), 20)
            lib = "index_select"
        results[name] = dict(
            shape=f"D5 chunk 0: table {tuple(table.shape)}, {Q} indices "
                  f"({n_words} distinct)", max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
            library=lib)
        seq = ""
        if table.ndim == 1:
            # the same kernel on as many sequential indices: every gather
            # coalesced, the two dependent loads and the launch left
            ar = torch.arange(Q, dtype=torch.int32, device=dev) % len(table)
            results[name]["sequential_ms"] = s_ms = time_ms(
                lambda: pl_ops.lookup(table, ar), 20)
            seq = f", on {Q} sequential indices {s_ms:.4f} ms"
        log(f"[kernels] {name} equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, {lib} {l_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}){seq}")

    # ---- segment_sum, on D5 chunk 0's ms_float and rh2 detections --------
    seg_shapes = []
    sig = torch.from_numpy(reads.signals[:R]).to(dev)
    x_f = events.dequantize_fixed(xq, cfg.frac_bits)
    x_r = events.robust_normalize(sig)
    for mode, x in (("ms_float", x_f), ("rh2", x_r)):
        eid = events._event_ids(
            events.boundary_mask_float(x, cfg.with_mode(mode)), E)
        got = ss_ops.segment_sum(x, eid, E, S)
        want_s = segment_sum_ref(x, eid, E, S)
        torch.cuda.synchronize()
        err = max(assert_equal(f"segment_sum {mode} {n}", g, w)
                  for n, g, w in zip(("sums", "counts"), got, want_s))
        k_ms = time_ms(lambda: ss_ops.segment_sum(x, eid, E, S), 20)
        p_ms = time_ms(lambda: segment_sum_ref(x, eid, E, S), 2)
        flat_e = (eid + E * torch.arange(R, device=dev, dtype=torch.int32)[
            :, None]).reshape(-1)
        flat_x = x.reshape(-1)
        l_ms = time_ms(lambda: torch.zeros(R * E, device=dev).index_add_(
            0, flat_e, flat_x), 20)
        b_ms, b_by = segment_sum_bound(R, S, E)
        longest = int(max(torch.unique_consecutive(r, return_counts=True)[1]
                          .max() for r in eid.cpu()))
        seg_shapes.append(dict(
            route=mode, on_main_path=True,
            shape=f"D5 chunk 0 ({mode}): x ({R}, {S}) f32 -> ({R}, {E}), "
                  f"longest run {longest}",
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=l_ms,
            library="index_add_ (atomic order)"))
        log(f"[kernels] segment_sum {mode} equal (longest run {longest}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, index_add_ "
            f"{l_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    results["segment_sum"] = dict(seg_shapes[0], by_shape=seg_shapes)
    K.reset_launches()
    return results


def device_busy(prof, trace_name: str):
    """The device's busy seconds in a profiled pass (the union of its
    kernel, copy and memset intervals in the exported trace; the sum of
    every op's self device time would count a kernel under its aten op
    and again under its own name) and {kernel: (count, device us)}.  The
    trace goes to ``chiprun_out/trace_name``."""
    import gzip
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / trace_name
    prof.export_chrome_trace(str(path))
    with (gzip.open if trace_name.endswith(".gz") else open)(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans, by_kernel = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            t, d = float(e["ts"]), float(e.get("dur", 0))
            spans.append((t, t + d))
            n, us = by_kernel.get(e["name"], (0, 0.0))
            by_kernel[e["name"]] = (n + 1, us + d)
    busy_us, end = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy_us / 1e6, by_kernel


def profile_summary(prof, wall: float, label: str, n_chunks: int,
                    trace_name: str) -> dict:
    """What one profiled pass shows: the device's busy time
    (``device_busy``), device time by kernel, host time by op, kernel
    launches and stream syncs.  The trace goes to
    ``chiprun_out/trace_name``."""
    busy, by_kernel = device_busy(prof, trace_name)
    ev = prof.key_averages()
    calls = {e.key: e.count for e in ev}
    syncs = calls.get("cudaStreamSynchronize", 0)
    launches = calls.get("cudaLaunchKernel", 0)
    log(f"[profile] {label}: wall {wall * 1e3:.3f} ms under the profiler, "
        f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%), "
        f"{syncs} stream syncs and {launches} kernel launches for "
        f"{n_chunks} chunks")
    for name, (n, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1]
                                )[:12]:
        log(f"[profile]   device {us / 1e3:9.3f} ms  x{n:<5} {name[:90]}")
    for e in sorted(ev, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5} {e.key[:90]}")
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                n_chunks=n_chunks, stream_syncs=syncs,
                kernel_launches=launches)


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
    return profile_summary(prof, wall, f"{key} {cfg.mode}", READS // CHUNK,
                           f"trace_{key}_{cfg.mode}.json")


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
    out["entry_points"] = entry_points()
    return out


# The port's examples and scripts on the card, each through its ``main``
# (module under src/repro_torch, arguments); smoke_core at a small size,
# the fault sweep at 5 plans
ENTRY_POINTS = (
    ("examples.quickstart", ("--use-kernels",)),
    ("examples.map_reads_e2e", ("--use-kernels",)),
    ("scripts.kernel_support", ()),
    ("scripts.smoke_core", ("20000", "32", "--use-kernels")),
    ("scripts.smoke_ssdmodel", ("--use-kernels",)),
    ("scripts.fault_sweep", ("--plans", "5")),
)


def entry_points() -> dict:
    """Each of ENTRY_POINTS on the card (``--device`` left at its default,
    cuda): ``main`` must return 0 or None (map_reads_e2e returns its
    accuracy dict) and raise nothing; its printed lines are kept in the
    record and its last line logged."""
    import contextlib
    import importlib
    import io
    out = {}
    for name, args in ENTRY_POINTS:
        mod = importlib.import_module(f"repro_torch.{name}")
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(args))
        lines = buf.getvalue().splitlines()
        if rc not in (0, None) and not isinstance(rc, dict):
            raise AssertionError(f"{name} {args}: exit {rc}; {lines[-3:]}")
        out[name] = dict(args=list(args), lines=lines,
                         seconds=time.time() - t0)
        log(f"[launcher] python -m repro_torch.{name} {' '.join(args)}: "
            f"exit 0 in {time.time() - t0:.1f} s; last line: {lines[-1]}")
    return out


# ---- serving ---------------------------------------------------------------
SERVE_CHUNK = 32
SERVE_ARGS = ("--streams", "32", "--reads-per-stream", "64", "--chunk",
              str(SERVE_CHUNK), "--early-term")
# (dataset, mode, the launcher's arguments beyond SERVE_ARGS)
SERVE_RUNS = (("D5", "ms_fixed", ("--load", "0.7")),
              ("D5", "ms_fixed", ("--load", "1.3", "--shed", "--tenants", "4",
                                  "--skew", "1.0")),
              ("D1", "ms_fixed", ("--load", "0.7")),
              ("D1", "ms_fixed", ("--load", "1.3", "--shed", "--tenants", "4",
                                  "--skew", "1.0")),
              ("D5", "ms_float", ("--load", "0.7")))
PREFIXES = (256, 512, 768, 1024)


def driver_state(sd) -> str:
    """Everything a serving run decides — every stream's state and report,
    the class and tenant reports, the event trace, the virtual clock, the
    chunk counts and the summed counters — as one JSON text with sorted
    keys (floats by their shortest repr, so equal text is equal bits; NaN
    and inf included)."""
    import dataclasses
    return json.dumps(dict(
        streams={k: dataclasses.asdict(v) for k, v in sd._streams.items()},
        report={k: dataclasses.asdict(v) for k, v in sd.report().items()},
        classes={str(k): dataclasses.asdict(v)
                 for k, v in sd.class_report().items()},
        tenants={str(k): dataclasses.asdict(v)
                 for k, v in sd.tenant_report().items()},
        events=sd.events, clock=sd.clock, counters=sd.counters,
        n_chunks=sd.n_chunks, n_pad_rows=sd.n_pad_rows, n_shed=sd.n_shed),
        sort_keys=True)


def check_stage_plans(label, mapper, stages_):
    """The backend each ladder stage resolved to: the full-length config's
    plan at every prefix, with every stage a kernel can take on a kernel
    for ms_fixed and the fused kernel engaged (detect stays on the
    reference in the float modes, and the fused kernel off, as in the JAX
    package's plan)."""
    from repro_torch.core import stages as stages_mod
    from repro_torch.core.realtime import stage_cfg
    full = dict(mapper.plan)
    fixed = mapper.cfg.mode == "ms_fixed"
    want_ref = {"quantize", "seed", "vote", "finalize"} | (
        set() if fixed else {"detect"})
    out = {}
    for L in stages_:
        m = mapper.with_cfg(stage_cfg(mapper.cfg, L))
        plan = dict(m.plan)
        out[L] = plan
        fell = [k for k, v in plan.items()
                if (v == "reference") != (k in want_ref)]
        fused = stages_mod.fused_cheap_backend(m.plan, m.cfg) is not None
        if plan != full or fell or fused != fixed:
            raise AssertionError(f"{label}: the stage at {L} samples "
                                 f"resolved {plan} (full length: {full}; "
                                 f"off the expected backend: {fell}; "
                                 f"fused kernel engaged: {fused})")
    log(f"[serve] {label}: every ladder stage {list(stages_)} resolved "
        f"{full}")
    return out


def serve_run(key, mode, extra, dev):
    """One run of the serving launcher (``serve_rsga.run``, the kernels
    plan) with launch and route counts zeroed just before and read just
    after; the same trace through the reference plan on the card must give
    the same driver state, and every admitted read the result
    ``map_realtime`` gives it."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import Mapper, ServeDriver, pipeline
    from repro_torch.core.realtime import map_realtime
    from repro_torch.launch import serve_rsga
    label = f"{key} {mode} {' '.join(extra)}"
    argv = ["--dataset", key, "--mode", mode, *SERVE_ARGS, *extra,
            "--use-kernels"]
    torch.cuda.synchronize()
    K.reset_launches()
    pipeline.CHAIN_ROUTES.clear()
    served = serve_rsga.run(argv)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    routes = dict(pipeline.CHAIN_ROUTES)
    sd = served.driver
    check_launches(f"serve {label}", launches,
                   FUSED_PATH if mode == "ms_fixed" else FLOAT_PATH)
    plans = check_stage_plans(label, sd.mapper, sd.stages)

    # the same trace through the reference plan, on the card
    K.reset_launches()
    plain = ServeDriver(Mapper(served.index, served.cfg, use_kernels=False,
                               device=dev), **served.serve_kw)
    t0 = time.time()
    plain.serve_trace(served.trace)
    plain_wall = time.time() - t0
    check_launches(f"serve {label} reference plan", K.LAUNCHES, ())
    if driver_state(sd) != driver_state(plain):
        raise AssertionError(f"serve {label}: the kernels plan's driver "
                             "state differs from the reference plan's")

    # every admitted read against map_realtime on the same reads: trace
    # row k (arrival order) carries read k
    rt = map_realtime(served.reads.signals, served.index, served.cfg,
                      chunk=SERVE_CHUNK, use_kernels=True, device=dev)
    rows = {}
    for k, row in enumerate(served.trace):
        rows.setdefault(row[1], []).append(k)
    n_checked = 0
    for sid, ks in rows.items():
        st, out = sd.stream(sid), sd.results(sid)
        adm = np.asarray(st.admitted)
        ks = np.asarray(ks)[adm]
        for f, got in (("t_start", out.t_start[adm]),
                       ("score", out.score[adm]),
                       ("mapped", out.mapped[adm]),
                       ("samples_used", np.asarray(st.samples_used)[adm]),
                       ("stage_of", np.asarray(st.stage_of)[adm])):
            if not np.array_equal(got, getattr(rt, f)[ks]):
                raise AssertionError(f"serve {label}: stream {sid} {f} "
                                     "differs from map_realtime")
        n_checked += int(adm.sum())
    K.reset_launches()

    n_reads = len(served.trace)
    lat = np.asarray([x for st in sd._streams.values()
                      for x, a in zip(st.latency, st.admitted)
                      if a and math.isfinite(x)])
    if not n_checked or sd.counters.get("n_reads", 0) <= 0:
        raise AssertionError(f"serve {label}: no read was served")
    res = dict(
        dataset=key, mode=mode, args=list(extra), reads=n_reads,
        streams=len(rows), chunk=SERVE_CHUNK, wall_s=served.wall_s,
        reads_per_s=n_reads / served.wall_s,
        streams_per_s=len(rows) / served.wall_s,
        plain_wall_s=plain_wall, virtual_makespan=sd.clock,
        p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99)),
        n_chunks=sd.n_chunks, n_pad_rows=sd.n_pad_rows, n_shed=sd.n_shed,
        mapped=int(sum(r.n_mapped for r in served.reports.values())),
        checked_against_map_realtime=n_checked, launches=launches,
        launches_per_chunk=sum(launches.values()) / sd.n_chunks,
        chain_routes={f"{b}/{r}x{w}": n
                      for (b, r, w), n in sorted(routes.items())},
        stage_plans={str(k): v for k, v in plans.items()},
        counters=sd.counters)
    log(f"[serve] {label}: {n_reads} reads over {len(rows)} streams in "
        f"{served.wall_s:.3f} s wall ({res['reads_per_s']:.1f} reads/s, "
        f"{res['streams_per_s']:.2f} streams/s; reference plan "
        f"{plain_wall:.1f} s), {sd.n_chunks} chunks of {SERVE_CHUNK} "
        f"({sd.n_pad_rows} pad rows), {sd.n_shed} shed, virtual makespan "
        f"{sd.clock:.2f}, p50 {res['p50']:.3f} p99 {res['p99']:.3f} "
        f"(virtual units); kernel launches {launches} "
        f"({res['launches_per_chunk']:.2f} a chunk); equals the reference "
        f"plan and map_realtime ({n_checked} admitted reads)")
    log(f"[serve] {label}: chain routes {res['chain_routes']}")
    return res, served


def serve_profile(served, dev):
    """torch.profiler over one more pass of the served trace through a
    warmed kernels-plan driver (``profile_summary``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.core import Mapper, ServeDriver
    mapper = Mapper(served.index, served.cfg, use_kernels=True, device=dev)
    ServeDriver(mapper, **served.serve_kw).serve_trace(served.trace[:64])
    torch.cuda.synchronize()
    sd = ServeDriver(mapper, **served.serve_kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        sd.serve_trace(served.trace)
        torch.cuda.synchronize()
        wall = time.time() - t0
    K.reset_launches()
    # gzipped: a serving pass holds some 45,000 launches
    out = profile_summary(prof, wall, f"serve D5 {served.cfg.mode}",
                          sd.n_chunks, "trace_serve_D5.json.gz")
    log(f"[profile] serve D5 {served.cfg.mode}: "
        f"{out['kernel_launches'] / sd.n_chunks:.1f} kernel launches and "
        f"{out['stream_syncs'] / sd.n_chunks:.2f} stream syncs a chunk")
    return out


def serve_kernels(cfg, reads, index, dev):
    """Every kernel against its plain version at the serving shapes: one
    chunk of SERVE_CHUNK D5 reads cut to each ladder prefix
    (``stage_cfg``: S = 256..1024 samples, E = 51..192 events), the sort
    and the DP on the inputs ``map_chunk`` hands them there, the lookups
    on the indices its query issues and the segment sum on its ms_float
    detection.  Tolerance: exact.  Returns each kernel's records, one a
    prefix."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import events, map_chunk, pipeline
    from repro_torch.core.index import index_arrays
    from repro_torch.core.realtime import stage_cfg
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref
    from repro_torch.kernels.chain_dp import ops as dp_ops
    from repro_torch.kernels.chain_dp.ref import chain_dp_ref
    from repro_torch.kernels.cheap_fused import ops as cf_ops
    from repro_torch.kernels.cheap_fused.ref import cheap_fused_rows_ref
    from repro_torch.kernels.event_detect import ops as ed_ops
    from repro_torch.kernels.event_detect.ref import event_detect_rows_ref
    from repro_torch.kernels.pluto_lookup import ops as pl_ops
    from repro_torch.kernels.pluto_lookup.ref import lookup_ref
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.kernels.segment_sum.ref import segment_sum_ref

    arrays = index_arrays(index, dev)
    bs, ent = arrays["bucket_start"], arrays["entries_packed"]
    R = SERVE_CHUNK
    captured = capture_backends()
    out = {k: [] for k in K.LAUNCHES}

    def record(name, label, got, want, fn, plain, reps, b, lib=None,
               lib_name=None):
        torch.cuda.synchronize()
        err = max(assert_equal(f"serve {name} {label} {i}", g, w)
                  for i, (g, w) in enumerate(zip(got, want)))
        k_ms = time_ms(fn, 20)
        p_ms = time_ms(plain, reps)
        l_ms = time_ms(lib, 20) if lib is not None else None
        out[name].append(dict(route=f"serve {label}", on_main_path=True,
                              shape=label, max_abs_err=err, ms=k_ms,
                              plain_ms=p_ms, bound_ms=b[0], bound_by=b[1],
                              library_ms=l_ms, library=lib_name))
        log(f"[serve-kernels] {name} {label} equal; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms"
            + (f", {lib_name} {l_ms:.4f} ms" if lib is not None else "")
            + f", bound {b[0]:.5f} ms ({b[1]})")

    for L in PREFIXES:
        c = stage_cfg(cfg, L)
        E = c.max_events
        sig = torch.from_numpy(reads.signals[:R, :L].copy()).to(dev)
        xq = events.early_quantize(sig, c)
        tag = f"L={L}: ({R}, {L}), E={E}"
        record("cheap_fused", tag,
               cf_ops.cheap_fused_rows(xq, bs, ent, c),
               cheap_fused_rows_ref(xq, bs, ent, c),
               lambda: cf_ops.cheap_fused_rows(xq, bs, ent, c),
               lambda: cheap_fused_rows_ref(xq, bs, ent, c), 3,
               cheap_fused_bound(xq, bs, ent, c))
        record("event_detect", tag, ed_ops.event_detect_rows(xq, c),
               event_detect_rows_ref(xq, c),
               lambda: ed_ops.event_detect_rows(xq, c),
               lambda: event_detect_rows_ref(xq, c), 5,
               event_detect_bound(R, L, c))

        # the sort and the DP on the inputs this prefix's chunk gives them
        captured.clear()
        pipeline.CHAIN_ROUTES.clear()
        map_chunk(sig, arrays, c, plan=capture_plan(c))
        torch.cuda.synchronize()
        (branch, n_rows, width), = pipeline.CHAIN_ROUTES
        if "sort" in captured:
            rows, = captured["sort"]
            sq, st, sv = captured["dp"]
            rt = f"{tag}, route {branch}/{n_rows}x{width}"
            record("bitonic_sort", rt, (sort_ops.sort_rows(rows),),
                   (sort_rows_ref(rows),),
                   lambda: sort_ops.sort_rows(rows),
                   lambda: sort_rows_ref(rows), 20, sort_bound(*rows.shape),
                   lambda: torch.sort(rows, dim=-1), "torch.sort")
            record("chain_dp", rt, dp_ops.chain_dp(sq, st, sv, c),
                   chain_dp_ref(sq, st, sv, c),
                   lambda: dp_ops.chain_dp(sq, st, sv, c),
                   lambda: chain_dp_ref(sq, st, sv, c), 1,
                   dp_bound(*sq.shape, c.chain_band))

        # the float modes' kernels at this prefix's shapes: the lookups on
        # the indices its query issues, the segment sum on its ms_float
        # detection
        bidx, idx = query_indices(xq, c, bs, ent)
        for name, table, i, lib_name in (
                ("pluto_lookup", bs, bidx, "torch.take"),
                ("pluto_lookup_rows", ent, idx, "index_select")):
            flat = i.reshape(-1).contiguous()
            flat64 = flat.to(torch.int64)
            lib = ((lambda: torch.take(table, flat64)) if table.ndim == 1
                   else (lambda: table.index_select(1, flat)))
            record(name, tag, (pl_ops.lookup(table, i),),
                   (lookup_ref(table, i),),
                   lambda: pl_ops.lookup(table, i),
                   lambda: lookup_ref(table, i), 20,
                   lookup_bound(table, i)[0], lib, lib_name)
        cf = c.with_mode("ms_float")
        x_f = events.dequantize_fixed(xq, cf.frac_bits)
        eid = events._event_ids(events.boundary_mask_float(x_f, cf), E)
        flat_e = (eid + E * torch.arange(R, device=dev, dtype=torch.int32)[
            :, None]).reshape(-1)
        record("segment_sum", tag, ss_ops.segment_sum(x_f, eid, E, L),
               segment_sum_ref(x_f, eid, E, L),
               lambda: ss_ops.segment_sum(x_f, eid, E, L),
               lambda: segment_sum_ref(x_f, eid, E, L), 2,
               segment_sum_bound(R, L, E),
               lambda: torch.zeros(R * E, device=dev).index_add_(
                   0, flat_e, x_f.reshape(-1)), "index_add_ (atomic order)")
    K.reset_launches()
    return out


def phase_serve(data, dev):
    """The serving path: every run of SERVE_RUNS through the launcher, a
    profiled pass of the first (D5) run's trace, and the kernels at the
    serving shapes."""
    runs, first = {}, None
    for key, mode, extra in SERVE_RUNS:
        res, served = serve_run(key, mode, extra, dev)
        runs[f"{key} {mode} {' '.join(extra)}"] = res
        first = first or served
    profile_ = serve_profile(first, dev)
    cfg, _, reads, index = data["D5"]
    return dict(runs=runs, profile=profile_,
                kernels=serve_kernels(cfg, reads, index, dev))


# The sharded phase: a (2, 2) ('data', 'model') mesh of 4 gloo ranks sharing
# the card (NCCL refuses two ranks on one device); on a host with 2 or more
# cards also one NCCL rank a card.  The kernels plan maps READS reads; ring,
# a2a and the tiered plan SHARDED_READS (their plain DP is host-paced); the
# serving trace is D1's, 8 streams x 16 reads in chunks of 32 (8 rows a rank).
SHARDED_MESH = ((2, 2), ("data", "model"))
SHARDED_READS = 1024
SHARDED_TILES, SHARDED_SLOTS = 16, 4
SHARDED_SERVE_ARGS = ("--dataset", "D1", "--mode", "ms_fixed", "--streams",
                      "8", "--reads-per-stream", "16", "--chunk", "32",
                      "--early-term", "--load", "0.7")
# (run name, Mapper arguments, reads, the kernels it launches)
SHARDED_RUNS = (("kernels", dict(use_kernels=True), READS, FUSED_PATH),
                ("ring", dict(backend="ring"), SHARDED_READS, ()),
                ("a2a", dict(backend="a2a"), SHARDED_READS, ()),
                ("tiered", dict(backend="tiered", tiles=SHARDED_TILES,
                                cache_slots=SHARDED_SLOTS), SHARDED_READS,
                 ()))


def host_out(out):
    """A chunk's MapOutput as numpy fields and int counters."""
    return ({f: getattr(out, f).cpu().numpy()
             for f in ("t_start", "score", "mapped", "n_events")},
            {k: int(v) for k, v in out.counters.items()})


def timed_chunks(fn, sig, n_reads):
    """Each chunk of ``sig[:n_reads]`` through ``fn`` (host outputs), the
    host-clock seconds of the whole run and of each chunk (the output's
    copy to the host ends each)."""
    import torch
    outs, walls = [], []
    t0 = time.perf_counter()
    for i in range(0, n_reads, CHUNK):
        t1 = time.perf_counter()
        outs.append(host_out(fn(sig[i:i + CHUNK], CHUNK)))
        walls.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, walls


def sharded_rank(job):
    """One rank of the sharded phase (spawned by ``run_ranks``): every run
    of SHARDED_RUNS chunk by chunk, and the serving trace through the
    kernels plan and a2a, with the launches, chain routes, collective
    bytes and staging time of each, and the rank's peak device memory."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import Mapper, ServeDriver, pipeline
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*job["mesh"], backend=job["backend"])
    # first use of every collective outside the counted runs (NCCL builds
    # a group's communicator at its first collective)
    z = torch.zeros(mesh.shape["model"], dtype=torch.int32,
                    device=mesh.device)
    mesh.ring_shift([z], "model")
    mesh.all_to_all(z, "model")
    mesh.all_reduce_sum(mesh.all_gather_rows(z))
    cfg, index, sig = job["cfg"], job["index"], job["signals"]
    res = dict(rank=mesh.rank, coords=mesh.coords, backend=mesh.backend,
               device=str(mesh.device),
               card=torch.cuda.get_device_name(mesh.device), runs={},
               serve={})

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launches()
        pipeline.CHAIN_ROUTES.clear()
        mesh.stats.clear()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        out, wall, chunk_walls = fn()
        return dict(out=out, wall_s=wall, chunk_walls=chunk_walls,
                    launches=dict(K.LAUNCHES),
                    routes={f"{b}/{r}x{w}": n for (b, r, w), n
                            in sorted(pipeline.CHAIN_ROUTES.items())},
                    stats=dict(mesh.stats),
                    peak=torch.cuda.max_memory_allocated(mesh.device))

    for name, kw, n_reads, _ in SHARDED_RUNS:
        fn = Mapper(index, cfg, mesh=mesh, **kw).chunk_fn()
        if name == "kernels":
            fn(sig[:CHUNK], CHUNK)         # warm: the library, the allocator
        res["runs"][name] = counted(lambda: timed_chunks(fn, sig, n_reads))
    for name in ("kernels", "a2a"):
        sd = ServeDriver(Mapper(job["d1_index"], job["d1_cfg"], backend=name,
                                mesh=mesh), **job["serve_kw"])

        def serve():
            t0 = time.perf_counter()
            sd.serve_trace(job["trace"])
            torch.cuda.synchronize()
            return driver_state(sd), time.perf_counter() - t0, None
        res["serve"][name] = counted(serve)
        res["serve"][name]["n_chunks"] = sd.n_chunks
    # where a kernels-plan chunk's time goes on each rank, after the
    # counted runs: the plan at run_ranks' pinned thread count, at the
    # parent's, and pinned again, then pinned under torch.profiler
    fn = Mapper(index, cfg, mesh=mesh, use_kernels=True).chunk_fn()
    pinned = torch.get_num_threads()
    res["threads"] = []
    for n in (pinned, job["threads"], pinned):
        torch.set_num_threads(n)
        _, wall, cw = timed_chunks(fn, sig, READS)
        res["threads"].append(dict(threads=n, wall_s=wall, chunk_walls=cw))
    torch.set_num_threads(pinned)
    res["profile"] = profile_rank(
        mesh, fn, sig, f"trace_sharded_{mesh.backend}_rank{mesh.rank}.json.gz")
    return res


def profile_rank(mesh, fn, sig, trace_name) -> dict:
    """One rank's kernels-plan pass over READS reads under torch.profiler,
    split on the rank's host clock: inside collective calls (under gloo
    the whole exchange, waits on slower peers included), staging copies,
    blocked on the rank's own device (stream syncs and blocking copies),
    and the rest (host dispatch); beside it the device's busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    mesh.stats.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, cw = timed_chunks(fn, sig, READS)
    stats = dict(mesh.stats)
    busy, by_kernel = device_busy(prof, trace_name)
    host = {e.key: (e.count, e.self_cpu_time_total / 1e3)
            for e in prof.key_averages()}
    blocked = sum(host.get(k, (0, 0.0))[1] for k in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpyAsync"))
    coll = 1e3 * sum(v for k, v in stats.items()
                     if k.endswith("_s") and k != "staging_s")
    staging = 1e3 * stats.get("staging_s", 0.0)
    return dict(
        wall_ms=wall * 1e3, chunk_walls_ms=[w * 1e3 for w in cw],
        device_busy_ms=busy * 1e3, collective_ms=coll, staging_ms=staging,
        blocked_ms=blocked, rest_ms=wall * 1e3 - coll - staging - blocked,
        kernel_launches=host.get("cudaLaunchKernel", (0, 0.0))[0],
        top_host_ops=[(k, n, ms) for k, (n, ms) in sorted(
            host.items(), key=lambda kv: -kv[1][1])[:8]],
        top_kernels=[(k[:60], n, us / 1e3) for k, (n, us) in sorted(
            by_kernel.items(), key=lambda kv: -kv[1][1])[:5]])


def check_sharded(label, outs, solo, runs_solo):
    """Every rank's chunks equal the single-device run's, and each run
    launched exactly its kernels on every rank."""
    for r in outs:
        for name, _, n_reads, expected in SHARDED_RUNS:
            got = r["runs"][name]
            check_launches(f"{label} rank {r['rank']} {name}",
                           got["launches"], expected)
            want = solo[runs_solo[name]]
            if (len(got["out"]) != n_reads // CHUNK
                    or not chunks_equal(got["out"], want)):
                raise AssertionError(f"{label} rank {r['rank']} {name}: "
                                     "chunks differ from the single device")
        for name in ("kernels", "a2a"):
            got = r["serve"][name]
            check_launches(f"{label} rank {r['rank']} serve {name}",
                           got["launches"],
                           FUSED_PATH if name == "kernels" else ())
            if got["out"] != solo["serve"]:
                raise AssertionError(f"{label} rank {r['rank']} serve "
                                     f"{name}: driver state differs from "
                                     "the single device's")


def chunks_equal(got, want) -> bool:
    """Chunk by chunk (as many as ``got`` holds), every field (dtype, shape
    and values) and every counter equal."""
    import numpy as np
    return len(got) <= len(want) and all(
        g[1] == w[1] and all(g[0][f].dtype == w[0][f].dtype
                             and np.array_equal(g[0][f], w[0][f])
                             for f in w[0])
        for g, w in zip(got, want))


def sharded_report(label, outs, walls, spawn_s):
    """Log and return what one mesh run measured: reads/s of each run
    against the single device's, collective bytes a chunk by kind, host
    staging a chunk, peak memory and backend per rank."""
    rows = {}
    for name, _, n_reads, _ in [*SHARDED_RUNS,
                                ("serve kernels", None, None, None),
                                ("serve a2a", None, None, None)]:
        per = [r["serve"][name.split()[1]] if name.startswith("serve")
               else r["runs"][name] for r in outs]
        n_chunks = (per[0]["n_chunks"] if name.startswith("serve")
                    else n_reads // CHUNK)
        wall = max(p["wall_s"] for p in per)
        stats = per[0]["stats"]
        by_kind = {k[:-6]: stats[k] / n_chunks for k in sorted(stats)
                   if k.endswith("_bytes") and k != "staged_bytes"}
        coll_ms = 1e3 * sum(stats.get(f"{k}_s", 0.0)
                            for k in by_kind) / n_chunks
        cw = per[0]["chunk_walls"]
        row = dict(
            wall_s=wall, solo_wall_s=walls.get(name),
            reads_per_s=None if n_reads is None else n_reads / wall,
            solo_reads_per_s=(None if n_reads is None
                              else n_reads / walls[name]),
            chunks=n_chunks, bytes_per_chunk=by_kind,
            staged_bytes_per_chunk=stats.get("staged_bytes", 0) / n_chunks,
            staging_ms_per_chunk=stats.get("staging_s", 0.0) / n_chunks
            * 1e3,
            collective_ms_per_chunk=coll_ms,
            chunk_walls_rank0=cw,
            peak_bytes_by_rank=[p["peak"] for p in per],
            routes_rank0=per[0]["routes"],
            launches_by_rank=[p["launches"] for p in per])
        rows[name] = row
        rate = ("" if n_reads is None else
                f"{row['reads_per_s']:.1f} reads/s (single device "
                f"{row['solo_reads_per_s']:.1f}), ")
        log(f"[sharded] {label} {name}: {rate}{wall:.3f} s wall for "
            f"{n_chunks} chunks (single device {walls.get(name, 0):.3f} s); "
            f"collective bytes a chunk a rank {by_kind}; staged "
            f"{row['staged_bytes_per_chunk']:.0f} B and "
            f"{row['staging_ms_per_chunk']:.3f} ms a chunk; "
            f"{coll_ms:.3f} ms a chunk in collective calls (rank 0)"
            + ("" if cw is None else
               f", chunk walls {[round(w * 1e3, 2) for w in cw]} ms")
            + "; peak "
            f"{[round(p / 1e6, 1) for p in row['peak_bytes_by_rank']]} MB "
            "by rank")
    for r in outs:
        p, th = r["profile"], r["threads"]
        log(f"[sharded-profile] {label} rank {r['rank']}: "
            f"{READS // CHUNK} kernels-plan chunks in {p['wall_ms']:.3f} ms "
            f"under torch.profiler (host clock): inside collective calls "
            f"{p['collective_ms']:.3f}, staging {p['staging_ms']:.3f}, "
            f"blocked on its device {p['blocked_ms']:.3f}, the rest (host "
            f"dispatch) {p['rest_ms']:.3f}; device busy "
            f"{p['device_busy_ms']:.3f} ms, {p['kernel_launches']} "
            f"launches; chunk walls "
            f"{[round(w, 2) for w in p['chunk_walls_ms']]} ms; unprofiled "
            "walls at "
            + ", ".join(f"{t['threads']} threads {t['wall_s'] * 1e3:.3f} ms"
                        for t in th)
            + "; top host ops "
            + ", ".join(f"{k} x{n} {ms:.2f} ms"
                        for k, n, ms in p["top_host_ops"]))
    log(f"[sharded] {label}: backends {sorted({r['backend'] for r in outs})}"
        f", devices {[r['device'] for r in outs]}, ranks spawned and joined "
        f"in {spawn_s:.1f} s; every rank equals the single device chunk by "
        "chunk, the serving driver state included")
    return dict(backend=outs[0]["backend"], ranks=len(outs),
                coords=[r["coords"] for r in outs], spawn_s=spawn_s,
                runs=rows, profile_by_rank=[r["profile"] for r in outs],
                threads_by_rank=[r["threads"] for r in outs])


def phase_sharded(data, dev):
    """The sharded mapper (``Mapper(mesh=...)``) on 4 gloo ranks sharing the
    card, and on one NCCL rank a card where the host has 2 or more: every
    rank must equal the single-device run chunk by chunk (computed here
    first), the kernels plan must launch its kernels on every rank and the
    other plans none, and the serving driver state must equal the single
    device's."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import Mapper
    from repro_torch.launch import serve_rsga
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.core import ServeDriver
    cfg, _, reads, index = data["D5"]
    sig = reads.signals
    # the single-device runs, each plan's own where it has one (ring and a2a
    # have none: they are held against the reference plan)
    solo, solo_walls = {}, {}
    for name, kw, n_reads in (
            ("kernels", dict(use_kernels=True), READS),
            ("reference", {}, SHARDED_READS),
            ("tiered", dict(backend="tiered", tiles=SHARDED_TILES,
                            cache_slots=SHARDED_SLOTS), SHARDED_READS)):
        fn = Mapper(index, cfg, device=dev, **kw).chunk_fn()
        if name == "kernels":
            fn(sig[:CHUNK], CHUNK)
        solo[name], solo_walls[name], _ = timed_chunks(fn, sig, n_reads)
    for name in ("reference", "tiered"):
        if not chunks_equal(solo[name], solo["kernels"]):
            raise AssertionError(f"single device: the {name} plan differs "
                                 "from the kernels plan")
    served = serve_rsga.run([*SHARDED_SERVE_ARGS, "--use-kernels"])
    solo["serve"] = driver_state(served.driver)
    plain = ServeDriver(Mapper(served.index, served.cfg, device=dev),
                        **served.serve_kw)
    t0 = time.perf_counter()
    plain.serve_trace(served.trace)
    torch.cuda.synchronize()
    if driver_state(plain) != solo["serve"]:
        raise AssertionError("single device: the serving driver states of "
                             "the kernels and reference plans differ")
    walls = {"kernels": solo_walls["kernels"],
             "ring": solo_walls["reference"], "a2a": solo_walls["reference"],
             "tiered": solo_walls["tiered"],
             "serve kernels": served.wall_s,
             "serve a2a": time.perf_counter() - t0}
    K.reset_launches()
    job = dict(mesh=SHARDED_MESH, backend="gloo", cfg=cfg, index=index,
               signals=sig, d1_index=served.index, d1_cfg=served.cfg,
               serve_kw=served.serve_kw, trace=served.trace,
               threads=torch.get_num_threads())
    # which single-device run each sharded run is held against
    runs_solo = {"kernels": "kernels", "ring": "reference",
                 "a2a": "reference", "tiered": "tiered"}
    out = {}
    t0 = time.time()
    outs = run_ranks(sharded_rank, 4, job, backend="gloo", timeout=600)
    spawn_s = time.time() - t0
    check_sharded("gloo (2, 2)", outs, solo, runs_solo)
    out["gloo"] = sharded_report("gloo (2, 2)", outs, walls, spawn_s)
    n = torch.cuda.device_count() // 2 * 2
    if n >= 2:
        shape = (n // 2, 2)
        t0 = time.time()
        outs_n = run_ranks(sharded_rank, n,
                           dict(job, mesh=(shape, SHARDED_MESH[1]),
                                backend="nccl"),
                           backend="nccl", timeout=600)
        check_sharded(f"nccl {shape}", outs_n, solo, runs_solo)
        out["nccl"] = sharded_report(f"nccl {shape}", outs_n, walls,
                                     time.time() - t0)
    else:
        log("[sharded] one card: no NCCL run (NCCL needs a card per rank)")
    out["rank_launches"] = [r["runs"]["kernels"]["launches"] for r in outs]
    return out


# ---- the paper's evaluation ------------------------------------------------
PAPER_MODES = ("rh2", "ms_float", "ms_fixed")
PAPER_KEYS = ("counters", "accuracy", "index_bytes", "bench_bytes_raw",
              "n_reads")
SIM_FIGURES = ("fig11", "fig12", "fig13")
CALIBRATE_ARGS = dict(chunk=8, load_fracs=(0.3, 0.5, 0.7), n_reads=96)


def paper_path(cfg):
    """The kernels a config's kernels plan launches: the fused path where
    ``cheap_fused`` admits it, else the per-stage float path."""
    from repro_torch.core import stages
    plan = stages.resolve_plan(cfg, stages.KERNELS)
    return FUSED_PATH if stages.fused_cheap_backend(plan, cfg) else FLOAT_PATH


def equal_record(label, rec, want) -> None:
    for k in PAPER_KEYS:
        if rec[k] != want[k]:
            raise AssertionError(f"{label}: {k} differs from the JAX "
                                 f"package's record: {rec[k]} vs {want[k]}")


def equal_outputs(label, got, want) -> None:
    """Two host ``MapOutput``s equal bit for bit, field and counter."""
    for f in ("t_start", "score", "mapped", "n_events"):
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype != w.dtype or g.shape != w.shape or \
                g.tobytes() != w.tobytes():
            raise AssertionError(f"{label}: {f} differs between the "
                                 "kernels and the reference plan")
    if got.counters != want.counters:
        raise AssertionError(f"{label}: counters differ: {got.counters} "
                             f"vs {want.counters}")




def paper_reads(dev):
    """Every (dataset, mode) record's reads (D2-D4 new to the card): mapped
    in chunks of 32, every read of the kernels plan equals the reference
    plan's on the card.  Then the kernels plan maps the record's reads
    again and again for ``WINDOW_S`` seconds (``window``: at least
    ``MIN_PASSES`` passes, each ended by a device sync): reads/s of
    the median pass with the fastest and slowest, on the host clock."""
    from repro_torch.core import Mapper, build_index
    from repro_torch.signal import datasets
    rates = {}
    for ds, spec in datasets.DATASETS.items():
        for mode in PAPER_MODES:
            cfg = datasets.config_for(spec).with_mode(mode)
            ref, reads = datasets.build(spec, cfg)
            index = build_index(ref.events_concat, ref.n_events, cfg)
            kern, plain = (Mapper(index, cfg, use_kernels=k, device=dev)
                           for k in (True, False))
            equal_outputs(f"paper {ds} {mode}",
                          kern.map_signals(reads.signals, chunk=32),
                          plain.map_signals(reads.signals, chunk=32))
            w = window(lambda: kern.map_signals(reads.signals, chunk=32))
            n = len(reads.signals)
            rates[f"{ds} {mode}"] = dict(
                n_reads=n, passes=w["passes"],
                reads_per_s=n / w["median_ms"] * 1e3,
                fastest_reads_per_s=n / w["fastest_ms"] * 1e3,
                slowest_reads_per_s=n / w["slowest_ms"] * 1e3)
    log("[paper] D1-D5, each mode, chunks of 32: every read's outputs and "
        "the counters of the kernels plan equal the reference plan's")
    log("[paper] kernels plan reads/s (median of a "
        f"{WINDOW_S:.0f} s window, slowest-fastest pass): " + "; ".join(
            f"{k} {v['reads_per_s']:.1f} ({v['slowest_reads_per_s']:.1f}-"
            f"{v['fastest_reads_per_s']:.1f}, {v['passes']} passes)"
            for k, v in rates.items()))
    return rates


def phase_paper(dev):
    """The paper's evaluation (``repro_torch.benchmarks``) on the card: Table
    3 maps all 15 (dataset, mode) records under the reference plan into a
    fresh record cache, then the kernels plan maps them again (launch
    counts zeroed just before each run, read just after); every record of
    both plans must equal the JAX package's (``jax_records.json``).  Every
    table and figure module (Figs. 11-13 under both cost models) then runs
    from those records and each ``derived`` field must equal the JAX
    package's; the serving calibration through the kernels plan must give
    the host CPU's rows (virtual-clock numbers that do not depend on the
    mapped outputs, so the calibration mapper's reads are held against the
    host's as well); ``bench_sim.check`` must pass on the committed
    ``BENCH_sim.json``.  Every record's reads (D2-D4 new to the card) and
    the filter ablation's five variants: every read mapped under the
    kernels plan must equal the reference plan's; the kernels plan's
    reads/s come from a timed window of repeated passes."""
    import shutil
    import torch
    from repro_torch import kernels as K
    from repro_torch.benchmarks import (bench_sim, calibrate_serving, common,
                                        run as paper_run)
    from repro_torch.core import MarsConfig
    from repro_torch.examples import filter_ablation
    from repro_torch.signal import datasets
    golden = json.loads((pathlib.Path(common.__file__).parent
                         / "jax_records.json").read_text())
    cache = ROOT / "build" / "paper_records"
    shutil.rmtree(cache, ignore_errors=True)
    common.CACHE, common._CALIB_CACHE = cache, {}
    keys = [(ds, m) for ds in datasets.DATASETS for m in PAPER_MODES]
    out = dict(records={}, launches={})

    # the reference plan, as Table 3 runs it (emit follows each record)
    table3, peaks = [], []

    def emit(line):
        table3.append(line)
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # what earlier phases still hold: every peak below includes it
    out["allocated_before"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.time()
    paper_run.MODULES["table3"].run(emit, device=dev)
    ref_s = time.time() - t0
    check_launches("paper reference plan", K.LAUNCHES, ())
    for (ds, mode), peak in zip(keys, peaks):
        rec = common.pipeline_run(ds, mode, device=dev)
        equal_record(f"paper {ds} {mode} reference plan", rec,
                     golden["records"][f"{ds}/{mode}"])
        out["records"][f"{ds} {mode} reference"] = dict(
            f1=rec["accuracy"]["f1"], max_memory_allocated=peak,
            index_bytes=rec["index_bytes"])
    log(f"[paper] reference plan: 15 records equal the JAX package's "
        f"({ref_s:.1f} s)")

    # the kernels plan: the path's kernels on every record
    t0 = time.time()
    for ds, mode in keys:
        cfg = datasets.config_for(datasets.DATASETS[ds]).with_mode(mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        rec = common.pipeline_run(ds, mode, backend="kernels", device=dev)
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"paper {ds} {mode} kernels plan", launches,
                       paper_path(cfg))
        equal_record(f"paper {ds} {mode} kernels plan", rec,
                     golden["records"][f"{ds}/{mode}"])
        out["launches"][f"paper {ds} {mode}"] = launches
        out["records"][f"{ds} {mode} kernels"] = dict(
            f1=rec["accuracy"]["f1"], max_memory_allocated=peak,
            index_bytes=rec["index_bytes"], launches=launches)
    K.reset_launches()
    kern_s = time.time() - t0
    log(f"[paper] kernels plan: 15 records equal the JAX package's, each "
        f"launching its path's kernels ({kern_s:.1f} s)")
    t0 = time.time()
    out["throughput"] = paper_reads(dev)
    reads_s = time.time() - t0

    # every table and figure from those records
    lines = {"analytic": [], "sim": []}
    for key, mod in paper_run.MODULES.items():
        mod.run(lines["analytic"].append, device=dev)
    for key in SIM_FIGURES:
        paper_run.MODULES[key].run(lines["sim"].append, model="sim",
                                   device=dev)
    for model, got in lines.items():
        derived = dict((ln.split(",", 2)[0], ln.split(",", 2)[2])
                       for ln in got)
        if derived != golden["derived"][model]:
            bad = sorted(k for k in set(derived) | set(golden["derived"][
                model]) if derived.get(k) != golden["derived"][model].get(k))
            raise AssertionError(f"paper: {model} CSV derived fields differ "
                                 f"from the JAX package's: {bad}")
    out["csv"] = lines
    log(f"[paper] {len(lines['analytic'])} CSV lines (analytic) and "
        f"{len(lines['sim'])} (sim): every derived field equals the JAX "
        "package's")

    # the serving calibration: the card's kernels plan against the host.
    # Its rows are virtual-clock numbers that no mapped output changes, so
    # the kernels are held on the calibration's reads themselves
    t0 = time.time()
    card_m = calibrate_serving.default_mapper(device=dev, use_kernels=True)
    host_m = calibrate_serving.default_mapper(device="cpu", use_kernels=True)
    sig = calibrate_serving.mapper_signals(card_m, CALIBRATE_ARGS["n_reads"],
                                           1)
    K.reset_launches()
    mapped = card_m.map_signals(sig, chunk=CALIBRATE_ARGS["chunk"])
    check_launches("paper calibration mapper", K.LAUNCHES,
                   paper_path(card_m.cfg))
    K.reset_launches()
    equal_outputs("paper calibration mapper", mapped,
                  host_m.map_signals(sig, chunk=CALIBRATE_ARGS["chunk"]))
    rows = calibrate_serving.calibrate(card_m, **CALIBRATE_ARGS)
    host = calibrate_serving.calibrate(host_m, **CALIBRATE_ARGS)
    if rows != host:
        raise AssertionError(f"paper: calibration rows differ from the "
                             f"host's: {rows} vs {host}")
    out["calibrate"] = rows
    log(f"[paper] calibration mapper: every read on the card equals the "
        f"host's; rows (virtual clock) equal the host's: p50 ratio "
        f"{[round(r['p50_ratio'], 4) for r in rows]} at loads "
        f"{CALIBRATE_ARGS['load_fracs']} ({time.time() - t0:.1f} s)")

    if bench_sim.check(bench_sim.BASELINE) != 0:
        raise AssertionError("paper: bench_sim.check failed on the "
                             "committed BENCH_sim.json")
    log("[paper] bench_sim.check: 0 on the committed BENCH_sim.json")

    # the filter ablation at the example's size, both plans on the card
    t0 = time.time()
    ablation = {}
    ref, reads = filter_ablation.inputs()
    for name, kw in filter_ablation.VARIANTS.items():
        K.reset_launches()
        mapped, got = filter_ablation.map_variant(name, ref, reads,
                                                  "kernels", dev)
        launches = dict(K.LAUNCHES)
        check_launches(f"paper ablation {name}", launches,
                       paper_path(MarsConfig().replace(**kw)))
        K.reset_launches()
        mapped_ref, want = filter_ablation.map_variant(name, ref, reads,
                                                       "reference", dev)
        check_launches(f"paper ablation {name} reference", K.LAUNCHES, ())
        equal_outputs(f"paper ablation {name}", mapped, mapped_ref)
        if got != want:
            raise AssertionError(f"paper ablation {name}: kernels plan "
                                 f"{got} vs reference plan {want}")
        out["launches"][f"paper ablation {name}"] = launches
        ablation[name] = got
        log(f"[paper] ablation {name}: P={got['precision']:.3f} "
            f"R={got['recall']:.3f} F1={got['f1']:.3f} anchors "
            f"{got['n_anchors_postvote']} dp_pairs {got['n_dp_pairs']}; "
            f"every read of the kernels plan equals the reference plan")
    K.reset_launches()
    out["ablation"] = ablation
    out["seconds"] = dict(reference=ref_s, kernels=kern_s, reads=reads_s,
                          ablation=time.time() - t0)
    out["table3"] = table3
    return out


def main() -> int:
    try:
        return run()
    finally:
        if LOG_LINES:
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            (out / "chip_smoke.log").write_text("\n".join(LOG_LINES) + "\n")


def run() -> int:
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

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t0
        log(f"[phase] {name} {seconds[name]:.1f} s")
        return out

    name, smi = timed("device", phase_device)
    build_record = timed("build", phase_build)
    data = timed("datasets", lambda: {k: make_dataset(k)
                                      for k in ("D1", "D5")})
    if "--sharded-only" in sys.argv[1:]:
        # the sharded phase alone (on a host of several cards, its NCCL
        # run); no kernels line and no result line
        sharded = timed("sharded", phase_sharded, data, dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_sharded.json").write_text(json.dumps(
            dict(device=name, nvidia_smi=smi, sharded=sharded,
                 phase_seconds=seconds), indent=1, default=str))
        log(smi)
        return 0
    maps = timed("map", lambda: {k: run_map(k, *data[k], dev)
                                 for k in ("D1", "D5")})
    floats = timed("float", phase_float, data, dev)
    perstage = timed("perstage", phase_perstage, data, dev)
    perread = timed("perread", phase_perread, data, dev, smi)
    tiered_ = timed("tiered", phase_tiered, data, dev)
    main_routes = {(k, b, w) for k in maps
                   for (b, _, w) in maps[k]["route_keys"]}
    inputs, routes = timed("routes", phase_routes, data, dev)
    kern = timed("kernels", phase_kernels,
                 *[data["D5"][i] for i in (0, 2, 3)], inputs, main_routes,
                 dev)
    kern.update(timed("kernels (per-stage and float)", phase_new_kernels,
                      *[data["D5"][i] for i in (0, 2, 3)], dev))
    floor = timed("launch floor", launch_floor, dev)

    def profiles():
        for k in maps:
            maps[k]["profile"] = phase_profile(k, *data[k], dev)
        for mode in FLOAT_MODES:
            cfg, ref, reads, index = data["D5"]
            floats[f"D5 {mode}"]["profile"] = phase_profile(
                "D5", cfg.with_mode(mode), ref, reads, index, dev)
    timed("profile", profiles)
    launcher = timed("launcher", phase_launcher)
    serve = timed("serve", phase_serve, data, dev)
    sharded = timed("sharded", phase_sharded, data, dev)
    paper = timed("paper", phase_paper, dev)

    # name: (source, the TPU kernel it replaces, the run whose launches
    # count: the main path that drives it)
    runs = {**{f"{d} ms_fixed": maps[d]["launches"] for d in maps},
            **{k: v["launches"] for k, v in floats.items()},
            **{f"{d} per-stage": v["launches"] for d, v in perstage.items()},
            **perread["launches"],
            **{f"D5 tiered {k}": v["launches"]
               for k, v in tiered_["runs"].items()},
            **{f"serve {k}": v["launches"]
               for k, v in serve["runs"].items()},
            **{f"sharded kernels rank {r}": v
               for r, v in enumerate(sharded["rank_launches"])},
            **paper["launches"]}
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
            sharded_launches=[v[k] for v in sharded["rank_launches"]],
            equal=True, max_abs_err=r["max_abs_err"], ms=r["ms"],
            kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            floor_ms=floor["1x32"], sequential_ms=r.get("sequential_ms"),
            library_ms=r["library_ms"], library=r.get("library"),
            shape=r["shape"], by_shape=r.get("by_shape"),
            serving_shapes=serve["kernels"][k],
            helper=k == "segment_sum"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(device=name, nvidia_smi=smi, build=build_record, kernels=summary,
             library_routes=dict(sort_rows_library=kern["sort_rows_library"]),
             launch_floor_ms=floor, map=maps,
             float=floats, perstage=perstage, perread=perread,
             tiered=tiered_,
             launcher=launcher,
             routes=routes, serve=serve, sharded=sharded, paper=paper,
             phase_seconds=seconds,
             seconds=time.time() - t_all),
        indent=1,
        default=str))
    log(f"[map-summary] " + json.dumps(
        {name_: {k: res[k] for k in ("reads_per_s", "f1",
                                     "max_memory_allocated")}
         for name_, res in [*((f"{d} ms_fixed", maps[d]) for d in maps),
                            *floats.items()]}))
    log("[tiered-summary] " + json.dumps(dict(
        card=smi, resident_reference=tiered_["resident_reference"],
        runs={k: {f: v[f] for f in ("reads_per_s", "chain_share",
                                    "hit_rate", "paged_bytes_per_chunk",
                                    "max_memory_allocated")}
              for k, v in tiered_["runs"].items()},
        prepass_ms=tiered_["prepass_ms"], page_in=tiered_["page_in"])))
    log(f"[serve-summary] " + json.dumps(
        {k: {f: v[f] for f in ("reads_per_s", "streams_per_s",
                               "virtual_makespan", "p50", "p99",
                               "launches_per_chunk")}
         for k, v in serve["runs"].items()}))
    log("[sharded-summary] " + json.dumps(dict(
        card=smi, **{b: {k: {f: v[f] for f in (
            "reads_per_s", "solo_reads_per_s", "bytes_per_chunk",
            "staging_ms_per_chunk", "peak_bytes_by_rank")}
            for k, v in sharded[b]["runs"].items()}
            for b in ("gloo", "nccl") if b in sharded})))
    log("[perread-summary] " + json.dumps(dict(
        card=smi, d5_ms_fixed_ms=perread["d5_ms_fixed_ms"],
        launches=perread["launches"], seconds=seconds["perread"])))
    log("[paper-summary] " + json.dumps(dict(
        card=smi, records=paper["records"],
        kernels_reads_per_s=paper["throughput"], table3=paper["table3"],
        allocated_before=paper["allocated_before"],
        seconds=seconds["paper"])))
    log(f"[seconds] {time.time() - t_all:.1f}")
    log(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
