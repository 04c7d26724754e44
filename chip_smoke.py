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
               band kernel at B = 1, 16, 31, 33, 64, 65, 128 and 300 on
               D5's anchors, tie-heavy anchors and anchors whose tying
               predecessors share a lane (each timed B beside the B = 32
               kernel's repeats; B = 31 and 65 untimed), and at B = 64
               and 300 on the band's far edge and on ties between two
               older slots of one lane (untimed), and rows of 16384
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
               ladder stage must resolve the full-length plan, and every
               admitted read must equal ``map_realtime``'s result.  Then a
               profiled D5 pass, and each kernel against its plain version
               at every prefix's shapes (R = 32, S = 256..1024, E =
               51..192).  Each run's trace through the reference plan on
               the card is deferred (see ``train``): its driver state must
               equal the kernels plan's;
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
               plan on the card (D1-D5's reference maps deferred, see
               ``train``).  ``[paper-summary]``: each record's F1
               and peak device memory (with what earlier phases still held
               when the phase began), the kernels plan's reads/s a record
               (the median pass of a 2 s window, with the fastest and
               slowest), the Table 3 lines as the card ran them, the
               phase's seconds;
10. bench    — the pipeline bench harness (``repro_torch.benchmarks.
               microbench`` through ``repro_torch.scripts.bench_pipeline``):
               on the quick workload every group's closure under the
               kernels and the reference backend, launch counts zeroed
               just before each call and read just after (the kernels
               backend must launch exactly ``microbench.GROUP_KERNELS``,
               the reference backend, the cache pair and fairness
               nothing), every kernels-backend output equal to the
               reference backend's; the quick and full profiles and the
               six gate records into ``build/bench_pipeline/`` (copied to
               ``chiprun_out/bench_pipeline_h100.json``), their
               deterministic fields equal to the JAX package's
               (``jax_microbench.json``); ``bench_pipeline.check`` of
               those gate records against the committed
               ``bench_pipeline_h100.json`` must exit 0.
               The serving and cache gates run 9 rounds here
               (``BENCH_GATE_ROUNDS``; the module's 25 stay);
               ``[bench]`` lines: each group's min ms, median paired
               pre/fast ratio and the card;
11. lm       — the LM scaffold's serving path (``repro_torch.models``,
               ``repro_torch.launch.serve``), which launches no
               hand-written kernel (every launch count zeroed at the start
               of the phase must read 0 at its end): qwen3-4b and
               mamba2-780m at full width through the launcher (batch 4,
               prompt 64, gen 32; once to warm up, once timed), the
               parameters on the card adding up to the golden's count;
               prefill and decode tok/s, ms a decode step against its
               bound (parameter + cache bytes over 3.35 TB/s), peak
               memory, and one profiled decode step's kernel launches and
               busy share; at qwen3-4b's full width prefill(16) +
               decode(1) against forward(17) (rtol = atol = 5e-2) and the
               int8 cache (0.08); the card against the port on the CPU
               (forward, loss, prefill + decode with bf16 and int8 caches)
               at qwen3-4b's full width with 2 layers and for the ten
               reduced configs, those also against the JAX package's
               logits (``src/repro_torch/models/jax_lm_golden.json``),
               within the family tolerances the golden states;
12. train    — the LM scaffold's training path (``repro_torch.train``,
               ``repro_torch.launch.train``), which launches no
               hand-written kernel either (every count zeroed at the start
               of the phase must read 0 at its end): qwen3-4b and
               mamba2-780m at full width through the launcher (batch 8,
               seq 128, 5 steps: one to warm up, four timed; no
               checkpoint), the parameters on the card adding up to their
               counts and every loss finite; ms a step and tok/s against
               the step's bound (6 N tokens over 989 TFLOP/s plus 22 bytes
               a parameter over 3.35 TB/s), peak memory, and one profiled
               step's kernel launches and busy share; the ten reduced
               configs' train step on the card against the port on the CPU
               (``train.golden.step_deviations``: loss, per-leaf gradients,
               grad norm, updated parameters and moments, each within its
               bound), the optimizer on the card from the CPU's gradients
               equal to the CPU's bit for bit, and three steps on the card
               against the JAX package's (``jax_train_golden.json``); a
               reduced qwen3-4b run of 8 steps and a second process resumed
               from its step-4 checkpoint, under deterministic algorithms,
               equal leaf for leaf (sha256).  While the reduced configs and
               the resume run (they time nothing), the serve and paper
               phases' deferred reference-plan runs (``defer``: 5 serving
               traces, 15 records' reads; the plain DP is host-paced, and
               no number times them) go side by side in 5 processes of
               their own on the card, and each result is checked against
               its kernels-plan run before the phase ends;
13. lm_sharded — the LM's sharded serving path (``models.part``), which
               launches no hand-written kernel either (every count must
               read 0 on every rank): the one-device port on the card
               first, then a (2, 2) ('data', 'model') mesh of 4 gloo ranks
               sharing the card (``run_ranks``; on a host of 4 or more
               cards again with one NCCL rank a card): qwen3-4b at full
               width and depth, each rank holding its quarter of the
               launcher's weights (seed 0, drawn on the card): prefill(64)
               and 2 teacher-forced decode steps against the one-device
               port (within FULL_DEPTH_BOUND at full depth and within the
               dense bound at 2 layers), then the launcher's body (batch 4,
               prompt 64, gen 4, not 32: a step takes seconds; rank 0
               prints its lines): prefill and decode tok/s, ms a decode
               step against the one-device bound, peak memory a rank, and
               one profiled decode step's launches, busy share, collective
               calls and bytes by kind and gloo's staging; the ten reduced
               configs against the one-device port on the card and the
               JAX package's sharded golden
               (``src/repro_torch/models/jax_lm_sharded_golden.json``);
               ``psum_int8`` over both axes against the host; a sharded
               save equal file for file to the one-device save, restored
               onto a (2, 1) mesh block for block;
14. train_sharded — the LM's sharded train step (``models.part``'s
               gradients, ZeRO-3 moments), no hand-written kernel on any
               rank either: the one-device port on the card while the
               same (2, 2) mesh of 4 gloo ranks sharing the card starts:
               qwen3-4b at full width with 2 layers (weights seed 1, drawn
               on the card; batch 8, seq 128): each rank's update of its
               blocks from the one device's first gradients equal to the
               one-device update's blocks bit for bit (sha256), three
               train steps' losses within the sharded golden's ``loss``
               and the first gradient leaf by leaf within its
               ``card_grad`` of one device (the ranks' blocks' sums of
               squares; blocks held twice equal; the reduced configs are
               the ``gpu`` cases'); then the launcher at full width and
               depth (``--mesh 2x2``, batch 8,
               seq 128, 3 steps: one warm-up, two timed; rank 0 prints its
               lines): ms a step and tok/s against the one-device bound,
               every loss and norm finite, peak memory a rank and summed,
               and its last step under torch.profiler on rank 0: launches,
               busy share, collective calls and bytes by kind (all-gather,
               all-reduce, reduce-scatter) and gloo's staging;
15. summary  — one JSON line of per-kernel results, then the last line
               ``{"ok": true, "device": {...}}``.  Every log line also goes
               to ``chiprun_out/chip_smoke.log``.

``python3 chip_smoke.py --sharded-only`` runs phases 1-2, the datasets and
phase 8 alone (the NCCL run too on a host of several cards), records them
in ``chiprun_out/chip_smoke_sharded.json`` and prints no result line;
``--train-only`` runs phases 1 and 12 alone into
``chiprun_out/chip_smoke_train.json``, with no result line either, and
``--lm-sharded-only`` phases 1 and 13 into
``chiprun_out/chip_smoke_lm_sharded.json``, phase 13 with its diagnosis
(``lm_sharded_diagnosis``: the one-device port on the host's CPU against
the card at full depth, and the residual stream block by block against
one device, naming the first block that differs), and
``--train-sharded-only`` phases 1 and 14 into
``chiprun_out/chip_smoke_train_sharded.json``.

It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import hashlib
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


# The DP's anchor-to-anchor chain: 8 dependent instructions, about 35
# cycles a step (csrc/chain_dp.cu's header)
CHAIN_CYCLES = 35


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


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
    # (a slot of the band kernel's R0 and its chain; two slots of one lane
    # at B > 33).  B <= 33 keeps R0 alone, B = 64 two register sets beside
    # it, B = 128 four, B = 300 ten; B = 31 and 65 lie one slot either side
    # of a set's edge, and at B = 64 and 300 the band's far edge and ties
    # between two older slots of one lane join (tests/test_torch_gpu.py
    # adds B = 96 and the sets past R16).  A band's inputs are held against
    # the plain version as one batch of rows (one launch, one plain run:
    # the plain version, 0.5 s a call, is paced by its A steps, not its
    # rows).  Each timed B is read beside the shipped kernel's repeats
    # above, and in the log beside the chain floor: A steps of the
    # anchor-to-anchor chain's CHAIN_CYCLES (read off the SASS, not
    # measured here) at the card's highest SM clock.  The plain version is
    # timed at B = 16 and 64 alone
    from repro_torch.kernels.fixtures import (band_edge_anchors,
                                              lane_tie_anchors)

    def on_card(arrays):
        return tuple(torch.from_numpy(x).to(dev) for x in arrays)
    cases = dict(full=d5, ties=(sq, st, sv),
                 lane_ties=on_card(lane_tie_anchors(R, A)))
    lag = on_card(lane_tie_anchors(R, A, lag=3))
    floor_ms = A * CHAIN_CYCLES / (sm_clock_mhz() * 1e3)
    for B in (1, 16, 31, 33, 64, 65, 128, 300):
        cb = cfg.replace(chain_band=B)
        batch = dict(cases)
        if B in (64, 300):
            batch["band edge"] = on_card(band_edge_anchors(R, A, B))
            batch["lane ties lag 3"] = lag
        bq, bt, bv = (torch.cat(x) for x in zip(*batch.values()))
        K.reset_launches()
        g = dp_ops.chain_dp(bq, bt, bv, cb)
        want = chain_dp_ref(bq, bt, bv, cb)
        torch.cuda.synchronize()
        check_launches(f"chain_dp B={B}", K.LAUNCHES, ("chain_dp",))
        errs, row = {}, 0
        for label, (xq, _, _) in batch.items():
            rows = slice(row, row + xq.shape[0])
            row = rows.stop
            errs[label] = max(
                assert_equal(f"chain_dp B={B} {label} {n}", a[rows], b[rows])
                for n, a, b in zip(("f", "diag0"), g, want))
        untimed = [x for x in batch if B in (31, 65) or x not in cases]
        if untimed:
            log(f"[kernels] chain_dp B={B} {', '.join(untimed)} ({R}, {A}) "
                "equal (untimed)")
        if B in (31, 65):
            continue
        for label, (xq, xt, xv) in cases.items():
            k_ms = time_ms(lambda: dp_ops.chain_dp(xq, xt, xv, cb), 20)
            p_ms = (time_ms(lambda: chain_dp_ref(xq, xt, xv, cb), 1)
                    if label == "full" and B in (16, 64) else None)
            b_ms, b_by = dp_bound(R, A, B)
            dp_shapes.append(dict(
                route=f"B={B} {label} {R}x{A}", on_main_path=False,
                shape=f"({R}, {A}), B={B}", max_abs_err=errs[label],
                ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by))
            log(f"[kernels] chain_dp B={B} {label} ({R}, {A}) equal; "
                f"kernel {k_ms:.4f} ms ({k_ms / np.mean(b32):.2f}x the "
                f"B=32 kernel's {np.mean(b32):.4f})"
                + (f", plain {p_ms:.3f} ms" if p_ms is not None else "")
                + f", bound {b_ms:.5f} ms ({b_by}), chain floor "
                f"{floor_ms:.5f} ms")
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
    from repro_torch.benchmarks import common
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
    # every read against the JAX package's streamed outputs
    bad = common.digest_mismatch(
        common.map_digest(out, CHUNK),
        json.loads(common.MAP_DIGEST.read_text())[f"{key} {cfg.mode}"])
    if bad:
        raise AssertionError(f"{label}: the card's {READS} reads differ from "
                             f"the JAX package's ({common.MAP_DIGEST.name}):"
                             f" {bad}")

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
        f" every read equals the JAX package's ({common.MAP_DIGEST.name}), "
        f"chunk 0 the plain path")
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
    after; every admitted read must get the result ``map_realtime`` gives
    it (``phase_serve`` holds the driver state against the reference
    plan's)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import pipeline
    from repro_torch.core.realtime import map_realtime
    from repro_torch.launch import serve_rsga
    label = f"{key} {mode} {' '.join(extra)}"
    argv = [*serve_argv(key, mode, extra), "--use-kernels"]
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
        virtual_makespan=sd.clock,
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
        f"{res['streams_per_s']:.2f} streams/s), {sd.n_chunks} chunks of "
        f"{SERVE_CHUNK} "
        f"({sd.n_pad_rows} pad rows), {sd.n_shed} shed, virtual makespan "
        f"{sd.clock:.2f}, p50 {res['p50']:.3f} p99 {res['p99']:.3f} "
        f"(virtual units); kernel launches {launches} "
        f"({res['launches_per_chunk']:.2f} a chunk); equals "
        f"map_realtime ({n_checked} admitted reads)")
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


# The reference plan's long runs.  The serve phase's traces and the paper
# phase's records through the reference plan take minutes on the card (its
# plain DP is host-paced) and no number of the script times them.  `defer`
# queues such a run (a picklable call, and the check of its result in this
# process); `deferred_runs` runs the queue side by side in
# REFERENCE_WORKERS processes of their own, one intra-op thread each, while
# a stretch of the train phase that times nothing goes on (the reduced
# configs against the CPU, the resume), and then checks every result: a
# check that fails fails the script as it would in its own phase.
REFERENCE_WORKERS = 5
DEFERRED = []


def defer(label: str, fn, args: tuple, check) -> None:
    """Queue ``fn(*args)`` for ``deferred_runs``; ``check`` gets its
    result."""
    DEFERRED.append((label, fn, args, check))


def reference_init() -> None:
    """A deferred run's process: one intra-op thread (the runs share the
    host's cores with the script) and the script's float settings."""
    import torch
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def deferred_runs():
    """Run the DEFERRED queue side by side while the body runs, then check
    each result in queue order.  Yields a dict that gets the number of
    runs, their seconds and the seconds the script waited for them after
    the body."""
    import concurrent.futures
    import multiprocessing
    import torch
    jobs, out = list(DEFERRED), {}
    DEFERRED.clear()
    if not jobs:
        yield out
        return
    t0 = time.time()
    workers = min(len(jobs), REFERENCE_WORKERS)
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=reference_init)
    # the body's intra-op threads: the cores the runs leave
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) - workers))
    try:
        futures = [pool.submit(fn, *args) for _, fn, args, _ in jobs]
        yield out
        t1 = time.time()
        for (_, _, _, check), fut in zip(jobs, futures):
            check(fut.result())
        out.update(runs=[label for label, *_ in jobs],
                   seconds=time.time() - t0, body_s=t1 - t0,
                   waited_s=time.time() - t1)
    finally:
        torch.set_num_threads(threads)
        pool.shutdown(wait=True, cancel_futures=True)
    log(f"[deferred] {len(jobs)} reference-plan runs ("
        + ", ".join(f"{k} {sum(lb.startswith(k) for lb in out['runs'])}"
                    for k in ("serve", "paper"))
        + f") side by side in {workers} processes: {out['seconds']:.1f} s, "
        f"every result equals its kernels-plan run's; the stretch they "
        f"overlap {out['body_s']:.1f} s, then waited {out['waited_s']:.1f} s")


def serve_argv(key, mode, extra) -> list:
    """The serving launcher's arguments of one run of SERVE_RUNS, without
    ``--use-kernels``."""
    return ["--dataset", key, "--mode", mode, *SERVE_ARGS, *extra]


def serve_reference(argv) -> tuple:
    """One serving trace through the reference plan on the card, a deferred
    run (``defer``): the launcher without ``--use-kernels`` (the same
    dataset, index, trace and driver settings as the kernels plan's run).
    Returns the driver state, the serving wall and the launches, counted
    from zero."""
    import io
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch import serve_rsga
    K.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        served = serve_rsga.run(list(argv))
    torch.cuda.synchronize()
    return driver_state(served.driver), served.wall_s, dict(K.LAUNCHES)


def serve_reference_check(label, res, state):
    """The check of a deferred ``serve_reference``: no kernel launched and
    the driver state the kernels plan's (``state``); its serving wall goes
    into the run's record ``res``."""
    def check(got):
        plain_state, wall, launches = got
        check_launches(f"serve {label} reference plan", launches, ())
        if plain_state != state:
            raise AssertionError(f"serve {label}: the kernels plan's driver "
                                 "state differs from the reference plan's")
        res["plain_wall_s"] = wall
    return check


def phase_serve(data, dev):
    """The serving path: every run of SERVE_RUNS through the launcher, a
    profiled pass of the first (D5) run's trace, and the kernels at the
    serving shapes.  Each run's trace through the reference plan is
    deferred (``defer``): its driver state must equal the kernels plan's."""
    runs, first, seconds = {}, None, {}
    for key, mode, extra in SERVE_RUNS:
        t0 = time.time()
        res, served = serve_run(key, mode, extra, dev)
        label = f"{key} {mode} {' '.join(extra)}"
        runs[label] = res
        defer(f"serve {label}", serve_reference,
              (serve_argv(key, mode, extra),),
              serve_reference_check(label, res, driver_state(served.driver)))
        first = first or served
        seconds[label] = time.time() - t0
    t0 = time.time()
    profile_ = serve_profile(first, dev)
    seconds["profile"] = time.time() - t0
    t0 = time.time()
    cfg, _, reads, index = data["D5"]
    kernels = serve_kernels(cfg, reads, index, dev)
    seconds["kernels"] = time.time() - t0
    log("[serve] seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items())
        + f"; the {len(SERVE_RUNS)} reference-plan traces deferred")
    return dict(runs=runs, profile=profile_, kernels=kernels,
                seconds=seconds)


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




def paper_inputs(ds: str, mode: str) -> tuple:
    """A paper record's config, reads and index, as ``pipeline_run``
    builds them."""
    from repro_torch.core import build_index
    from repro_torch.signal import datasets
    cfg = datasets.config_for(datasets.DATASETS[ds]).with_mode(mode)
    ref, reads = datasets.build(datasets.DATASETS[ds], cfg)
    return cfg, reads, build_index(ref.events_concat, ref.n_events, cfg)


def paper_reference(ds: str, mode: str) -> tuple:
    """A paper record's reads through the reference plan on the card in
    chunks of 32, a deferred run (``defer``): the host ``MapOutput`` and
    the launches, counted from zero."""
    from repro_torch import kernels as K
    from repro_torch.core import Mapper
    cfg, reads, index = paper_inputs(ds, mode)
    K.reset_launches()
    out = Mapper(index, cfg, use_kernels=False,
                 device="cuda").map_signals(reads.signals, chunk=32)
    return out, dict(K.LAUNCHES)


def paper_reference_check(label, got):
    """The check of a deferred ``paper_reference``: no kernel launched and
    every read's outputs and the counters the kernels plan's (``got``)."""
    def check(res):
        want, launches = res
        check_launches(f"{label} reference plan", launches, ())
        equal_outputs(label, got, want)
    return check


def paper_reads(dev):
    """Every (dataset, mode) record's reads (D2-D4 new to the card) mapped
    by the kernels plan in chunks of 32; the same reads through the
    reference plan are deferred (``defer``): every read must be equal.
    Then the kernels plan maps the record's reads again and again for
    ``WINDOW_S`` seconds (``window``: at least ``MIN_PASSES`` passes, each
    ended by a device sync): reads/s of the median pass with the fastest
    and slowest, on the host clock."""
    from repro_torch.core import Mapper
    from repro_torch.signal import datasets
    rates = {}
    for ds in datasets.DATASETS:
        for mode in PAPER_MODES:
            cfg, reads, index = paper_inputs(ds, mode)
            kern = Mapper(index, cfg, use_kernels=True, device=dev)
            label = f"paper {ds} {mode}"
            defer(label, paper_reference, (ds, mode), paper_reference_check(
                label, kern.map_signals(reads.signals, chunk=32)))
            w = window(lambda: kern.map_signals(reads.signals, chunk=32))
            n = len(reads.signals)
            rates[f"{ds} {mode}"] = dict(
                n_reads=n, passes=w["passes"],
                reads_per_s=n / w["median_ms"] * 1e3,
                fastest_reads_per_s=n / w["fastest_ms"] * 1e3,
                slowest_reads_per_s=n / w["slowest_ms"] * 1e3)
    log("[paper] D1-D5, each mode, chunks of 32: every read through the "
        "kernels plan; the same reads through the reference plan deferred")
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
    ``BENCH_sim.json``.  Every record's reads (D2-D4 new to the card; their
    reference maps deferred, ``paper_reads``) and the filter ablation's
    five variants: every read mapped under the kernels plan must equal the
    reference plan's; the kernels plan's reads/s come from a timed window
    of repeated passes."""
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


# ---- the pipeline bench harness --------------------------------------------
BENCH_PROFILES = ("quick", "full")
BENCH_OUT = ROOT / "build" / "bench_pipeline" / "BENCH_pipeline.json"
# The gates' rounds this script runs where they differ from the module's
# (bench_pipeline.PHASE_ROUNDS / CHECK_REPEATS): serving and cache at 25
# rounds took about 15 and 9 s of the 48.5 s one gate measurement took on
# the card (NVIDIA H100 80GB HBM3, 700.00 W); at 9 rounds, with the one
# measurement both written and checked, the phase keeps within 150 s
BENCH_GATE_ROUNDS = {"serving": 9, "cache": 9}


def equal_tree(label: str, got, want) -> None:
    """Exact equality of two nested outputs (tuples, lists, dicts, tensors
    by ``assert_equal``, numpy arrays by dtype and value, scalars)."""
    import numpy as np
    import torch
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: keys {sorted(got)} vs "
                                 f"{sorted(want)}")
        for k in want:
            equal_tree(f"{label}[{k}]", got[k], want[k])
    elif isinstance(want, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError(f"{label}: {len(got)} vs {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            equal_tree(f"{label}[{i}]", g, w)
    elif isinstance(want, torch.Tensor):
        assert_equal(label, got, want)
    elif isinstance(want, np.ndarray):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{label}: host arrays differ")
    elif got != want:
        raise AssertionError(f"{label}: {got!r} vs {want!r}")


def bench_closures(dev) -> dict:
    """Every closure of the harness on the quick workload (16 reads), under
    the kernels and the reference backend: launch counts zeroed just
    before each call and read just after (the kernels backend must launch
    exactly ``microbench.GROUP_KERNELS[group]``, the reference backend
    none), and every kernels-backend output equal to the reference
    backend's (the fused pair to the reference cheap phase; the cache
    pair, tiered against resident)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.benchmarks import microbench as mb
    from repro_torch.core import stages
    from repro_torch.scripts import bench_pipeline as bp
    q = bp.PROFILES["quick"]
    cfg, sig, arrays = mb.make_workload(q["n_reads"], q["ref_events"],
                                        q["junk_frac"], device=dev)

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launches()
        out = mb.block_until_ready(fn())
        launches = dict(K.LAUNCHES)
        K.reset_launches()
        return out, launches

    outs, launches = {}, {}
    for backend in (stages.REFERENCE, stages.KERNELS):
        for g, fn in mb.group_closures(cfg, sig, arrays, backend).items():
            outs[backend, g], launches[backend, g] = counted(fn)
    tiered, resident, _ = mb._cache_programs(cfg, sig, arrays)
    fair = mb._fairness_runs(cfg, sig, arrays, stages.REFERENCE)
    for g, fn in (("cache_tiered", tiered), ("cache_resident", resident),
                  ("fairness", lambda: [fair(False), fair(True)])):
        outs[stages.REFERENCE, g], launches[stages.REFERENCE, g] = \
            counted(fn)
    for (backend, g), n in launches.items():
        want = (mb.GROUP_KERNELS[g] if backend == stages.KERNELS else ())
        check_launches(f"bench {backend} {g}", n, want)
    for (backend, g), out in outs.items():
        if backend != stages.KERNELS:
            continue
        ref_g = "cheap" if g.startswith("fused") else g
        equal_tree(f"bench {g} kernels vs reference", out,
                   outs[stages.REFERENCE, ref_g])
    equal_tree("bench cache tiered vs resident",
               outs[stages.REFERENCE, "cache_tiered"],
               outs[stages.REFERENCE, "cache_resident"])
    kern = {g: {k: v for k, v in n.items() if v}
            for (b, g), n in launches.items() if b == stages.KERNELS}
    log("[bench] kernels backend launches a group (reference backend, "
        "cache pair and fairness: none): " + "; ".join(
            f"{g} {v}" for g, v in kern.items()))
    log(f"[bench] every kernels-backend closure ({len(kern)}) equals the "
        "reference backend's on the card; tiered equals resident")
    return kern


def bench_lines(measured, smi) -> None:
    """One ``[bench]`` line a group: min ms of each side, the median paired
    pre/fast ratio, the card."""
    for name, prof in measured.items():
        for backend, r in prof["backends"].items():
            grid = f"{r['grid_reads']} reads"
            for g in ("chain", "cheap", "detect", "query", "vote",
                      "serving"):
                if f"{g}_speedup" not in r:
                    continue
                log(f"[bench] {name} {backend} {g} ({grid}): fast "
                    f"{r[g + '_fast'] * 1e3:.4f} ms, pre "
                    f"{r[g + '_pre'] * 1e3:.4f} ms, median paired pre/fast "
                    f"{r[g + '_speedup']:.3f}x ({smi})")
            log(f"[bench] {name} {backend} chunk ({grid}): cheap "
                f"{r['cheap'] * 1e3:.4f} ms, map_chunk "
                f"{r['map_chunk'] * 1e3:.4f} ms, map_chunk_pre "
                f"{r['map_chunk_pre'] * 1e3:.4f} ms ({smi})")
        c, f = prof["cache"], prof["fused"]
        log(f"[bench] {name} cache: tiered {c['cache_tiered'] * 1e3:.4f} ms,"
            f" resident {c['cache_resident'] * 1e3:.4f} ms, median paired "
            f"{c['cache_speedup']:.3f}x, hit rate {c['cache_hit_rate']:.3f},"
            f" {c['cache_paged_bytes']} bytes paged ({smi})")
        log(f"[bench] {name} fused ({f['fused_n_reads']} reads, "
            f"{f['fused_mode']}): fused {f['fused_fast'] * 1e3:.4f} ms, "
            f"per-stage {f['fused_pre'] * 1e3:.4f} ms, median paired "
            f"{f['fused_speedup']:.3f}x ({smi})")
        fr = prof["fairness"]
        log(f"[bench] {name} fairness: acme victims "
            f"{fr['fairness_acme_victims_legacy']} legacy, "
            f"{fr['fairness_acme_victims_fair']} budgeted "
            f"({fr['fairness_speedup']:.3f}x; virtual clock)")
    for phase in ("chain", "cheap", "serving", "cache", "fused", "fairness"):
        g = measured["quick"][f"{phase}_gate"]
        log(f"[bench] gate {phase} ({g['backend']}, {g['rounds']} rounds): "
            f"median paired {g[phase + '_speedup_median']:.3f}x ({smi})")


def phase_bench(dev, smi):
    """The pipeline bench harness on the card: every closure's launches and
    equality (``bench_closures``); ``bench_pipeline``'s quick and full
    profiles and its six gate records into ``build/`` (copied to
    ``chiprun_out/bench_pipeline_h100.json``), their deterministic fields
    against the JAX package's (``jax_microbench.json``); then
    ``bench_pipeline.check`` of those gate records against the committed
    card baseline must exit 0."""
    import shutil
    from repro_torch.benchmarks import microbench as mb
    from repro_torch.scripts import bench_pipeline as bp
    module_rounds = bp.PHASE_ROUNDS
    bp.PHASE_ROUNDS = {**module_rounds, **BENCH_GATE_ROUNDS}
    t0 = time.time()
    kern = bench_closures(dev)
    t_closures = time.time() - t0
    measured = bp.measure(BENCH_PROFILES, device=dev, pallas_serving=True)
    t_profiles = time.time() - t0 - t_closures
    gates = bp.measure_gate(dev)
    for phase, rec in gates.items():
        measured["quick"][f"{phase}_gate"] = rec
    t_gates = time.time() - t0 - t_closures - t_profiles
    if BENCH_OUT.exists():
        BENCH_OUT.unlink()
    bp.write(BENCH_OUT, measured)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    shutil.copy(BENCH_OUT, out_dir / "bench_pipeline_h100.json")
    golden = json.loads((ROOT / "src" / "repro_torch" / "benchmarks"
                         / "jax_microbench.json").read_text())
    for phase, rounds in BENCH_GATE_ROUNDS.items():
        golden["quick"]["gates"][phase]["rounds"] = rounds
    for name in BENCH_PROFILES:
        bad = mb.deterministic_mismatches(measured[name], golden[name])
        if bad:
            raise AssertionError(f"bench {name}: deterministic fields differ "
                                 f"from jax_microbench.json: {bad}")
    log("[bench] deterministic fields of both profiles and the gate records "
        "equal the JAX package's (jax_microbench.json; gate rounds "
        f"{BENCH_GATE_ROUNDS} here)")
    bench_lines(measured, smi)
    t1 = time.time()
    rc = bp.check(bp.BASELINE, dev, gates=gates)
    t_check = time.time() - t1
    bp.PHASE_ROUNDS = module_rounds
    if rc != 0:
        raise AssertionError(f"bench_pipeline --check against "
                             f"{bp.BASELINE.name} exited {rc}")
    log(f"[bench] check against the committed "
        f"{bp.BASELINE.name}: exit 0; seconds: closures "
        f"{t_closures:.1f}, profiles {t_profiles:.1f}, gates {t_gates:.1f}, "
        f"check {t_check:.1f}")
    return dict(launches=kern, profiles=measured,
                seconds=dict(closures=t_closures, profiles=t_profiles,
                             gates=t_gates, check=t_check))


# The LM scaffold's serving path (``lm`` phase): full width through the
# launcher, with the JAX launcher's defaults
LM_SERVE = (("qwen3-4b", 4_411_424_256), ("mamba2-780m", 857_170_176))
LM_ARGV = ["--batch", "4", "--prompt-len", "64", "--gen", "32"]


def tree_bytes(tree) -> int:
    from repro_torch.models import model as M
    return sum(t.numel() * t.element_size()
               for t in M.flatten(tree).values())


def lm_serve(arch: str, n_params: int, gold: dict, smi: str) -> dict:
    """``repro_torch.launch.serve`` at full width: once to warm up, once
    timed.  The parameter count must equal the golden's, and the
    parameters on the card must add up to it.  Then one more decode step
    under torch.profiler: its kernel launches and the device's busy
    share."""
    import torch
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    argv = ["--arch", arch, *LM_ARGV]
    toks = serve.main(argv)
    if toks.shape != (4, 32):
        raise AssertionError(f"lm {arch}: tokens {toks.shape}")
    del toks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve.run(serve.parse_args(argv))
    peak = torch.cuda.max_memory_allocated()
    cfg, params, cache = res["cfg"], res["params"], res["cache"]
    leaves = list(M.flatten(params).values())
    on_card = sum(t.numel() for t in leaves)
    if not (M.param_count(cfg) == on_card == n_params
            == gold["full"][arch]["param_count"]):
        raise AssertionError(f"lm {arch}: {M.param_count(cfg)} parameters, "
                             f"{on_card} on the card, {n_params} expected")
    if any(t.device.type != "cuda" for t in leaves):
        raise AssertionError(f"lm {arch}: a parameter is off the card")
    if not np.isfinite(res["tokens"]).all():
        raise AssertionError(f"lm {arch}: tokens")
    B, P, gen = 4, 64, 32
    p_bytes, c_bytes = tree_bytes(params), tree_bytes(cache)
    bound_ms = (p_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    step = lambda: M.decode_step(params, tok, cfg, cache=cache,
                                 cache_index=P + gen - 1)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_kernel = device_busy(prof, f"trace_lm_{arch}_decode.json.gz")
    launches = sum(n for n, _ in by_kernel.values())
    out = dict(
        arch=arch, params=on_card, param_bytes=p_bytes, cache_bytes=c_bytes,
        prefill_ms=res["prefill_s"] * 1e3,
        prefill_tok_s=B * P / res["prefill_s"],
        decode_ms_per_step=res["decode_s"] / gen * 1e3,
        decode_tok_s=B * gen / res["decode_s"],
        decode_bound_ms=bound_ms, max_memory_allocated=peak,
        step_wall_ms=wall * 1e3, step_busy_ms=busy * 1e3,
        step_busy_share=busy / wall, step_launches=launches,
        top_kernels=sorted(((k, n, us) for k, (n, us) in by_kernel.items()),
                           key=lambda r: -r[2])[:8])
    log(f"[lm] {arch} full width ({on_card:,} parameters, "
        f"{p_bytes / 1e9:.3f} GB; cache {c_bytes / 1e6:.2f} MB), batch 4, "
        f"prompt 64, gen 32: prefill {out['prefill_ms']:.3f} ms "
        f"({out['prefill_tok_s']:.1f} tok/s), decode "
        f"{out['decode_ms_per_step']:.3f} ms a step "
        f"({out['decode_tok_s']:.2f} tok/s) against a bound of "
        f"{bound_ms:.4f} ms (parameter + cache bytes over 3.35 TB/s); "
        f"peak memory {peak / 2**30:.3f} GiB; one profiled decode step: "
        f"{launches} kernel launches, wall {wall * 1e3:.3f} ms, device busy "
        f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%); {smi}")
    for name, n, us in out["top_kernels"][:5]:
        log(f"[lm]   device {us / 1e3:8.3f} ms  x{n:<4} {name[:90]}")
    return dict(out, _params=params, _cfg=cfg)


def lm_full_width_property(params, cfg, gold: dict, smi: str) -> dict:
    """The JAX package's own property at full width (its test's bounds):
    prefill(16) + decode(1) equals forward(17) at the last token within
    rtol = atol = 5e-2, and the int8 cache within 0.08 of it."""
    import torch
    import numpy as np
    from repro_torch.models import model as M
    dev = torch.device("cuda", 0)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 17)), dtype=torch.int32, device=dev)
    want = M.forward(params, tokens, cfg)[0][:, -1].float().cpu().numpy()
    out = {}
    for name, kv in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        cache = M.init_cache(cfg, 1, 24, kv, dev)
        _, cache = M.prefill(params, tokens[:, :16], cfg, cache=cache)
        got = M.decode_step(params, tokens[:, 16:], cfg, cache=cache,
                            cache_index=16)[0].float().cpu().numpy()
        out[name] = float(np.abs(got - want).max() / np.abs(want).max())
        if name == "bf16":
            tol = gold["prefill_decode_tol"]
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        elif out[name] >= gold["int8_tol"]:
            raise AssertionError(f"lm {cfg.name}: int8 cache {out[name]}")
    log(f"[lm] {cfg.name} full width: prefill(16) + decode(1) against "
        f"forward(17), max|diff|/max|forward| {out['bf16']:.5f} (rtol = "
        f"atol = {gold['prefill_decode_tol']}), int8 cache "
        f"{out['int8']:.5f} (< {gold['int8_tol']}); {smi}")
    return out


def lm_card_vs_cpu(label, cfg, params_dev, params_cpu, tokens, ctx,
                   gold: dict, smi: str) -> dict:
    """``golden.outputs`` on the card and on the CPU from the same weights;
    every deviation within the family's tolerance (nll and aux within
    ``nll_tol``)."""
    import torch
    from repro_torch.models import golden as G
    dev = torch.device("cuda", 0)
    t_cpu = torch.as_tensor(tokens)
    c_cpu = None if ctx is None else torch.as_tensor(ctx)
    card = G.outputs(params_dev, cfg, t_cpu.to(dev),
                     None if c_cpu is None else c_cpu.to(dev))
    host = G.outputs(params_cpu, cfg, t_cpu, c_cpu)
    dev_ = G.deviations(card, host)
    tol = gold["tolerance"][cfg.family]
    for k, v in dev_.items():
        limit = gold["nll_tol"] if k in ("nll", "aux") else tol
        if not (v <= limit) or not torch.isfinite(card[k]).all():
            raise AssertionError(f"lm {label}: card against CPU {k} {v} "
                                 f"(limit {limit})")
    log(f"[lm] {label}: card against CPU, logits {dev_['logits']:.5f}, "
        f"decode {dev_['decode']:.5f}, int8 decode {dev_['decode_int8']:.5f}"
        f" (of max|CPU|; limit {tol}), |nll| {dev_['nll']:.2e}, |aux| "
        f"{dev_['aux']:.2e}; {smi}")
    return dict(deviations=dev_, card=card)


def phase_lm(smi):
    """The LM scaffold's serving path, which launches no hand-written
    kernel (its launch counts must all read 0): qwen3-4b and mamba2-780m
    at full width through ``repro_torch.launch.serve``; the JAX package's
    prefill/decode property at full width; the card against the port on
    the CPU at qwen3-4b's full width with 2 layers, and for all ten
    reduced configs, those also against the JAX package's logits
    (``jax_lm_golden.json``)."""
    import torch
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import golden as G
    from repro_torch.models import model as M
    gold = G.load()
    dev = torch.device("cuda", 0)
    t0 = time.time()
    K.reset_launches()
    serve_runs = {}
    for arch, n_params in LM_SERVE:
        r = lm_serve(arch, n_params, gold, smi)
        params, cfg = r.pop("_params"), r.pop("_cfg")
        if arch == "qwen3-4b":
            r["property"] = lm_full_width_property(params, cfg, gold, smi)
        serve_runs[arch] = r
        del params
        torch.cuda.empty_cache()
    # full width, 2 layers: the weights drawn on the card, copied to the CPU
    cfg2 = get_config("qwen3-4b").replace(n_layers=2)
    p_dev = M.init_params(cfg2, torch.Generator(dev).manual_seed(1), dev)
    p_cpu = M.tree_map(lambda t: t.cpu(), p_dev)
    tokens = np.random.default_rng(4).integers(0, cfg2.vocab, (2, 17))
    cut = lm_card_vs_cpu("qwen3-4b full width, 2 layers", cfg2, p_dev, p_cpu,
                         tokens.astype(np.int32), None, gold, smi)
    del p_dev, p_cpu
    torch.cuda.empty_cache()
    reduced = {}
    for arch in sorted(ARCHS):
        cfg = get_config(arch).reduced()
        p_cpu = M.seeded_params(cfg, gold["weights_seed"], "cpu")
        p_dev = M.tree_map(lambda t: t.to(dev), p_cpu)
        tokens, ctx = G.inputs(cfg, gold)
        r = lm_card_vs_cpu(f"{arch}-reduced", cfg, p_dev, p_cpu, tokens,
                           ctx, gold, smi)
        jax_err = G.rel_err(G.digest(r["card"]["logits"], gold),
                            gold["reduced"][arch])
        if not jax_err <= gold["tolerance"][cfg.family]:
            raise AssertionError(f"lm {arch}-reduced: card against the JAX "
                                 f"golden {jax_err}")
        log(f"[lm] {arch}-reduced: card against the JAX package's logits "
            f"(jax_lm_golden.json) {jax_err:.5f} of max|JAX| (limit "
            f"{gold['tolerance'][cfg.family]})")
        reduced[arch] = dict(r["deviations"], jax_golden=jax_err)
    launched = {k: v for k, v in K.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"lm: hand-written kernels launched {launched}")
    seconds = time.time() - t0
    log(f"[lm] no hand-written kernel launched (all {len(K.LAUNCHES)} "
        f"counts 0); phase {seconds:.1f} s")
    return dict(serve=serve_runs, cut_depth=cut["deviations"],
                reduced=reduced, launches=dict(K.LAUNCHES), seconds=seconds)


# The LM scaffold's training path (``train`` phase): full width through
# the launcher at the JAX launcher's defaults (batch 8, seq 128): one step
# to warm up, four timed
LM_TRAIN = (("qwen3-4b", 4_411_424_256), ("mamba2-780m", 857_170_176))
TRAIN_ARGV = ["--batch", "8", "--seq", "128", "--steps", "5",
              "--log-every", "1"]
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 (NVIDIA data sheet)
ADAMW_BYTES_PER_PARAM = 22      # bf16 p r/w, bf16 g r, f32 m and v r/w


@contextlib.contextmanager
def first_step_flops(into: dict):
    """``launch.train``'s first (warm-up, untimed) step under
    ``FlopCounterMode``: its matmul flops on the card go to
    ``into["flops"]``; the later steps run as they are."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.train import steps as S
    made = S.make_train_step

    def make(*a, **kw):
        step, jit_for, sh = made(*a, **kw)

        def counted(params, state, batch):
            if "flops" in into:
                return step(params, state, batch)
            with FlopCounterMode(display=False) as fc:
                out = step(params, state, batch)
            into["flops"] = float(fc.get_total_flops())
            return out
        return counted, lambda b: (jit_for(b), counted)[1], sh
    S.make_train_step = make
    try:
        yield into
    finally:
        S.make_train_step = made


# The dry run's meta-device counts (``repro_torch.analysis.count``) of the
# steps this script times, priced on the H100 row of
# ``analysis/roofline.py``: the one-device train step of the ``train``
# phase and the decode step of the ``lm`` phase (qwen3-4b), and the
# counting mesh's rank-0 collectives of the ``train_sharded`` phase's step.
# ``phase_train`` counts them in its deferred stretch and hands the last to
# the sharded phase (which counts it itself when run alone).
LM_DECODE_CACHE = 96            # LM_ARGV's prompt 64 + gen 32


def meta_train_sharded(reduced: bool = False) -> dict:
    """The counting mesh's calls and bytes by kind for rank 0 of the
    ``train_sharded`` launcher's step (full depth, batch 8, seq 128)."""
    from repro_torch.analysis import count
    from repro_torch.configs.base import ShapeSpec
    args = TRAIN_SHARDED_ARGV
    shape = ShapeSpec("train", int(args[args.index("--seq") + 1]),
                      int(args[args.index("--batch") + 1]), "train")
    mesh = count.CountingMesh(*TRAIN_SHARDED_MESH, rank=0)
    t0 = time.time()
    count.count_step(train_sharded_cfg(reduced), shape, mesh,
                     with_bytes=False)
    return dict(stats=count.calls_and_bytes(mesh.stats),
                detail=dict(mesh.detail), seconds=time.time() - t0)


def lm_roofline(lm: dict, full: dict, smi: str) -> dict:
    """qwen3-4b's one-device train step (batch 8, seq 128) and decode step
    (batch 4, a cache of 96) counted on the meta device and priced on the
    H100 row (compute and memory terms; the bound is the larger), beside
    the ``train`` and ``lm`` phases' measured ms; the train step's meta
    flops must equal its warm-up step's on the card exactly.  Also counts
    the sharded phase's rank-0 collectives (``out["train_sharded"]``)."""
    from repro_torch.analysis import count
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    cfg = get_config("qwen3-4b")
    train_args = dict(zip(TRAIN_ARGV[::2], TRAIN_ARGV[1::2]))
    B, S = int(train_args["--batch"]), int(train_args["--seq"])
    steps = dict(
        train=(ShapeSpec("train", S, B, "train"), {},
               full["qwen3-4b"]["ms_per_step"]),
        decode=(ShapeSpec("decode", LM_DECODE_CACHE, 4, "decode"),
                dict(cache_index=LM_DECODE_CACHE - 1),
                lm["serve"]["qwen3-4b"]["decode_ms_per_step"]
                if lm else None))
    out = {}
    for name, (shape, kw, ms) in steps.items():
        t0 = time.time()
        got = count.count_step(cfg, shape, None, **kw)
        cell = rl.CellResult(
            arch=cfg.name, shape=name, mesh="one", chips=1,
            flops_per_device=got["flops"], bytes_per_device=got["bytes"],
            wire_bytes_per_device=0.0, collective_detail={},
            peak_memory_per_device=None, model_flops=0.0,
            model_flops_basis="-", tokens=0, hw="h100")
        bound_ms = max(cell.t_compute, cell.t_memory) * 1e3
        out[name] = dict(flops=got["flops"], bytes=got["bytes"],
                         t_compute_ms=cell.t_compute * 1e3,
                         t_memory_ms=cell.t_memory * 1e3,
                         bound_ms=bound_ms, bottleneck=cell.bottleneck,
                         measured_ms=ms, seconds=time.time() - t0,
                         ms_over_bound=None if ms is None else ms / bound_ms)
        log(f"[roofline] qwen3-4b {name} step, one device ("
            f"{'batch 8, seq 128' if name == 'train' else 'batch 4, cache 96'}"
            f"), counted on the meta device: {got['flops']:.4e} flops, "
            f"{got['bytes']:.4e} op bytes (unfused); H100 row: compute "
            f"{cell.t_compute * 1e3:.3f} ms, memory {cell.t_memory * 1e3:.3f}"
            f" ms, bound {bound_ms:.3f} ms ({cell.bottleneck}); measured "
            + ("not run" if ms is None else
               f"{ms:.3f} ms a step, {ms / bound_ms:.2f}x the bound")
            + f"; counted in {out[name]['seconds']:.1f} s; {smi}")
    card = full["qwen3-4b"]["warmup_flops"]
    out["train"]["card_flops"] = card
    if card != out["train"]["flops"]:
        raise AssertionError(f"roofline: the train step's meta flops "
                             f"{out['train']['flops']} differ from its "
                             f"warm-up step's on the card {card}")
    log(f"[roofline] qwen3-4b train step: FlopCounterMode on the card's "
        f"warm-up step {card:.6e} flops = the meta count, exactly")
    out["train_sharded"] = meta_train_sharded()
    log(f"[roofline] counting mesh, rank 0 of the train_sharded step: "
        f"{out['train_sharded']['stats']} (counted in "
        f"{out['train_sharded']['seconds']:.1f} s)")
    return out


def lm_train(arch: str, n_params: int, smi: str) -> dict:
    """``repro_torch.launch.train`` at full width, batch 8, seq 128, 5
    steps (the first warms up): ms a step and tok/s over the last 4, peak
    memory, the step's bound (6 N tokens over the dense bf16 peak, plus
    the optimizer's 22 bytes a parameter over 3.35 TB/s); the parameters
    on the card must add up to ``n_params`` and every loss be finite.
    Then one more step under torch.profiler: kernel launches and the
    device's busy share."""
    import torch
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.train import golden as TG
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = train.parse_args(["--arch", arch, *TRAIN_ARGV])
    warmup = {}
    with first_step_flops(warmup):
        res = train.run(args)
    peak = torch.cuda.max_memory_allocated()
    cfg, params, state = res["cfg"], res["params"], res["opt_state"]
    leaves = list(M.flatten(params).values())
    on_card = sum(t.numel() for t in leaves)
    if not (on_card == n_params == M.param_count(cfg)):
        raise AssertionError(f"train {arch}: {on_card} parameters on the "
                             f"card, {n_params} expected")
    if any(t.device.type != "cuda" for t in leaves + O.tree_leaves(state)):
        raise AssertionError(f"train {arch}: a leaf is off the card")
    losses = [h["loss"] for h in res["history"]]
    if len(losses) != 5 or not np.isfinite(losses).all():
        raise AssertionError(f"train {arch}: losses {losses}")
    tokens = args.batch * args.seq
    step_s = float(np.mean(res["times"][1:]))
    flops_ms = 6 * n_params * tokens / BF16_FLOPS_PER_S * 1e3
    opt_ms = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    # one more step, profiled
    adamw = O.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps)
    step, _, _ = S.make_train_step(cfg, None, adamw)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=1)
    batch = S.device_batch(stream.next_batch(), "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    busy, by_kernel = device_busy(prof, f"trace_train_{arch}.json.gz")
    launches = sum(n for n, _ in by_kernel.values())
    out = dict(
        arch=arch, params=on_card, losses=losses,
        grad_norms=[h["grad_norm"] for h in res["history"]],
        step_times_s=res["times"], ms_per_step=step_s * 1e3,
        tok_s=tokens / step_s, bound_ms=flops_ms + opt_ms,
        bound_flops_ms=flops_ms, bound_optimizer_ms=opt_ms,
        max_memory_allocated=peak, profiled_wall_ms=wall * 1e3,
        profiled_busy_ms=busy * 1e3, busy_share=busy / wall,
        launches=launches, warmup_flops=warmup["flops"],
        top_kernels=sorted(((k, n, us) for k, (n, us) in by_kernel.items()),
                           key=lambda r: -r[2])[:8])
    log(f"[train] {arch} full width ({on_card:,} parameters), batch "
        f"{args.batch}, seq {args.seq}: {out['ms_per_step']:.3f} ms a step "
        f"({out['tok_s']:.1f} "
        f"tok/s) over steps 2-5 against a bound of {out['bound_ms']:.3f} ms "
        f"({flops_ms:.3f} ms of 6 N tokens at 989 TFLOP/s + {opt_ms:.3f} ms "
        f"of 22 B a parameter at 3.35 TB/s); losses "
        f"{[round(x, 4) for x in losses]}; peak memory "
        f"{peak / 2**30:.3f} GiB ({peak / 1e9:.3f} GB); one profiled step: "
        f"{launches} kernel launches, wall {wall * 1e3:.3f} ms, device busy "
        f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f}%); {smi}")
    for name, n, us in out["top_kernels"][:6]:
        log(f"[train]   device {us / 1e3:8.3f} ms  x{n:<5} {name[:90]}")
    del params, state, res
    return out


def train_card_vs_cpu(arch: str, gold: dict, smi: str) -> dict:
    """One train step on the card against the port on the CPU from the
    golden's weights and first batch (``train.golden.step_deviations``,
    each measure over its bound), the optimizer on the card against the
    CPU given the CPU's gradients (bit for bit), then the golden's steps
    on the card against the JAX package's (``jax_train_golden.json``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import golden as TG
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S
    cfg = get_config(arch).reduced()
    adamw = O.AdamWConfig(**gold["adamw"])
    p_cpu = M.seeded_params(cfg, gold["weights_seed"], "cpu")
    p_dev = M.tree_map(lambda t: t.to("cuda"), p_cpu)
    batches = TG.batches(cfg, gold)
    host = TG.step_outputs(p_cpu, S.device_batch(batches[0], "cpu"), cfg,
                           adamw)
    card = TG.step_outputs(p_dev, S.device_batch(batches[0], "cuda"), cfg,
                           adamw)
    dev = TG.step_deviations(card, host, cfg.family, gold)
    if not all(v <= 1.0 for v in dev.values()):
        raise AssertionError(f"train {arch}-reduced: card against CPU "
                             f"{sorted(dev.items())} (over each bound)")
    # the optimizer alone, from the CPU's gradients: equal bit for bit
    g_dev = M.unflatten({k: v.to("cuda") for k, v in host["grads"].items()})
    new_p, st, m = O.update(adamw, p_dev, g_dev, O.init_state(p_dev))
    for name, tree in (("params", new_p), ("m", st.m), ("v", st.v)):
        for k, v in M.flatten(tree).items():
            assert_equal(f"train {arch} optimizer {name} {k}", v.cpu(),
                         host[name][k])
    if float(m["grad_norm"]) != host["grad_norm"]:
        raise AssertionError(f"train {arch}: grad norm card "
                             f"{float(m['grad_norm'])} CPU "
                             f"{host['grad_norm']}")
    # the golden's steps on the card
    want = gold["reduced"][arch]
    tol = gold["grad_tol"][cfg.family]
    norms = TG.leaf_norms(card["grads"])
    leaf = max(abs(norms[k] - w) / w for k, w in
               want["leaf_grad_norms"].items() if w)
    step, _, _ = S.make_train_step(cfg, None, adamw)
    state = O.init_state(p_dev)
    got = dict(loss=[], grad_norm=[], lr=[])
    for b in batches:
        p_dev, state, mt = step(p_dev, state, S.device_batch(b, "cuda"))
        for k in got:
            got[k].append(float(mt[k]))
    d_loss = max(abs(a - b) for a, b in zip(got["loss"], want["loss"]))
    d_norm = max(abs(a - b) / b for a, b in zip(got["grad_norm"],
                                                 want["grad_norm"]))
    if not (got["lr"] == want["lr"] and d_loss <= gold["loss_tol"]
            and d_norm <= gold["grad_norm_tol"] and leaf <= tol):
        raise AssertionError(f"train {arch}-reduced: card against the JAX "
                             f"golden: loss {d_loss}, grad norm {d_norm}, "
                             f"leaf grad norms {leaf}, lr {got['lr']} vs "
                             f"{want['lr']}")
    log(f"[train] {arch}-reduced: card against CPU (of each bound) loss "
        f"{dev['loss']:.3f}, grads {dev['grads']:.3f}, grad norm "
        f"{dev['grad_norm']:.3f}, m {dev['m']:.3f}, v {dev['v']:.3f}, params "
        f"{dev['params']:.3f}; optimizer from the CPU's gradients equal bit "
        f"for bit; against the JAX golden over {gold['steps']} steps: "
        f"|Δloss| {d_loss:.2e} (<= {gold['loss_tol']}), grad norm "
        f"{d_norm:.2e} (<= {gold['grad_norm_tol']}), leaf grad norms "
        f"{leaf:.4f} (<= {tol}), lr equal")
    return dict(card_vs_cpu=dev, jax_loss=d_loss, jax_grad_norm=d_norm,
                jax_leaf_norms=leaf)


def train_resume(smi: str) -> dict:
    """Reduced qwen3-4b through the launcher, 8 steps saving every 4, in a
    process of its own under ``torch.use_deterministic_algorithms(True)``;
    a second process resumes from a copy of its step-4 checkpoint.  Every
    leaf of the two step-8 checkpoints must be equal (sha256), the token
    stream's state too."""
    import shutil
    work = ROOT / "build" / "train_resume"
    shutil.rmtree(work, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    code = ("import sys, torch; torch.use_deterministic_algorithms(True); "
            "from repro_torch.launch import train; train.main(sys.argv[1:])")
    argv = ["--arch", "qwen3-4b", "--reduced", "--steps", "8",
            "--save-every", "4", "--log-every", "4"]

    def launch(d):
        r = subprocess.run([sys.executable, "-c", code, *argv, "--ckpt-dir",
                            str(d)], env=env, capture_output=True, text=True,
                           timeout=300)
        if r.returncode:
            raise AssertionError(f"train resume: exit {r.returncode}\n"
                                 f"{r.stdout}\n{r.stderr[-4000:]}")
        return r.stdout

    t0 = time.time()
    whole = launch(work / "whole")
    (work / "resumed").mkdir(parents=True)
    shutil.copytree(work / "whole" / "step_000000004",
                    work / "resumed" / "step_000000004")
    resumed = launch(work / "resumed")
    if "resumed from step 4" not in resumed:
        raise AssertionError(f"train resume: {resumed}")
    manifests = [json.loads((work / d / "step_000000008" / "manifest.json")
                            .read_text()) for d in ("whole", "resumed")]
    digests = [{e["path"]: e["sha256"] for e in m["leaves"]}
               for m in manifests]
    differ = [k for k in digests[0] if digests[0][k] != digests[1][k]]
    if differ or manifests[0]["data_state"] != manifests[1]["data_state"]:
        raise AssertionError(f"train resume: {len(differ)} of "
                             f"{len(digests[0])} leaves differ ({differ[:4]})"
                             f", data states {manifests[0]['data_state']} "
                             f"{manifests[1]['data_state']}")
    seconds = time.time() - t0
    log(f"[train] qwen3-4b-reduced resume: 8 steps in one process, steps "
        f"5-8 again in a second from its step-4 checkpoint, deterministic "
        f"algorithms: all {len(digests[0])} leaves of step 8 equal (sha256); "
        f"final lines {whole.splitlines()[-1]!r} / "
        f"{resumed.splitlines()[-1]!r}; {seconds:.1f} s; {smi}")
    return dict(leaves=len(digests[0]), equal=True, seconds=seconds,
                final_line=whole.splitlines()[-1])


def phase_train(smi, lm=None):
    """The LM scaffold's training path, which launches no hand-written
    kernel (its launch counts must all read 0): qwen3-4b and mamba2-780m at
    full width through ``repro_torch.launch.train``; the ten reduced
    configs' train step on the card against the port on the CPU and the
    JAX package's golden (``jax_train_golden.json``); a resumed run
    against an uninterrupted one; the meta-device counts and H100 roofline
    of the measured steps (``lm_roofline``; ``lm``: the ``lm`` phase's
    result).  The last three go side by side with the deferred
    reference-plan runs (``deferred_runs``)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import ARCHS
    from repro_torch.train import golden as TG
    t0 = time.time()
    K.reset_launches()
    full = {}
    for arch, n_params in LM_TRAIN:
        full[arch] = lm_train(arch, n_params, smi)
        torch.cuda.empty_cache()
    gold = TG.load()
    # the deferred reference-plan runs go side by side with this stretch,
    # which times nothing
    with deferred_runs() as deferred:
        reduced = {a: train_card_vs_cpu(a, gold, smi) for a in sorted(ARCHS)}
        resume = train_resume(smi)
        roofline = lm_roofline(lm, full, smi)
    launched = {k: v for k, v in K.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"train: hand-written kernels launched "
                             f"{launched}")
    seconds = time.time() - t0
    log(f"[train] no hand-written kernel launched (all {len(K.LAUNCHES)} "
        f"counts 0); phase {seconds:.1f} s")
    return dict(full=full, reduced=reduced, resume=resume,
                roofline=roofline, launches=dict(K.LAUNCHES),
                deferred=deferred, seconds=seconds)


# The LM scaffold's sharded serving path (``lm_sharded`` phase): qwen3-4b
# at full width on a (2, 2) mesh of 4 gloo ranks sharing the card, through
# the launcher's body at the JAX launcher's defaults
LM_SHARDED_MESH = ((2, 2), ("data", "model"))
# 4 decode steps, not the launcher's 32: a step takes 4.8-6.7 s on 4
# ranks sharing one card (gloo's all-gather of the FSDP blocks), and 32
# would pass the phase's 180 s alone
LM_SHARDED_GEN = 4
LM_SHARDED_ARGV = ["--arch", "qwen3-4b", "--mesh", "2x2", "--batch", "4",
                   "--prompt-len", "64", "--gen", str(LM_SHARDED_GEN)]
TEACHER_STEPS = 2        # decode steps of the teacher-forced check
# The teacher-forced check's bound at full depth (36 layers), where a bf16
# rounding flipped by another accumulation order grows layer by layer (the
# family bound, 2e-2, holds at 2 layers).  It lies between the sound
# sharded runs' largest reading, 3.57% (the same in every run: the inputs
# and the card's kernels are deterministic), and the control's, the
# one-device port on the host's CPU against the card, 3.66-4.42%: the
# sharded path may stray from one device no further than another
# accumulation order of the same arithmetic does (PERF.md §6).
FULL_DEPTH_BOUND = 4e-2


def lm_teacher_logits(params, cfg, tokens, mesh=None):
    """Teacher-forced logits: the prefill of ``tokens[:, :-TEACHER_STEPS]``
    and TEACHER_STEPS decode steps fed the tokens that follow, as
    (TEACHER_STEPS + 1, batch, vocab) f32 numpy (on a mesh: the rank's
    blocks, the whole logits)."""
    import numpy as np
    from repro_torch.models import model as M
    B, P = tokens.shape[0], tokens.shape[1] - TEACHER_STEPS
    cache = M.init_cache(cfg, B, P + 32, device=tokens.device, mesh=mesh)
    out = [M.prefill(params, tokens[:, :P], cfg, cache=cache, mesh=mesh)[0]]
    for i in range(TEACHER_STEPS):
        out.append(M.decode_step(params, tokens[:, P + i:P + i + 1], cfg,
                                 cache=cache, cache_index=P + i,
                                 mesh=mesh)[0])
    return np.stack([o.float().cpu().numpy() for o in out])


def lm_block_residuals(params, cfg, tokens, mesh=None):
    """The residual stream of a prefill of ``tokens``: the embedding, then
    every block's output, as (n_layers + 1, rows, seq, d_model) f32 numpy
    (on a mesh: the rank's rows).  ``transformer._apply_block`` is wrapped
    for the call to record them."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    seen, apply = [], T._apply_block

    def record(x, *args, **kw):
        if not seen:
            seen.append(x.float().cpu().numpy())
        out = apply(x, *args, **kw)
        seen.append(out[0].float().cpu().numpy())
        return out

    cache = M.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                         device=tokens.device, mesh=mesh)
    T._apply_block = record
    try:
        M.prefill(params, tokens, cfg, cache=cache, mesh=mesh)
    finally:
        T._apply_block = apply
    return np.stack(seen)


def lm_exact_matmuls() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def lm_sharded_rank(job):
    """One rank of the ``lm_sharded`` phase (spawned by ``run_ranks``): the
    teacher-forced check at qwen3-4b's full width on the launcher's
    weights (with ``job["diagnose"]``, also the residual stream block by
    block), the launcher's body (timed; rank 0 prints its lines), one
    profiled decode step, the ten reduced configs, ``psum_int8`` over both
    axes, and a sharded save restored onto a (2, 1) mesh."""
    import shutil
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.collectives import psum_int8
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import AbstractMesh, make_mesh
    from repro_torch.models import golden as G
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import steps as TS
    lm_exact_matmuls()
    mesh = make_mesh(*job["mesh"], backend=job["backend"])
    dev = mesh.device
    K.reset_launches()
    res = dict(rank=mesh.rank, coords=mesh.coords, backend=mesh.backend,
               device=str(dev), card=torch.cuda.get_device_name(dev))
    # the teacher-forced check on the launcher's weights (seed 0, drawn on
    # the card; each rank keeps its blocks)
    cfg = get_config("qwen3-4b")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev,
                           mesh=mesh)
    res["param_bytes"] = tree_bytes(params)
    teacher = torch.as_tensor(job["teacher"], device=dev)
    res["teacher"] = lm_teacher_logits(params, cfg, teacher, mesh)
    if job["diagnose"]:
        # every rank runs it (its collectives); 'model' peers hold the same
        # rows, so one of them returns them
        blocks = lm_block_residuals(params, cfg, teacher[:, :-TEACHER_STEPS],
                                    mesh)
        if mesh.coords["model"] == 0:
            res["blocks"] = blocks
    del params
    # the same at full width with 2 layers (weights seed 1)
    cfg2 = cfg.replace(n_layers=2)
    res["teacher_cut"] = lm_teacher_logits(M.init_params(
        cfg2, torch.Generator(dev).manual_seed(1), dev, mesh=mesh), cfg2,
        teacher, mesh)
    torch.cuda.empty_cache()
    # the launcher's body, timed from its own clock
    torch.cuda.synchronize(dev)
    mesh.stats.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    out = serve.serve(serve.parse_args(job["argv"]), mesh)
    res["serve"] = dict(prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                        tokens=out["tokens"], stats=dict(mesh.stats),
                        cache_bytes=tree_bytes(out["cache"]),
                        peak=torch.cuda.max_memory_allocated(dev))
    # one more decode step (the launcher's warmed every path) under
    # torch.profiler
    params, cache = out.pop("params"), out.pop("cache")
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    step = lambda: M.decode_step(params, tok, cfg, cache=cache,
                                 cache_index=64 + LM_SHARDED_GEN - 1,
                                 mesh=mesh)
    torch.cuda.synchronize(dev)
    mesh.stats.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    busy, by_kernel = device_busy(
        prof, f"trace_lm_sharded_{mesh.backend}_rank{mesh.rank}.json.gz")
    res["profile"] = dict(
        wall_ms=wall * 1e3, busy_ms=busy * 1e3,
        launches=sum(n for n, _ in by_kernel.values()),
        stats=dict(mesh.stats),
        top_kernels=sorted(((k[:60], n, us / 1e3)
                            for k, (n, us) in by_kernel.items()),
                           key=lambda r: -r[2])[:5])
    del params, cache, out
    torch.cuda.empty_cache()
    # the ten reduced configs, the JAX sharded golden's inputs
    res["reduced"] = G.serve_reduced(G.load_sharded(), dev, mesh)
    x = torch.from_numpy(G.collective_inputs()["x"][mesh.rank]).to(dev)
    res["psum"] = psum_int8(x, mesh, ("data", "model")).cpu().numpy()
    # a sharded save from the (2, 2) mesh, restored onto (2, 1)
    cfg_r = get_config("qwen3-4b").reduced()
    local = M.seeded_params(cfg_r, 0, dev, mesh=mesh)
    ckdir = pathlib.Path(job["ckpt"]) / "sharded"
    if mesh.rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
    mesh.barrier()
    shard = lambda m: TS.make_prefill_step(cfg_r, m, 32, 4)[2][
        "params"]
    CK.save(ckdir, 1, local, shardings=shard(mesh))
    mesh21 = AbstractMesh((2, 1), ("data", "model"), rank=mesh.rank % 2)
    restored, _, _, _ = CK.restore(ckdir, M.abstract_params(cfg_r),
                                   device=dev, shardings=shard(mesh21))
    whole = M.flatten(M.seeded_params(cfg_r, 0, "cpu"))
    sh21 = M.flatten(shard(mesh21))
    res["restore_bad"] = [
        p for p, t in M.flatten(restored).items()
        if not torch.equal(t.cpu(), SH.block(whole[p], sh21[p].spec,
                                             mesh21))]
    res["launches"] = dict(K.LAUNCHES)
    return res


def lm_sharded_diagnosis(outs, ref) -> tuple:
    """The ``--lm-sharded-only`` diagnosis: the one-device port on the
    host's CPU against the card at full depth (the control of
    FULL_DEPTH_BOUND), and the residual stream of the ranks that return
    one (``lm_block_residuals``) against one device's rows block by block:
    max|Δ| over max|one device| and the share of elements that differ
    after each block, and the first block that differs.  The embedding
    (a masked lookup summed over 'model') must be equal bit for bit."""
    import numpy as np
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import AbstractMesh
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    out = dict(cpu_rel_err=[rel(a, w) for a, w in
                            zip(ref["cpu"], ref["teacher"])],
               cpu_s=ref["cpu_s"], ranks={})
    failed = []
    for r in outs:
        if "blocks" not in r:
            continue
        mesh = AbstractMesh(*LM_SHARDED_MESH, rank=r["rank"])
        one = SH.block(ref["blocks"], (None, "data", None, None), mesh)
        err = [rel(g, o) for g, o in zip(r["blocks"], one)]
        share = [float((g != o).mean()) for g, o in zip(r["blocks"], one)]
        first = next((i for i, f in enumerate(share) if f), None)
        out["ranks"][r["rank"]] = dict(rel_err=err, differing_share=share,
                                       first_differing_layer=first)
        if share[0]:
            failed.append(f"rank {r['rank']}: the embedding differs from "
                          f"one device's in {share[0]:.4%} of its elements")
        shown = sorted({i for i in (1, 2, 4, 9, 18, len(err) - 1)
                        if i < len(err)})
        where = ("no layer's output differs" if first is None else
                 f"the first output that differs is layer {first}'s")
        log(f"[lm-sharded] residual stream block by block (rank "
            f"{r['rank']}, its rows of the prefill of 64): the embedding "
            f"{'equal' if not share[0] else 'DIFFERENT'}; {where}; after "
            f"layers {shown}: "
            f"max|d|/max|one| {[round(err[i], 5) for i in shown]}, share "
            f"of elements differing {[round(share[i], 4) for i in shown]}")
    log(f"[lm-sharded] control: the one-device port on the host's CPU "
        f"against the card at full depth "
        f"{[round(t, 5) for t in out['cpu_rel_err']]} (the CPU run "
        f"{out['cpu_s']:.1f} s)")
    return out, failed


def lm_sharded_check(label, outs, ref, gold, smi, spawn_s) -> dict:
    """Hold every rank's results (``lm_sharded_rank``) against the port on
    the card's one device (``ref``: ``teacher`` at full depth, ``cut`` at
    2 layers, ``single`` the reduced configs, and with a diagnosis
    ``blocks`` and ``cpu``) and the JAX golden; log what the mesh
    measured, then raise for every check that failed.

    The teacher-forced logits are held to the dense family bound at 2
    layers and to FULL_DEPTH_BOUND at full depth."""
    import numpy as np
    from repro_torch.models import golden as G
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    tol = gold["tolerance"]
    want_psum = G.psum_int8_host(G.collective_inputs()["x"])
    failed = []
    for r in outs:
        if not np.array_equal(r["teacher"], outs[0]["teacher"]):
            failed.append(f"rank {r['rank']}'s logits differ from rank 0's")
        launched = {k: v for k, v in r["launches"].items() if v}
        if launched:
            failed.append(f"rank {r['rank']}: hand-written kernels "
                          f"launched {launched}")
        if r["restore_bad"]:
            failed.append(f"rank {r['rank']}: restored blocks differ "
                          f"{r['restore_bad']}")
        if not np.array_equal(r["psum"], want_psum):
            failed.append(f"rank {r['rank']}: psum_int8 differs from the "
                          "host's")
    teacher = [rel(outs[0]["teacher"][i], w)
               for i, w in enumerate(ref["teacher"])]
    cut = [rel(outs[0]["teacher_cut"][i], w)
           for i, w in enumerate(ref["cut"])]
    if not max(teacher) <= FULL_DEPTH_BOUND:
        failed.append(f"qwen3-4b teacher-forced logits against one device "
                      f"{teacher} (limit {FULL_DEPTH_BOUND})")
    if not max(cut) <= tol["dense"]:
        failed.append(f"qwen3-4b with 2 layers: teacher-forced logits "
                      f"against one device {cut} (limit {tol['dense']})")
    reduced = {}
    for arch, one in ref["single"].items():
        d, bad = G.sharded_deviations(
            arch, [r["reduced"][arch] for r in outs], one, gold)
        failed += bad
        reduced[arch] = d
        log(f"[lm-sharded] {label} {arch}-reduced: against one device on "
            f"the card {max(d[k] for k in one):.5f}, against the JAX "
            f"sharded golden {max(d['jax_prefill'], d['jax_decode']):.5f}")
    diagnosis = None
    if "blocks" in ref:
        diagnosis, bad = lm_sharded_diagnosis(outs, ref)
        failed += bad
    r0 = outs[0]
    sv, pr = r0["serve"], r0["profile"]
    B, P, gen = 4, 64, LM_SHARDED_GEN
    bound_ms = ref["single_bytes"] / HBM_BYTES_PER_S * 1e3
    step_stats = pr["stats"]
    kinds = sorted({k[:-6] for k in step_stats if k.endswith("_calls")})
    per_step = {k: dict(calls=step_stats.get(f"{k}_calls", 0),
                        bytes=step_stats.get(f"{k}_bytes", 0),
                        ms=step_stats.get(f"{k}_s", 0.0) * 1e3)
                for k in kinds}
    out = dict(
        backend=r0["backend"], ranks=len(outs), spawn_s=spawn_s,
        devices=[r["device"] for r in outs],
        param_bytes_by_rank=[r["param_bytes"] for r in outs],
        prefill_ms=sv["prefill_s"] * 1e3,
        prefill_tok_s=B * P / sv["prefill_s"],
        decode_ms_per_step=sv["decode_s"] / gen * 1e3,
        decode_tok_s=B * gen / sv["decode_s"], decode_bound_ms=bound_ms,
        tokens=sv["tokens"].tolist(), run_stats=sv["stats"],
        step_collectives=per_step,
        step_staging_ms=step_stats.get("staging_s", 0.0) * 1e3,
        step_staged_bytes=step_stats.get("staged_bytes", 0),
        step_wall_ms=pr["wall_ms"], step_busy_ms=pr["busy_ms"],
        step_busy_share=pr["busy_ms"] / pr["wall_ms"],
        step_launches=pr["launches"], top_kernels=pr["top_kernels"],
        peak_bytes_by_rank=[r["serve"]["peak"] for r in outs],
        teacher_rel_err=teacher, teacher_bound=FULL_DEPTH_BOUND,
        cut_depth_rel_err=cut, reduced=reduced, diagnosis=diagnosis,
        launches_by_rank=[r["launches"] for r in outs])
    log(f"[lm-sharded] {label}: qwen3-4b full width, {len(outs)} ranks "
        f"({out['backend']}; {sorted(set(out['devices']))}), batch 4, "
        f"prompt 64, gen {gen}: prefill {out['prefill_ms']:.3f} ms "
        f"({out['prefill_tok_s']:.1f} tok/s), decode "
        f"{out['decode_ms_per_step']:.3f} ms a step "
        f"({out['decode_tok_s']:.3f} tok/s) against the one-device bound "
        f"{bound_ms:.4f} ms; teacher-forced logits (prefill, then "
        f"{TEACHER_STEPS} decode steps) against one device "
        f"{[round(t, 5) for t in teacher]} (limit {FULL_DEPTH_BOUND}), "
        f"with 2 layers {[round(t, 5) for t in cut]} (limit "
        f"{tol['dense']}); peak "
        f"{[round(p / 2**30, 3) for p in out['peak_bytes_by_rank']]} GiB by "
        f"rank; parameter blocks "
        f"{[round(b / 1e9, 3) for b in out['param_bytes_by_rank']]} GB; "
        f"ranks spawned and joined in {spawn_s:.1f} s; {smi}")
    log(f"[lm-sharded] {label} one decode step (rank 0, torch.profiler): "
        f"wall {pr['wall_ms']:.3f} ms, device busy {pr['busy_ms']:.3f} ms "
        f"({100 * out['step_busy_share']:.1f}%), {pr['launches']} kernel "
        f"launches; collectives {per_step}; staged "
        f"{out['step_staged_bytes'] / 1e9:.3f} GB in "
        f"{out['step_staging_ms']:.3f} ms; {smi}")
    if failed:
        raise AssertionError(f"lm_sharded {label}: " + "; ".join(failed))
    return out


def phase_lm_sharded(smi, diagnose=False):
    """The LM's sharded serving path on 4 gloo ranks sharing the card (and
    on one NCCL rank a card where the host has 4 or more): the one-device
    port on the card first (the teacher-forced qwen3-4b logits on the
    launcher's weights, the ten reduced configs), then the ranks
    (``lm_sharded_rank``), each held against it; no hand-written kernel
    may launch.  ``diagnose`` adds ``lm_sharded_diagnosis``."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import golden as G
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as CK
    t0 = time.time()
    K.reset_launches()
    lm_exact_matmuls()
    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()           # earlier phases' cached blocks
    cfg = get_config("qwen3-4b")
    teacher = np.random.default_rng(5).integers(
        0, cfg.vocab, (4, 64 + TEACHER_STEPS)).astype(np.int32)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    t_dev = torch.as_tensor(teacher, device=dev)
    ref = dict(teacher=lm_teacher_logits(params, cfg, t_dev))
    if diagnose:
        ref["blocks"] = lm_block_residuals(params, cfg,
                                           t_dev[:, :-TEACHER_STEPS])
        # the control: the same logits on the host's CPU (oneDNN's
        # accumulation order, not cuBLAS's)
        t_cpu = time.time()
        ref["cpu"] = lm_teacher_logits(M.tree_map(lambda t: t.cpu(), params),
                                       cfg, torch.as_tensor(teacher))
        ref["cpu_s"] = time.time() - t_cpu
    cfg2 = cfg.replace(n_layers=2)
    ref["cut"] = lm_teacher_logits(M.init_params(
        cfg2, torch.Generator(dev).manual_seed(1), dev), cfg2, t_dev)
    ref["single_bytes"] = tree_bytes(params) + tree_bytes(
        M.abstract_cache(cfg, 4, 64 + LM_SHARDED_GEN))
    del params
    torch.cuda.empty_cache()
    gold = G.load_sharded()
    ref["single"] = G.serve_reduced(gold, dev)
    ckpt = ROOT / "build" / "lm_sharded_ckpt"
    CK.save(ckpt / "single", 1, M.seeded_params(
        get_config("qwen3-4b").reduced(), 0, dev))
    job = dict(mesh=LM_SHARDED_MESH, backend="gloo", argv=LM_SHARDED_ARGV,
               teacher=teacher, ckpt=str(ckpt), diagnose=diagnose)
    out = {}
    runs = [("gloo", 4)]
    if torch.cuda.device_count() >= 4:
        runs.append(("nccl", 4))
    else:
        log("[lm-sharded] one card: no NCCL run (NCCL needs a card per "
            "rank)")
    for backend, n in runs:
        t1 = time.time()
        outs = run_ranks(lm_sharded_rank, n, dict(job, backend=backend),
                         backend=backend, timeout=900)
        label = f"{backend} {LM_SHARDED_MESH[0]}"
        out[backend] = lm_sharded_check(label, outs, ref, gold, smi,
                                        time.time() - t1)
        digests = [
            {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
             for f in sorted(next((ckpt / d).glob("step_*")).iterdir())}
            for d in ("sharded", "single")]
        if digests[0] != digests[1]:
            raise AssertionError(f"lm_sharded {label}: the sharded save's "
                                 "files differ from the one-device save's")
    launched = {k: v for k, v in K.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"lm_sharded: hand-written kernels launched "
                             f"{launched}")
    seconds = time.time() - t0
    log(f"[lm-sharded] no hand-written kernel launched on any rank; the "
        f"sharded save equals the one-device save file for file; phase "
        f"{seconds:.1f} s")
    out["seconds"] = seconds
    out["rank_launches"] = out["gloo"]["launches_by_rank"]
    return out


# The LM scaffold's sharded train step (``train_sharded`` phase): qwen3-4b
# on a (2, 2) mesh of 4 gloo ranks sharing the card, against the card's
# one device at full width with 2 layers, then the launcher at full width
# and depth
TRAIN_SHARDED_MESH = ((2, 2), ("data", "model"))
# the launcher at the JAX launcher's defaults (batch 8, seq 128): one
# warm-up step and two timed ones (a step moves about 8.8 GB a rank
# through gloo: three steps and a profiled one fill most of the phase)
TRAIN_SHARDED_ARGV = ["--arch", "qwen3-4b", "--mesh", "2x2", "--batch", "8",
                      "--seq", "128", "--steps", "3", "--log-every", "1"]
# the 2-layer check: the launcher's batch, sequence and schedule, weights
# from seed 1 drawn on the card
TRAIN_SHARDED_CUT = dict(weights_seed=1, stream_seed=0, batch=8, seq=128,
                         steps=3, adamw=dict(lr=1e-3, warmup_steps=2,
                                             total_steps=3))


def train_sharded_cfg(reduced: bool, layers=None):
    """qwen3-4b (reduced, for a rehearsal on the CPU), with ``layers``."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-4b")
    cfg = cfg.reduced() if reduced else cfg
    return cfg if layers is None else cfg.replace(n_layers=layers)


def card_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_peak(dev, reset=False) -> int:
    """The device's peak allocation (after ``reset``: zeroed); 0 on the
    CPU."""
    import torch
    if dev.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev)


def tensor_digest(t) -> str:
    """sha256 of a tensor's bytes."""
    import torch
    t = t.detach().contiguous().cpu().reshape(-1)
    return hashlib.sha256(t.view(torch.uint8).numpy()).hexdigest()


def train_sharded_rank(job):
    """One rank of the ``train_sharded`` phase (spawned by ``run_ranks``):
    qwen3-4b with 2 layers at full width (the optimizer's update of the
    rank's blocks from the one device's gradients, as digests; three train
    steps with the rank's blocks' gradient against the one device's, as
    sums of squares), then the launcher at full width and depth
    (``train.train``: rank 0 prints), its last step under torch.profiler
    on rank 0.  The one device's gradients come in a file the parent
    writes while the ranks start.  Rank 0 prints each part's seconds as
    it ends."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.train import golden as G
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S
    G.exact_matmuls()
    mesh = make_mesh(*job["mesh"], device=job["device"], backend="gloo")
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(1)
    K.reset_launches()
    res = dict(rank=mesh.rank, coords=mesh.coords, device=str(dev),
               backend=mesh.backend)
    t_rank = time.time()

    def done(part):
        if mesh.rank == 0:
            print(f"[train-sharded] rank 0: {part} at "
                  f"{time.time() - t_rank:.1f} s", flush=True)
    # 1. qwen3-4b at full width with 2 layers, once the parent has written
    # the one device's gradients
    ref_path = pathlib.Path(job["ref"])

    def wait_for(path):
        deadline = time.time() + 600
        while not path.exists():
            if (ref_path.with_suffix(".failed").exists()
                    or time.time() > deadline):
                raise RuntimeError("the one device's reference failed")
            time.sleep(0.2)
    wait_for(ref_path)
    done("the one device's gradients written")
    cut = job["cut"]
    cfg2 = train_sharded_cfg(job["reduced"], 2)
    adamw = O.AdamWConfig(**cut["adamw"])
    p_sh = S.make_train_step(cfg2, mesh, adamw)[2]["params"]
    specs = {k: s.spec for k, s in M.flatten(p_sh).items()}
    ref = torch.load(job["ref"], mmap=True)
    params = M.init_params(cfg2, torch.Generator(dev).manual_seed(
        cut["weights_seed"]), dev, mesh)
    grads = M.unflatten({k: SH.block(v, specs[k], mesh).to(dev)
                         for k, v in ref.items()})
    p = M.tree_map(torch.clone, params)
    p, st, _ = O.update(adamw, p, grads, O.init_state(p), donate=True,
                        shardings=p_sh)
    res["update_digests"] = {
        part: {k: tensor_digest(v) for k, v in M.flatten(tree).items()}
        for part, tree in (("params", p), ("m", st.m), ("v", st.v))}
    del p, st, grads
    done("the update from one device's gradients")
    t0 = time.time()
    run = G.train_run(cfg2, cut, dev, mesh, params=params, gather=False)
    d2, n2, digests = {}, {}, {}
    for k, g in run.pop("grads").items():
        want = SH.block(ref[k], specs[k], mesh).to(dev).double()
        d2[k] = float(torch.sum((g.to(dev).double() - want) ** 2))
        n2[k] = float(torch.sum(want ** 2))
        digests[k] = tensor_digest(g)
    res["cut"] = dict(run, d2=d2, n2=n2, digests=digests,
                      seconds=time.time() - t0)
    del params, ref
    done("three steps at 2 layers")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # 2. the launcher at full width and depth, its last step under
    # torch.profiler on rank 0 (its collectives counted alone), once the
    # parent's reference has left the card
    wait_for(ref_path.with_suffix(".freed"))
    card_sync(dev)
    mesh.stats.clear()
    card_peak(dev, reset=True)
    args = train.parse_args(job["argv"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    prof = (profile(activities=acts) if mesh.rank == 0
            else contextlib.nullcontext())
    profiled = {}
    made = S.make_train_step

    def make(*a, **kw):
        step, jit_for, sh = made(*a, **kw)
        calls = []

        def traced(params, state, batch):
            calls.append(1)
            if len(calls) < args.steps:
                return step(params, state, batch)
            card_sync(dev)
            profiled["before"] = dict(mesh.stats)
            mesh.stats.clear()
            with prof:
                t0 = time.perf_counter()
                out = step(params, state, batch)
                float(out[2]["loss"])
                profiled["wall_ms"] = (time.perf_counter() - t0) * 1e3
            profiled["stats"] = dict(mesh.stats)
            return out
        return traced, lambda b: (jit_for(b), traced)[1], sh
    S.make_train_step = make
    t0 = time.time()
    try:
        out = train.train(args, mesh)
    finally:
        S.make_train_step = made
    res["launcher"] = dict(
        times=out["times"], history=out["history"],
        seconds=time.time() - t0, stats=profiled["before"],
        peak=card_peak(dev), param_bytes=tree_bytes(out["params"]),
        state_bytes=tree_bytes(out["opt_state"].m) + tree_bytes(
            out["opt_state"].v))
    done("the launcher")
    res["profile"] = dict(wall_ms=profiled["wall_ms"],
                          stats=profiled["stats"])
    if mesh.rank == 0:
        busy, by_kernel = device_busy(prof, "trace_train_sharded_rank0.json.gz")
        res["profile"].update(
            busy_ms=busy * 1e3,
            launches=sum(n for n, _ in by_kernel.values()),
            top_kernels=sorted(((k[:60], n, us / 1e3)
                                for k, (n, us) in by_kernel.items()),
                               key=lambda r: -r[2])[:5])
    res["finite"] = bool(np.isfinite([v for h in out["history"]
                                      for v in h.values()]).all())
    del out
    res["launches"] = dict(K.LAUNCHES)
    return res


def train_sharded_check(outs, ref, smi, spawn_s, reduced=False,
                        counted=None) -> dict:
    """Hold every rank's results (``train_sharded_rank``) against the card's
    one device (``ref``): the 2-layer check (each leaf's gathered
    gradient within the sharded golden's ``card_grad``, rebuilt from the
    ranks' blocks' sums of squares; replicas' blocks equal; three losses
    within its ``loss``; learning rates equal; the update's blocks bit for
    bit), the launcher's losses and norms finite, no hand-written kernel
    on any rank, rank 0's profiled step's collective calls and bytes by
    kind equal to the counting mesh's (``counted``, or counted here:
    ``meta_train_sharded``); log what the mesh measured, then raise for
    every check that failed."""
    import numpy as np
    from repro_torch.analysis.count import calls_and_bytes
    from repro_torch.distributed.sharding import axes_of
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as M
    from repro_torch.train import golden as G
    from repro_torch.train import steps as S
    from repro_torch.train import optimizer as O
    tol = G.load_sharded()["tolerance"]
    failed = []
    mesh = AbstractMesh(*TRAIN_SHARDED_MESH)
    cfg2 = train_sharded_cfg(reduced, 2)
    specs = {k: s.spec for k, s in M.flatten(S.make_train_step(
        cfg2, mesh, O.AdamWConfig())[2]["params"]).items()}
    leaf_err = {}
    for k, spec in specs.items():
        axes = [a for e in spec for a in axes_of(e)]
        copies = mesh.size // int(np.prod([mesh.shape[a] for a in axes]))
        d = sum(r["cut"]["d2"][k] for r in outs) / copies
        n = sum(r["cut"]["n2"][k] for r in outs) / copies
        leaf_err[k] = float(np.sqrt(d / n)) if n else float(np.sqrt(d))
        by_block = {}
        for r in outs:
            key = tuple(r["coords"][a] for a in axes)
            by_block.setdefault(key, set()).add(r["cut"]["digests"][k])
        if any(len(v) > 1 for v in by_block.values()):
            failed.append(f"2 layers: ranks holding the same block of {k} "
                          "have different gradients")
    worst = max(leaf_err.values())
    if not worst <= tol["card_grad"]:
        failed.append(f"2 layers: gradient leaf {max(leaf_err, key=leaf_err.get)}"
                      f" {worst} against one device (limit "
                      f"{tol['card_grad']})")
    r0 = outs[0]
    loss_d = max(abs(a - b) for a, b in zip(r0["cut"]["loss"], ref["loss"]))
    if not loss_d <= tol["loss"]:
        failed.append(f"2 layers: losses {r0['cut']['loss']} against one "
                      f"device {ref['loss']}")
    if any(r["cut"]["lr"] != ref["lr"] for r in outs):
        failed.append("2 layers: learning rates differ from one device's")
    if any(r["cut"]["loss"] != r0["cut"]["loss"] for r in outs):
        failed.append("2 layers: the ranks' losses differ")
    for r in outs:
        for part, want in ref["update_digests"][r["rank"]].items():
            bad = [k for k, v in want.items()
                   if r["update_digests"][part][k] != v]
            if bad:
                failed.append(f"rank {r['rank']}: the update's {part} "
                              f"blocks differ from one device's: {bad}")
        launched = {k: v for k, v in r["launches"].items() if v}
        if launched:
            failed.append(f"rank {r['rank']}: hand-written kernels "
                          f"launched {launched}")
        if not r["finite"]:
            failed.append(f"rank {r['rank']}: a loss or grad norm of the "
                          "launcher is not finite")
    la, pr = r0["launcher"], r0["profile"]
    args = TRAIN_SHARDED_ARGV
    tokens = int(args[args.index("--batch") + 1]) * int(
        args[args.index("--seq") + 1])
    n_params = M.param_count(train_sharded_cfg(reduced))
    step_s = float(np.mean(la["times"][1:]))
    flops_ms = 6 * n_params * tokens / BF16_FLOPS_PER_S * 1e3
    opt_ms = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    stats = pr["stats"]
    counted = counted or meta_train_sharded(reduced)
    gloo = calls_and_bytes(stats)
    if counted["stats"] != gloo:
        failed.append(f"rank 0's step: the counting mesh's collectives "
                      f"{counted['stats']} differ from gloo's {gloo}")
    kinds = sorted({k[:-6] for k in stats if k.endswith("_calls")})
    per_step = {k: dict(calls=stats.get(f"{k}_calls", 0),
                        bytes=stats.get(f"{k}_bytes", 0),
                        ms=stats.get(f"{k}_s", 0.0) * 1e3) for k in kinds}
    peaks = [r["launcher"]["peak"] for r in outs]
    out = dict(
        ranks=len(outs), spawn_s=spawn_s, devices=[r["device"] for r in outs],
        cut_leaf_err=leaf_err, cut_worst=worst, cut_loss=r0["cut"]["loss"],
        cut_loss_one=ref["loss"], cut_seconds=r0["cut"]["seconds"],
        step_times_s=la["times"], ms_per_step=step_s * 1e3,
        tok_s=tokens / step_s, bound_ms=flops_ms + opt_ms,
        losses=[h["loss"] for h in la["history"]],
        grad_norms=[h["grad_norm"] for h in la["history"]],
        launcher_seconds=la["seconds"], launcher_stats=la["stats"],
        step_collectives=per_step,
        step_staging_ms=stats.get("staging_s", 0.0) * 1e3,
        step_staged_bytes=stats.get("staged_bytes", 0),
        step_wall_ms=pr["wall_ms"], step_busy_ms=pr.get("busy_ms"),
        step_busy_share=pr["busy_ms"] / pr["wall_ms"],
        step_launches=pr["launches"], top_kernels=pr["top_kernels"],
        peak_bytes_by_rank=peaks, peak_bytes_sum=sum(peaks),
        param_bytes_by_rank=[r["launcher"]["param_bytes"] for r in outs],
        state_bytes_by_rank=[r["launcher"]["state_bytes"] for r in outs],
        launches_by_rank=[r["launches"] for r in outs],
        counted_collectives=counted["stats"])
    log(f"[train-sharded] qwen3-4b full width, 2 layers, {len(outs)} gloo "
        f"ranks ({sorted(set(out['devices']))}), mesh "
        f"{TRAIN_SHARDED_MESH[0]}, batch 8, seq 128: worst gradient leaf "
        f"against one device {worst:.5f} (limit {tol['card_grad']}), losses "
        f"{[round(x, 5) for x in out['cut_loss']]} against "
        f"{[round(x, 5) for x in ref['loss']]}; the update's blocks bit for "
        f"bit; {smi}")
    log(f"[train-sharded] the launcher, qwen3-4b full width and depth, "
        f"{len(outs)} ranks: {out['ms_per_step']:.3f} ms a step "
        f"({out['tok_s']:.2f} tok/s) over steps 2-3 (step 3 profiled on "
        f"rank 0; steps {[round(t, 3) for t in la['times']]} s) against "
        f"the one-device "
        f"bound {out['bound_ms']:.3f} ms; losses "
        f"{[round(x, 4) for x in out['losses']]}, grad norms "
        f"{[round(x, 4) for x in out['grad_norms']]}; peak "
        f"{[round(p / 2**30, 3) for p in peaks]} GiB by rank, "
        f"{sum(peaks) / 1e9:.3f} GB together; parameter blocks "
        f"{[round(b / 1e9, 3) for b in out['param_bytes_by_rank']]} GB, "
        f"moments {[round(b / 1e9, 3) for b in out['state_bytes_by_rank']]}"
        f" GB; the one device's reference and the ranks {spawn_s:.1f} s; "
        f"{smi}")
    log(f"[train-sharded] the launcher's step 3 (rank 0, torch.profiler): "
        f"wall "
        f"{pr['wall_ms']:.3f} ms, device busy {pr['busy_ms']:.3f} ms "
        f"({100 * out['step_busy_share']:.1f}%), {pr['launches']} kernel "
        f"launches; collectives {per_step}; staged "
        f"{out['step_staged_bytes'] / 1e9:.3f} GB in "
        f"{out['step_staging_ms']:.3f} ms; {smi}")
    log(f"[train-sharded] the counting mesh's rank-0 calls and bytes by "
        f"kind (meta device) "
        + ("equal" if counted["stats"] == gloo else "DIFFER FROM")
        + f" gloo's for the step: {counted['stats']}")
    if failed:
        raise AssertionError("train_sharded: " + "; ".join(failed))
    return out


def train_sharded_reference(cfg2, dev, ref_path, ref: dict) -> None:
    """The one device's side of the ``train_sharded`` phase, into ``ref``:
    three train steps of ``cfg2`` (its first gradients written to
    ``ref_path`` for the ranks, by a rename once whole), and the update
    from those gradients cut into each rank's blocks as digests (hashed
    in threads while the ranks run).  Once its tensors have left the card
    it writes ``ref_path`` with the suffix ``.freed`` (the ranks' launcher
    waits for it: the card holds the four ranks' full-depth state and
    little more); a failure writes the suffix ``.failed`` so that the
    ranks stop waiting."""
    import concurrent.futures
    import torch
    from repro_torch.distributed.sharding import block
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as M
    from repro_torch.train import golden as G
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S
    try:
        t0 = time.time()
        cut = TRAIN_SHARDED_CUT
        adamw = O.AdamWConfig(**cut["adamw"])
        params = M.init_params(cfg2, torch.Generator(dev).manual_seed(
            cut["weights_seed"]), dev)
        first = M.tree_map(torch.clone, params)
        one = G.train_run(cfg2, cut, dev, params=params)
        del params
        tmp = ref_path.with_suffix(".tmp")
        torch.save(one["grads"], tmp)
        tmp.rename(ref_path)
        ref["steps_s"] = time.time() - t0
        p, st, _ = O.update(adamw, first, M.unflatten(
            {k: v.to(dev) for k, v in one.pop("grads").items()}),
            O.init_state(first), donate=True)
        host = {part: {k: v.cpu() for k, v in M.flatten(tree).items()}
                for part, tree in (("params", p), ("m", st.m), ("v", st.v))}
        del p, st, first
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref_path.with_suffix(".freed").write_text("")
        p_sh = M.flatten(S.make_train_step(
            cfg2, AbstractMesh(*TRAIN_SHARDED_MESH), adamw)[2]["params"])
        meshes = [AbstractMesh(*TRAIN_SHARDED_MESH, rank=r) for r in range(4)]
        keys = [(r, part, k) for r in range(4) for part in host
                for k in host[part]]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            digests = pool.map(lambda key: tensor_digest(block(
                host[key[1]][key[2]], p_sh[key[2]].spec, meshes[key[0]])),
                keys)
            table = [{part: {} for part in host} for _ in range(4)]
            for (r, part, k), d in zip(keys, digests):
                table[r][part][k] = d
        ref.update(one, update_digests=table, seconds=time.time() - t0)
    except BaseException as e:
        ref["error"] = e
        ref_path.with_suffix(".failed").write_text(repr(e))


def phase_train_sharded(smi, device="cuda", reduced=False, counted=None):
    """The LM's sharded train step on 4 gloo ranks sharing the card: the
    one-device port on the card (``train_sharded_reference``: qwen3-4b at
    full width with 2 layers, three train steps, the update from its
    first gradients cut into each rank's blocks as digests) while the
    ranks start (``train_sharded_rank``), each held against it; no
    hand-written kernel may launch (the reduced configs' sharded train
    step on the card is the ``gpu`` cases').  ``device`` "cpu" and
    ``reduced`` rehearse it on the host with qwen3-4b's reduced config;
    ``counted``: the train phase's counting-mesh count of rank 0's step
    (``meta_train_sharded``)."""
    import threading
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.train import golden as G
    t0 = time.time()
    K.reset_launches()
    G.exact_matmuls()
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_path = ROOT / "build" / "train_sharded" / "ref_grads.pt"
    ref_path.parent.mkdir(parents=True, exist_ok=True)
    marks = [ref_path.with_suffix(s) for s in (".freed", ".failed")]
    for stale in [ref_path] + marks:
        stale.unlink(missing_ok=True)
    ref = {}
    worker = threading.Thread(target=train_sharded_reference, args=(
        train_sharded_cfg(reduced, 2), dev, ref_path, ref))
    worker.start()
    argv = TRAIN_SHARDED_ARGV + (["--reduced", "--device", "cpu"]
                                 if reduced else [])
    job = dict(mesh=TRAIN_SHARDED_MESH, argv=argv, cut=TRAIN_SHARDED_CUT,
               ref=str(ref_path), device=dev.type, reduced=reduced)
    try:
        outs = run_ranks(train_sharded_rank, 4, job, backend="gloo",
                         timeout=900)
    finally:
        worker.join()
    if "error" in ref:
        raise ref["error"]
    out = train_sharded_check(outs, ref, smi, time.time() - t0, reduced,
                              counted)
    for path in [ref_path] + marks:
        path.unlink(missing_ok=True)
    launched = {k: v for k, v in K.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"train_sharded: hand-written kernels launched "
                             f"{launched}")
    seconds = time.time() - t0
    log(f"[train-sharded] no hand-written kernel launched on any rank; the "
        f"one device's steps {ref['steps_s']:.1f} s, its digests done at "
        f"{ref['seconds']:.1f} s; phase {seconds:.1f} s")
    out["seconds"] = seconds
    out["rank_launches"] = out["launches_by_rank"]
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
    # cuBLAS reduces split-K partials of bf16 products in f32 (the LM phase)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    if "--lm-sharded-only" in sys.argv[1:]:
        # the sharded LM phase alone; no kernels line and no result line
        lm_sharded = timed("lm_sharded", phase_lm_sharded, smi, True)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_lm_sharded.json").write_text(json.dumps(
            dict(device=name, nvidia_smi=smi, lm_sharded=lm_sharded,
                 phase_seconds=seconds), indent=1, default=str))
        log(smi)
        return 0
    if "--train-sharded-only" in sys.argv[1:]:
        # the sharded training phase alone; no kernels line and no result
        # line
        train_sharded = timed("train_sharded", phase_train_sharded, smi)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_train_sharded.json").write_text(json.dumps(
            dict(device=name, nvidia_smi=smi, train_sharded=train_sharded,
                 phase_seconds=seconds), indent=1, default=str))
        log(smi)
        return 0
    if "--train-only" in sys.argv[1:]:
        # the training phase alone; no kernels line and no result line
        train_ = timed("train", phase_train, smi)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_train.json").write_text(json.dumps(
            dict(device=name, nvidia_smi=smi, train=train_,
                 phase_seconds=seconds), indent=1, default=str))
        log(smi)
        return 0
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
    bench = timed("bench", phase_bench, dev, smi)
    lm = timed("lm", phase_lm, smi)
    train_ = timed("train", phase_train, smi, lm)
    lm_sharded = timed("lm_sharded", phase_lm_sharded, smi)
    train_sharded = timed("train_sharded", phase_train_sharded, smi, "cuda",
                          False, train_["roofline"]["train_sharded"])

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
            **paper["launches"],
            **{f"bench {g}": v for g, v in bench["launches"].items()},
            **{f"lm_sharded rank {r}": v
               for r, v in enumerate(lm_sharded["rank_launches"])},
            **{f"train_sharded rank {r}": v
               for r, v in enumerate(train_sharded["rank_launches"])}}
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
            launches_by_run={n: v.get(k, 0) for n, v in runs.items()},
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
             bench=bench, lm=lm, lm_sharded=lm_sharded, train=train_,
             train_sharded=train_sharded,
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
    log("[bench-summary] " + json.dumps(dict(
        card=smi, seconds=bench["seconds"], gates={
            p: bench["profiles"]["quick"][f"{p}_gate"][f"{p}_speedup_median"]
            for p in ("chain", "cheap", "serving", "cache", "fused",
                      "fairness")})))
    log("[lm-summary] " + json.dumps(dict(
        card=smi, serve={a: {k: r[k] for k in (
            "prefill_tok_s", "decode_tok_s", "decode_ms_per_step",
            "decode_bound_ms", "step_launches", "step_busy_share",
            "max_memory_allocated")} for a, r in lm["serve"].items()},
        seconds=lm["seconds"])))
    log("[lm-sharded-summary] " + json.dumps(dict(
        card=smi, **{b: {k: r[k] for k in (
            "prefill_tok_s", "decode_tok_s", "decode_ms_per_step",
            "decode_bound_ms", "step_collectives", "step_staging_ms",
            "step_busy_share", "step_launches", "peak_bytes_by_rank")}
            for b, r in lm_sharded.items() if b in ("gloo", "nccl")},
        seconds=lm_sharded["seconds"])))
    log("[train-summary] " + json.dumps(dict(
        card=smi, full={a: {k: r[k] for k in (
            "ms_per_step", "tok_s", "bound_ms", "max_memory_allocated",
            "launches", "busy_share")} for a, r in train_["full"].items()},
        resume_equal=train_["resume"]["equal"],
        seconds=train_["seconds"])))
    log("[train-sharded-summary] " + json.dumps(dict(
        card=smi, **{k: train_sharded[k] for k in (
            "ms_per_step", "tok_s", "bound_ms", "step_collectives",
            "step_staging_ms", "step_busy_share", "step_launches",
            "peak_bytes_by_rank", "peak_bytes_sum", "cut_worst")},
        seconds=train_sharded["seconds"])))
    log(f"[seconds] {time.time() - t_all:.1f}")
    log(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
