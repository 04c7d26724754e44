"""Persistent per-stage-group microbenchmark of the port's mapping pipeline.

Times warmed-up wall clock for one ``map_chunk`` workload, split by stage
group (the groups, names and record keys of the reference package's
``benchmarks/microbench.py``):

    cheap         the shipped cheap phase (batch-level detect/query/vote,
                  packed-entry gathers; ``cheap_fused`` under the kernels
                  plan) over the whole chunk
    cheap_pre     the pre-fast-path cheap phase on the SAME signals:
                  two-median normalization, scatter segment means (for the
                  kernels backend: the ``event_detect`` primitive),
                  unpacked four-gather query and per-read vote scatters
    detect/query/vote (+ _pre)   the cheap phase's stage groups timed
                  individually on the pipeline's real intermediate data
    chain_fast    the filter-aware chaining fast path of core/pipeline.py
                  (read compaction + select-then-sort width ladder +
                  ring-buffer banded DP) on the cheap phase's real outputs
    chain_pre     the pre-fast-path chaining implementation on the SAME
                  inputs: full E*H anchor sort + the band-window reference
                  DP (chaining.sort_anchors_reference / chain_dp_reference;
                  the kernels backend keeps its sort and DP kernels)
    map_chunk     the full chunk program (fast path on)
    map_chunk_pre the full chunk program with chain_compaction disabled
                  (the whole-graph route)
    serving_fast  continuous-batching multi-stream serving (ServeDriver):
                  many short streams packed across stream boundaries into
                  full chunks
    serving_pre   the single-tenant serving baseline on the SAME streams:
                  each stream mapped separately through the driver loop,
                  so every stream pays its own padded partial chunk
    cache         the out-of-core tiered-index group (top-level ``cache``
                  key, not per-backend): the same reads through the
                  ``query:tiered`` hot-tile cache vs the fully-resident
                  table, plus the cache's hit-rate / paged-bytes telemetry
    fused         the whole-phase kernel group (top-level ``fused`` key):
                  the cheap phase through ``cheap_fused`` (ONE launch) vs
                  the same kernels plan's per-stage program
                  (``pipeline.cheap_phase(use_fused=False)``)
    fairness      the multi-tenant fair-serving group (top-level
                  ``fairness`` key): one flooded two-tenant trace served
                  with vs without per-tenant shed budgets; the gated metric
                  is the well-behaved tenant's victim count on the VIRTUAL
                  clock, fully deterministic

The reference package's ``jax.vmap`` over reads is the port's
row-independent (R, ...) program: a "pre" side is one batched program,
never a Python loop over reads.  Where pre and fast are the same program
(the kernels backend's detect group) the recorded ratio sits near 1.

``python -m repro_torch.scripts.bench_pipeline`` drives this and writes the
results to a per-device file (``results/bench_torch/<cpu|cuda>/``); the
card's baseline is ``bench_pipeline_h100.json`` beside this module.

All timings are min-over-repeats of a call ended by a device sync, AFTER a
warm-up call, so one-time costs (the kernels' build, the allocator) are
excluded.  Runs on CUDA unless given ``device="cpu"``, where the kernel
wrappers take their plain versions.

Quick-profile rule: the kernels backend (and the fused group) may run on a
REDUCED read grid (``run(pallas_reduced_reads=...)``; the parameter names
are the reference package's); every record carries ``grid_reads`` /
``grid_reduced`` markers, and the pre/fast pair of every group shares one
grid.
"""
from __future__ import annotations

import os
import platform
import subprocess
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import git_sha
from repro_torch.core import MarsConfig, build_index, chaining, seeding, stages
from repro_torch.core import events, pipeline, vote
from repro_torch.core.index import index_arrays, index_arrays_unpacked
from repro_torch.core.pipeline import check_device
from repro_torch.signal import simulate

def hardware_key(device="cuda") -> Dict[str, object]:
    """The hardware/software fingerprint stamped into every measured
    profile and gate record, so numbers measured on different machines are
    never silently compared (absolute ms are machine-bound; the gate's
    pre/fast ratios are not).  On a card it names the card and its power
    limit as nvidia-smi reports them."""
    device = torch.device(device)
    key = dict(machine=platform.machine(), system=platform.system(),
               cpu_count=os.cpu_count() or 0,
               python=platform.python_version(), torch=torch.__version__,
               cuda=torch.version.cuda, device_type=device.type)
    if device.type == "cuda":
        key["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    return key


def block_until_ready(x):
    """Wait for every CUDA tensor in ``x`` (tensors, tuples, lists, dicts,
    named tuples): the counterpart of ``jax.block_until_ready``.  Host
    values need no wait."""
    stack = [x]
    while stack:
        y = stack.pop()
        if isinstance(y, torch.Tensor):
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
                return x
        elif isinstance(y, dict):
            stack.extend(y.values())
        elif isinstance(y, (tuple, list)):
            stack.extend(y)
    return x


def time_fn(fn, *args, repeats: int = 5) -> float:
    """Min-of-repeats wall seconds for ``fn(*args)``; one warm-up call first
    (builds the kernels, primes caches)."""
    block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def make_workload(n_reads: int = 32, ref_events: int = 20_000,
                  junk_frac: float = 0.5, seed: int = 0, device="cuda"):
    """One benchmark chunk: a synthetic reference + a read mix where
    ``junk_frac`` of the reads are unmappable noise (the population the
    filters — and therefore the compaction gate — are built for).  Returns
    (cfg, signals (R, S) on ``device``, arrays): the packed index on the
    device, its unpacked oracle view under ``_unpacked`` and the host
    ``Index`` under ``_index``."""
    device = check_device(device)
    cfg = MarsConfig(hash_bits=14).with_mode("ms_fixed")
    ref = simulate.make_reference(ref_events, seed=seed)
    reads = simulate.sample_reads(ref, n_reads, signal_len=cfg.signal_len,
                                  seed=seed + 1, junk_frac=junk_frac)
    idx = build_index(ref.events_concat, ref.n_events, cfg)
    arrays = index_arrays(idx, device)
    arrays["_unpacked"] = index_arrays_unpacked(idx, device)
    arrays["_index"] = idx                  # host Index (tiered-cache group)
    return cfg, torch.from_numpy(reads.signals).to(device), arrays


def _split_arrays(arrays):
    """(packed online dict, unpacked oracle dict) from make_workload's
    arrays dict — the packed dict must not carry the oracle or the
    host-side "_"-prefixed extras."""
    unpacked = arrays.get("_unpacked")
    packed = {k: v for k, v in arrays.items() if not k.startswith("_")}
    if unpacked is None:
        if "entries_key" not in packed:
            raise ValueError(
                "cheap-phase microbenchmark needs the unpacked oracle "
                "planes: use make_workload (which embeds them under "
                "'_unpacked') or pass index_arrays_unpacked output")
        unpacked = packed                # caller brought an unpacked dict
    return packed, unpacked


def _chain_programs(cfg: MarsConfig, signals, arrays, backend: str):
    """The cheap phase and the pre/fast chaining programs of one backend;
    returns (cheap_call, fast_call, pre_call) where the chain calls are
    argless closures over the cheap phase's real outputs."""
    arrays, _ = _split_arrays(arrays)
    plan = stages.resolve_plan(cfg, backend)
    prims = stages.chain_primitives(plan, cfg)
    if prims is None:
        raise ValueError(
            f"backend {backend!r} resolves to a plan whose chain stages "
            "expose no primitives; the chaining microbenchmark cannot "
            f"time it (plan: {plan})")
    sorter, dp = prims

    q_pos, t_pos, hv, counters = pipeline.cheap_phase(signals, arrays, cfg,
                                                      plan)
    cnt = counters["n_anchors_postvote"]

    def pre():
        # the pre-fast-path chain program: full-width sort + the band-
        # window reference DP ("pre" side of the speedup claim).  The
        # kernels backend keeps its sorter (full width) and its DP kernel.
        sq, st, sv = chaining.sort_anchors_reference(q_pos, t_pos, hv, cfg,
                                                     sorter=sorter)
        if backend == stages.REFERENCE:
            f, d = chaining.chain_dp_reference(sq, st, sv, cfg)
        else:
            f, d = dp(sq, st, sv)
        res = chaining.best_chain(f, d, sv, cfg)
        return res.t_start, res.score, res.mapped

    return (lambda: pipeline.cheap_phase(signals, arrays, cfg, plan),
            lambda: pipeline._chain_outputs(q_pos, t_pos, hv, cnt, cfg,
                                            prims),
            pre)


def _chunk_programs(cfg: MarsConfig, signals, arrays, backend: str):
    """(map_chunk_call, map_chunk_pre_call): the whole chunk program of one
    backend, with the chaining fast path on and with ``chain_compaction``
    off (the whole-graph route)."""
    packed, _ = _split_arrays(arrays)
    plan = stages.resolve_plan(cfg, backend)
    cfg_pre = cfg.replace(chain_compaction=False)
    plan_pre = stages.resolve_plan(cfg_pre, backend)
    return (lambda: pipeline.map_chunk(signals, packed, cfg, plan=plan),
            lambda: pipeline.map_chunk(signals, packed, cfg_pre,
                                       plan=plan_pre))


def _cheap_programs(cfg: MarsConfig, signals, arrays, backend: str):
    """The pre/fast cheap-phase programs of one backend, whole-phase and
    per stage group (detect / query / vote), all on the pipeline's real
    intermediate data.

    Returns (fast_calls, pre_calls): dicts keyed "cheap"/"detect"/"query"/
    "vote" of argless closures.  The "pre" side reconstructs the pre-fast-
    path configuration: two-median normalization + scatter segment means
    (``events.detect_events_reference``; for the kernels backend its
    ``event_detect`` primitive, the same program as the fast side),
    unpacked four-gather query (``seeding.query_index_reference``) and
    per-read vote scatters (``vote.vote_filter_reference``).
    """
    packed, unpacked = _split_arrays(arrays)
    plan = stages.resolve_plan(cfg, backend)
    prims = stages.cheap_primitives(plan, cfg)
    if prims is None:
        raise ValueError(f"backend {backend!r} has no batch-level cheap "
                         f"phase to time (plan: {plan})")
    gather = prims.gather
    det_prim = stages.get_backend("detect", dict(plan)["detect"]).primitive

    # ---- detect ----
    if det_prim is not None:
        det_fast = lambda: prims.detector(signals)
        det_pre = lambda: det_prim(signals, cfg)
    else:
        det_fast = lambda: events.detect_events(signals, cfg)[:2]
        det_pre = lambda: events.detect_events_reference(signals, cfg)[:2]

    # real intermediate data for the later stage groups
    q_pos, t_pos, hit_valid, counters = pipeline.cheap_phase(
        signals, packed, cfg, plan)
    means, _n = det_fast()
    st = stages.execute_stages({"events": means,
                                "n_events": counters["n_events"],
                                "counters": {}},
                               packed, cfg, plan, ("quantize", "seed"))
    keys, seed_valid = st["keys"], st["seed_valid"]

    def cheap_pre():
        if det_prim is None:
            ev, n, _ = events.detect_events_reference(signals, cfg)
        else:
            ev, n = det_prim(signals, cfg)
        s = stages.execute_stages({"events": ev, "n_events": n,
                                   "counters": {}},
                                  packed, cfg, plan, ("quantize", "seed"))
        tp, hv, _c = seeding.query_index_reference(
            s["keys"], s["seed_valid"], unpacked, cfg, gather=gather)
        qp = torch.arange(cfg.max_events, dtype=torch.int32,
                          device=tp.device)[None, :, None].expand(tp.shape)
        hv, _c2 = vote.vote_filter_reference(qp, tp, hv, cfg)
        return qp, tp, hv

    fast_calls = {
        "cheap": lambda: pipeline.cheap_phase(signals, packed, cfg, plan),
        "detect": det_fast,
        "query": lambda: seeding.query_index(keys, seed_valid, packed, cfg,
                                             gather=gather),
        "vote": lambda: vote.vote_filter(q_pos, t_pos, hit_valid, cfg),
    }
    pre_calls = {
        "cheap": cheap_pre,
        "detect": det_pre,
        "query": lambda: seeding.query_index_reference(
            keys, seed_valid, unpacked, cfg, gather=gather),
        "vote": lambda: vote.vote_filter_reference(q_pos, t_pos, hit_valid,
                                                   cfg),
    }
    return fast_calls, pre_calls


def _interleaved(fast_c, pre_c, rounds: int):
    """Paired pre/fast timing: both programs per round, so machine-speed
    swings between rounds hit both equally.  Returns (min fast, min pre,
    median per-round pre/fast ratio) — the median paired ratio is stable
    where separately-measured absolute times swing."""
    block_until_ready(fast_c())
    block_until_ready(pre_c())
    tf = tp = float("inf")
    ratios = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        block_until_ready(fast_c())
        tf_k = time.perf_counter() - t0
        t0 = time.perf_counter()
        block_until_ready(pre_c())
        tp_k = time.perf_counter() - t0
        tf, tp = min(tf, tf_k), min(tp, tp_k)
        ratios.append(tp_k / tf_k)
    return tf, tp, float(np.median(ratios))


def bench_backend(cfg: MarsConfig, signals, arrays, backend: str,
                  repeats: int = 5,
                  include_serving: bool = True) -> Dict[str, float]:
    """Stage-group timings (seconds) for one registry backend.

    ``include_serving=False`` skips the serving pre/post group (the quick
    profile does not gate on the kernels backend's)."""
    cheap_c, fast_c, pre_c = _chain_programs(cfg, signals, arrays, backend)
    chunk_c, chunk_pre_c = _chunk_programs(cfg, signals, arrays, backend)

    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds=max(3 * repeats, 15))
    groups = {
        "cheap": time_fn(cheap_c, repeats=repeats),
        "chain_fast": tf,
        "chain_pre": tp,
        "chain_speedup": ratio,
        "map_chunk": time_fn(chunk_c, repeats=repeats),
        "map_chunk_pre": time_fn(chunk_pre_c, repeats=repeats),
    }

    # cheap-phase pre/post groups
    cf, cp = _cheap_programs(cfg, signals, arrays, backend)
    ctf, ctp, cratio = _interleaved(cf["cheap"], cp["cheap"],
                                    rounds=max(repeats, 3))
    groups.update(cheap_fast=ctf, cheap_pre=ctp, cheap_speedup=cratio)
    for g in ("detect", "query", "vote"):
        gtf, gtp, gratio = _interleaved(cf[g], cp[g], rounds=max(repeats, 3))
        groups.update({f"{g}_fast": gtf, f"{g}_pre": gtp,
                       f"{g}_speedup": gratio})

    # serving pre/post group (continuous batching across streams)
    if include_serving:
        groups.update(bench_serving(cfg, signals, arrays, backend,
                                    repeats=repeats))
    else:
        groups["serving_skipped"] = True
    return groups


# --------------------------------------------------------------------------- #
# Serving (continuous batching across streams)
# --------------------------------------------------------------------------- #
class _PlanMapper:
    """Minimal Mapper stand-in over pre-built index arrays: exactly the
    ``cfg`` + ``chunk_fn()`` surface ServeDriver needs (no Index object,
    no device re-upload per construction)."""

    def __init__(self, arrays, cfg: MarsConfig, plan):
        self.arrays, self.cfg, self.plan = arrays, cfg, plan
        self.device = arrays["bucket_start"].device

    def chunk_fn(self):
        return lambda sig, nv: pipeline.map_chunk(
            torch.from_numpy(np.ascontiguousarray(sig, np.float32)).to(
                self.device), self.arrays, self.cfg, n_valid=nv,
            plan=self.plan)


def _host(signals) -> np.ndarray:
    return signals.cpu().numpy().astype(np.float32, copy=False)


def _serving_programs(cfg: MarsConfig, signals, arrays, backend: str,
                      stream_len: int = 2, chunk: int = 8):
    """(fast_call, pre_call, mapper, streams): the serving pre/post pair on
    one fixed multi-stream workload.

    The workload is R reads split into R/stream_len single-tenant streams
    (short streams — the sequencer-channel shape).  ``pre`` maps each
    stream separately through the unified driver loop, so every stream
    pays its own padded partial chunk; ``fast`` serves the identical reads
    through ServeDriver, which packs ready reads across stream boundaries
    into full chunks.  Outputs are bit-identical; the speedup is the
    padding the packer eliminates."""
    from repro_torch.core import driver
    from repro_torch.core.server import ServeDriver

    arrays, _ = _split_arrays(arrays)
    plan = stages.resolve_plan(cfg, backend)
    mapper = _PlanMapper(arrays, cfg, plan)
    fn = mapper.chunk_fn()
    host = _host(signals)
    n = (host.shape[0] // stream_len) * stream_len
    streams = [host[i:i + stream_len] for i in range(0, n, stream_len)]

    def pre_call():
        return [driver.collect(driver.stream_map(
            fn, driver.array_chunks(s, chunk))) for s in streams]

    def fast_call():
        sd = ServeDriver(mapper, chunk=chunk)
        for si, s in enumerate(streams):
            sd.submit(f"s{si}", s)
        sd.drain()
        return [sd.results(f"s{si}").t_start for si in range(len(streams))]

    return fast_call, pre_call, mapper, streams


def bench_serving(cfg: MarsConfig, signals, arrays, backend: str,
                  repeats: int = 5, offered_load: float = 0.7,
                  chunk: int = 8) -> Dict[str, float]:
    """The serving pre/post group: interleaved single-tenant vs
    continuous-batching timings, plus wall-clock streams/sec and the
    virtual-time p99 latency at a fixed offered load (Poisson arrivals at
    ``offered_load`` x chunk capacity)."""
    from repro_torch.core.server import ServeDriver

    fast_c, pre_c, mapper, streams = _serving_programs(
        cfg, signals, arrays, backend, chunk=chunk)
    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds=max(repeats, 3))
    out = {"serving_fast": tf, "serving_pre": tp, "serving_speedup": ratio,
           "serving_streams": len(streams), "serving_chunk": chunk}

    # throughput + tail latency at fixed offered load (virtual clock:
    # 1 unit = one full-length chunk service)
    rng = np.random.default_rng(0)
    n = len(streams) * streams[0].shape[0]
    times = np.cumsum(rng.exponential(1.0 / (offered_load * chunk), n))
    flat = np.concatenate(streams)
    trace = [(float(times[k]), f"s{k % len(streams)}", flat[k])
             for k in range(n)]

    def serve():
        sd = ServeDriver(mapper, chunk=chunk)
        return sd, sd.serve_trace(trace)

    serve()                                   # warm-up
    t0 = time.perf_counter()
    sd, reports = serve()
    wall = time.perf_counter() - t0
    p99 = float(np.max([r.p99_latency for r in reports.values()]))
    out.update(serving_offered_load=offered_load,
               serving_wall_s=wall,
               serving_streams_per_sec=len(streams) / wall,
               serving_reads_per_sec=n / wall,
               serving_p99_virtual=p99,
               serving_pad_rows=sd.n_pad_rows,
               serving_chunks=sd.n_chunks)
    return out


def bench_serving_ratio(cfg: MarsConfig, signals, arrays,
                        backend: str = stages.REFERENCE,
                        rounds: int = 25) -> Dict[str, float]:
    """The serving twin of ``bench_chain_ratio``: interleaved single-tenant
    (pre) vs continuous-batching (fast) rounds over the same streams,
    median paired ratio as the machine-speed-independent gate estimator."""
    fast_c, pre_c, _, _ = _serving_programs(cfg, signals, arrays, backend)
    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds)
    return {"serving_fast_min": tf, "serving_pre_min": tp, "rounds": rounds,
            "serving_speedup_median": ratio}


# --------------------------------------------------------------------------- #
# Fairness (multi-tenant shed budgets)
# --------------------------------------------------------------------------- #
def _fairness_runs(cfg: MarsConfig, signals, arrays, backend: str,
                   chunk: int = 8):
    """One flooded two-tenant trace, served twice: ``run(False)`` is the
    budget-free legacy driver, ``run(True)`` adds per-tenant shed budgets.

    acme: two short in-budget streams (half the bench reads); flood: one
    stream of ``5*chunk`` identical reads at HIGHER priority with an
    empty budget — the starvation shape where the legacy shed rule serves
    the flooder first and sheds acme.  All arrivals and sheds live on the
    driver's virtual clock, so both runs are deterministic: the gated
    ratio never moves with machine speed."""
    from repro_torch.core.server import ServeDriver, TenantBudget

    arrays_p, _ = _split_arrays(arrays)
    plan = stages.resolve_plan(cfg, backend)
    mapper = _PlanMapper(arrays_p, cfg, plan)
    host = _host(signals)
    acme = host[:max(host.shape[0] // 2, 2)]
    flood = np.repeat(host[-1:], 5 * chunk, axis=0)
    budgets = (TenantBudget("acme", rate=float(chunk)),
               TenantBudget("flood", rate=0.0, burst=1.0))

    def run(with_budgets: bool) -> "ServeDriver":
        sd = ServeDriver(mapper, chunk=chunk, shed=True, shed_window=2.0,
                         cost_model="sim",
                         tenant_budgets=budgets if with_budgets else None)
        half = acme.shape[0] // 2
        sd.submit("a0", acme[:half], tenant="acme", t=0.0)
        sd.submit("a1", acme[half:], tenant="acme", t=0.0)
        sd.submit("f0", flood, tenant="flood", priority=1, t=0.0)
        sd.drain()
        return sd

    return run


def _acme_victims(sd) -> int:
    # n_rejected is the total not-served count (closed-loop sheds are a
    # subset of it), so it IS the victim count — no double counting
    return sum(sd.stream(s).n_rejected for s in ("a0", "a1"))


def bench_fairness(cfg: MarsConfig, signals, arrays,
                   backend: str = stages.REFERENCE,
                   chunk: int = 8) -> Dict[str, object]:
    """The fairness pre/post group: the flooded trace without (pre) and
    with (fast) per-tenant shed budgets.  The headline metric is the
    well-behaved tenant's victim count — its reads not served (shed or
    rejected) — which budgets drive to zero by charging the flooder's own
    overflow instead."""
    run = _fairness_runs(cfg, signals, arrays, backend, chunk=chunk)
    legacy, fair = run(False), run(True)
    vl, vf = _acme_victims(legacy), _acme_victims(fair)
    tr = fair.tenant_report()
    return {"fairness_acme_victims_legacy": vl,
            "fairness_acme_victims_fair": vf,
            "fairness_shed_total_legacy": int(legacy.n_shed),
            "fairness_shed_total_fair": int(fair.n_shed),
            "fairness_flood_shed_fair": int(tr["flood"].n_shed),
            "fairness_flood_over_budget": int(tr["flood"].n_over_budget),
            "fairness_speedup": (1.0 + vl) / (1.0 + vf),
            "fairness_chunk": chunk, "fairness_backend": backend}


def bench_fairness_ratio(cfg: MarsConfig, signals, arrays,
                         backend: str = stages.REFERENCE,
                         rounds: int = 1) -> Dict[str, object]:
    """The fairness twin of ``bench_chain_ratio`` for the regression gate:
    ``(1 + legacy acme victims) / (1 + budgeted acme victims)`` on the
    flooded trace.  A VIRTUAL-clock count ratio — deterministic by
    construction, so one round suffices."""
    run = _fairness_runs(cfg, signals, arrays, backend)
    vl, vf = _acme_victims(run(False)), _acme_victims(run(True))
    return {"fairness_acme_victims_legacy": vl,
            "fairness_acme_victims_fair": vf,
            "rounds": 1, "deterministic": True,
            "fairness_speedup_median": (1.0 + vl) / (1.0 + vf)}


def _cache_programs(cfg: MarsConfig, signals, arrays, n_tiles: int = 16,
                    cache_slots: int = 4, chunk: int = 8):
    """(tiered_call, resident_call, tiered_mapper): the SAME read stream
    mapped through the out-of-core tiered backend (host-resident tiles,
    ``cache_slots``-slot device cache, prefetching driver loop —
    core/tiered.py) vs the fully-resident table (the reference plan).  The
    index spans ``n_tiles`` tiles, several times the cache, so the tiered
    side really pages; outputs are bit-identical, the timing difference is
    the paging + traffic-pre-pass overhead."""
    idx = arrays.get("_index")
    if idx is None:
        raise ValueError(
            "cache microbenchmark needs the host Index: use make_workload "
            "(which embeds it under '_index')")
    device = signals.device
    tiered = pipeline.Mapper(idx, cfg, backend="tiered", tiles=n_tiles,
                             cache_slots=cache_slots, device=device)
    resident = pipeline.Mapper(idx, cfg, device=device)
    sig = _host(signals)
    return (lambda: tiered.map_signals(sig, chunk=chunk),
            lambda: resident.map_signals(sig, chunk=chunk), tiered)


def bench_cache(cfg: MarsConfig, signals, arrays, repeats: int = 5,
                n_tiles: int = 16, cache_slots: int = 4,
                chunk: int = 8) -> Dict[str, float]:
    """The tiered-index cache group: interleaved tiered-vs-resident
    timings plus the cache's traffic telemetry (hit rate, host->device
    paged bytes) on an index several times the cache size."""
    fast_c, pre_c, mapper = _cache_programs(cfg, signals, arrays, n_tiles,
                                            cache_slots, chunk)
    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds=max(repeats, 3))
    cache = mapper.cache
    cache.reset_stats()
    fast_c()                               # one counted steady-state pass
    return {
        "cache_tiered": tf, "cache_resident": tp, "cache_speedup": ratio,
        "cache_hit_rate": cache.hit_rate,
        "cache_hits": cache.hits, "cache_misses": cache.misses,
        "cache_paged_bytes": cache.paged_bytes,
        "cache_n_tiles": n_tiles, "cache_slots": cache.n_slots,
        "cache_tile_nbytes": cache.tiered.tile_nbytes,
        "cache_nbytes": cache.cache_nbytes,
        "cache_index_nbytes": cache.tiered.nbytes,
    }


def bench_cache_ratio(cfg: MarsConfig, signals, arrays,
                      backend: str = stages.REFERENCE,
                      rounds: int = 25) -> Dict[str, float]:
    """The cache twin of ``bench_chain_ratio``: interleaved resident (pre)
    vs tiered-with-small-cache (fast) rounds over the same reads, median
    paired ratio as the machine-speed-independent gate estimator.  The
    ratio is below 1 (out-of-core paging costs something); the gate
    catches it getting WORSE."""
    del backend                            # tiered vs resident is the pair
    fast_c, pre_c, _ = _cache_programs(cfg, signals, arrays)
    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds)
    return {"cache_fast_min": tf, "cache_pre_min": tp, "rounds": rounds,
            "cache_speedup_median": ratio}


def _fused_programs(cfg: MarsConfig, signals, arrays):
    """(fast_call, pre_call): the whole-phase fused kernel (``cheap_fused``
    — ONE launch, detect..vote resident) vs the SAME kernels plan's
    per-stage batch program (``pipeline.cheap_phase(use_fused=False)``:
    the ``event_detect`` kernel, the ``pluto_lookup`` gathers and the
    reference vote, every intermediate materialized between launches).
    Outputs are bit-identical; the timing difference is the launch + HBM
    round-trip overhead the fusion removes."""
    packed, _ = _split_arrays(arrays)
    plan = stages.resolve_plan(cfg, stages.KERNELS)
    prims = stages.cheap_primitives(plan, cfg)
    if prims is None or prims.fused is None:
        raise ValueError(
            f"plan {plan} resolves no fused cheap kernel "
            "(stages.register_fused_cheap); the fused microbenchmark "
            "cannot time it")
    return ((lambda: pipeline.cheap_phase(signals, packed, cfg, plan)),
            (lambda: pipeline.cheap_phase(signals, packed, cfg, plan,
                                          use_fused=False)))


# Default read-grid cap for the fused gate phase (the reference package's;
# the reduction is recorded in the gate record; both sides share the grid).
FUSED_GATE_READS = 8


def bench_fused(cfg: MarsConfig, signals, arrays,
                repeats: int = 5) -> Dict[str, float]:
    """The fused kernel group: interleaved fused-vs-per-stage cheap phase
    on the kernels plan, plus the grid markers.  ``fused_mode`` is "cuda"
    on the card and "plain" on the CPU (the kernels' plain versions)."""
    fast_c, pre_c = _fused_programs(cfg, signals, arrays)
    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds=max(repeats, 3))
    return {"fused_fast": tf, "fused_pre": tp, "fused_speedup": ratio,
            "fused_n_reads": int(signals.shape[0]),
            "fused_mode": "cuda" if signals.is_cuda else "plain"}


def bench_fused_ratio(cfg: MarsConfig, signals, arrays,
                      backend: str = stages.KERNELS,
                      rounds: int = 25,
                      n_reads: int = FUSED_GATE_READS) -> Dict[str, float]:
    """The fused twin of ``bench_chain_ratio``: interleaved per-stage
    kernels (pre) vs fused kernel (fast) rounds over the same reads, median
    paired ratio as the machine-speed-independent gate estimator."""
    del backend              # the fused/per-stage pair IS the kernels plan
    if n_reads and n_reads < signals.shape[0]:
        signals = signals[:n_reads]
    fast_c, pre_c = _fused_programs(cfg, signals, arrays)
    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds)
    return {"fused_fast_min": tf, "fused_pre_min": tp, "rounds": rounds,
            "n_reads": int(signals.shape[0]),
            "fused_speedup_median": ratio}


def bench_chain_ratio(cfg: MarsConfig, signals, arrays,
                      backend: str = stages.REFERENCE,
                      rounds: int = 25) -> Dict[str, float]:
    """Machine-speed-independent chaining measurement for the regression
    gate: the pre and fast chain programs timed in INTERLEAVED rounds —
    each round yields a paired pre/fast ratio under the same
    instantaneous machine state — and the MEDIAN of the per-round ratios
    is the estimator."""
    _, fast_c, pre_c = _chain_programs(cfg, signals, arrays, backend)
    tf, tp, ratio = _interleaved(fast_c, pre_c, rounds)
    return {"chain_fast_min": tf, "chain_pre_min": tp, "rounds": rounds,
            "chain_speedup_median": ratio}


def bench_cheap_ratio(cfg: MarsConfig, signals, arrays,
                      backend: str = stages.REFERENCE,
                      rounds: int = 25) -> Dict[str, float]:
    """The cheap-phase twin of ``bench_chain_ratio``: interleaved pre/fast
    whole-cheap-phase rounds, median paired ratio as the gate estimator."""
    fast_calls, pre_calls = _cheap_programs(cfg, signals, arrays, backend)
    tf, tp, ratio = _interleaved(fast_calls["cheap"], pre_calls["cheap"],
                                 rounds)
    return {"cheap_fast_min": tf, "cheap_pre_min": tp, "rounds": rounds,
            "cheap_speedup_median": ratio}


# The hand-written kernels each group's closure launches under the kernels
# backend (the reference backend's launch none; so do the cache pair, whose
# tiered plan is the reference but for ``query``, and fairness, which
# ``run`` serves on the reference backend).  The pre sides' gathers are the
# code's: ``query_index_reference`` gathers the unpacked planes, all 1-D, so
# cheap_pre and query_pre launch ``pluto_lookup`` and never the row gather.
GROUP_KERNELS = {
    "cheap": ("cheap_fused",),
    "cheap_fast": ("cheap_fused",),
    "cheap_pre": ("event_detect", "pluto_lookup"),
    "detect_fast": ("event_detect",),
    "detect_pre": ("event_detect",),
    "query_fast": ("pluto_lookup", "pluto_lookup_rows"),
    "query_pre": ("pluto_lookup",),
    "vote_fast": (),
    "vote_pre": (),
    "chain_fast": ("bitonic_sort", "chain_dp"),
    "chain_pre": ("bitonic_sort", "chain_dp"),
    "map_chunk": ("cheap_fused", "bitonic_sort", "chain_dp"),
    "map_chunk_pre": ("event_detect", "pluto_lookup", "pluto_lookup_rows",
                      "bitonic_sort", "chain_dp"),
    "serving_fast": ("cheap_fused", "bitonic_sort", "chain_dp"),
    "serving_pre": ("cheap_fused", "bitonic_sort", "chain_dp"),
    "fused_fast": ("cheap_fused",),
    "fused_pre": ("event_detect", "pluto_lookup", "pluto_lookup_rows"),
    "cache_tiered": (),
    "cache_resident": (),
    "fairness": (),
}


def group_closures(cfg: MarsConfig, signals, arrays, backend: str):
    """Every timed closure of one backend by group name (the keys of
    ``GROUP_KERNELS`` but the cache pair and fairness, which take no
    backend; the fused pair only for the kernels backend): the programs
    ``run`` times, for equality and launch checks."""
    cheap_c, fast_c, pre_c = _chain_programs(cfg, signals, arrays, backend)
    chunk_c, chunk_pre_c = _chunk_programs(cfg, signals, arrays, backend)
    cf, cp = _cheap_programs(cfg, signals, arrays, backend)
    sfast, spre, _, _ = _serving_programs(cfg, signals, arrays, backend)
    out = dict(cheap=cheap_c, chain_fast=fast_c, chain_pre=pre_c,
               map_chunk=chunk_c, map_chunk_pre=chunk_pre_c,
               serving_fast=sfast, serving_pre=spre)
    for g in ("cheap", "detect", "query", "vote"):
        out[f"{g}_fast"], out[f"{g}_pre"] = cf[g], cp[g]
    if backend == stages.KERNELS:
        out["fused_fast"], out["fused_pre"] = _fused_programs(cfg, signals,
                                                              arrays)
    return out


def run(n_reads: int = 32, ref_events: int = 20_000, junk_frac: float = 0.5,
        repeats: int = 5, backends=(stages.REFERENCE, stages.KERNELS),
        seed: int = 0, pallas_serving: bool = True,
        pallas_reduced_reads: int = 0, device="cuda") -> Dict:
    """One full profile record.  ``pallas_reduced_reads`` > 0 caps the
    kernels backend's bench groups (and the fused group) to that many
    reads, with the reduction marked in the record (``grid_reads`` /
    ``grid_reduced``): the pre/fast pair of every group shares one grid.
    ``pallas_serving=False`` skips the kernels backend's serving group."""
    cfg, signals, arrays = make_workload(n_reads, ref_events, junk_frac, seed,
                                         device=device)
    rec = {
        "git_sha": git_sha(),
        "machine": hardware_key(signals.device),
        "workload": dict(n_reads=n_reads, ref_events=ref_events,
                         junk_frac=junk_frac, repeats=repeats, seed=seed,
                         signal_len=cfg.signal_len,
                         max_anchors=cfg.max_anchors,
                         chain_band=cfg.chain_band,
                         chain_widths=list(cfg.chain_widths),
                         chain_capacity_frac=cfg.chain_capacity_frac),
        "backends": {},
    }
    reduced = (0 < pallas_reduced_reads < n_reads)
    sig_kern = signals[:pallas_reduced_reads] if reduced else signals
    for b in backends:
        inc = pallas_serving or b != stages.KERNELS
        sig_b = sig_kern if b == stages.KERNELS else signals
        rec["backends"][b] = bench_backend(cfg, sig_b, arrays, b,
                                           repeats=repeats,
                                           include_serving=inc)
        rec["backends"][b].update(grid_reads=int(sig_b.shape[0]),
                                  grid_reduced=bool(sig_b.shape[0]
                                                    < n_reads))
    rec["cache"] = bench_cache(cfg, signals, arrays, repeats=repeats)
    rec["fused"] = bench_fused(cfg, sig_kern, arrays, repeats=repeats)
    rec["fairness"] = bench_fairness(cfg, signals, arrays)
    return rec


# --------------------------------------------------------------------------- #
# The deterministic fields (no timing): what a run on any device must give
# exactly, held against the reference package's (``jax_microbench.json``)
# --------------------------------------------------------------------------- #
DETERMINISTIC_BACKEND = ("grid_reads", "grid_reduced", "serving_streams",
                         "serving_chunk", "serving_offered_load",
                         "serving_p99_virtual", "serving_pad_rows",
                         "serving_chunks")
DETERMINISTIC_CACHE = ("cache_hit_rate", "cache_hits", "cache_misses",
                       "cache_paged_bytes", "cache_n_tiles", "cache_slots",
                       "cache_tile_nbytes", "cache_nbytes",
                       "cache_index_nbytes")
DETERMINISTIC_GATE = ("rounds", "n_reads", "deterministic",
                      "fairness_acme_victims_legacy",
                      "fairness_acme_victims_fair",
                      "fairness_speedup_median")


def deterministic(profile: Dict) -> Dict:
    """The deterministic fields of one profile record: the workload, each
    backend's grid markers and serving counts (virtual clock), the cache's
    counts and bytes, the fused group's read count, every fairness field,
    and the gate records' rounds / read counts / fairness counts."""
    out = {"workload": profile["workload"],
           "backends": {b: {k: r[k] for k in DETERMINISTIC_BACKEND if k in r}
                        for b, r in profile["backends"].items()},
           "cache": {k: profile["cache"][k] for k in DETERMINISTIC_CACHE},
           "fused": {"fused_n_reads": profile["fused"]["fused_n_reads"]},
           "fairness": dict(profile["fairness"])}
    gates = {k[:-len("_gate")]: {f: v[f] for f in DETERMINISTIC_GATE
                                 if f in v}
             for k, v in profile.items() if k.endswith("_gate")}
    if gates:
        out["gates"] = gates
    return out


def deterministic_mismatches(profile: Dict, golden: Dict) -> list:
    """Where ``profile``'s deterministic fields differ from ``golden``'s (a
    ``deterministic`` dict): "path: got vs want" strings, empty when equal.
    A backend whose serving group was skipped is held on its grid markers
    only; gate records only where the profile has them."""
    got = deterministic(profile)
    bad = []

    def walk(path, g, w):
        if isinstance(w, dict) and isinstance(g, dict):
            for k in sorted(set(g) | set(w)):
                if k not in g:
                    bad.append(f"{path}/{k}: missing")
                elif k not in w:
                    bad.append(f"{path}/{k}: not in the golden")
                else:
                    walk(f"{path}/{k}", g[k], w[k])
        elif g != w:
            bad.append(f"{path}: {g!r} vs {w!r}")

    want = {k: v for k, v in golden.items() if k in got}
    for b, r in profile["backends"].items():
        if r.get("serving_skipped"):
            want = {**want, "backends": {
                **want["backends"],
                b: {k: v for k, v in want["backends"][b].items()
                    if not k.startswith("serving_")}}}
    if "gates" in want:
        want["gates"] = {k: v for k, v in want["gates"].items()
                         if k in got["gates"]}
    walk("", got, want)
    return bad
