"""End-to-end MARS read-mapping pipeline (paper Fig. 1 / Fig. 7 dataflow).

    (1) event detection: signal-to-event conversion (1a) + quantization (1b)
    (2) seeding: hash-value generation (c), frequency filter (d),
        hash-table query (e), seed-and-vote filter (f)
    (3) chaining: bucket/sort (g,h) + dynamic programming (i)

Backend selection flows only through the stage registry (core/stages.py):
``map_chunk`` takes a plan resolved by ``stages.resolve_plan``;
``use_kernels=True`` asks for the hand-written CUDA kernels (the whole-
phase ``cheap_fused`` kernel, or per stage the ``event_detect`` detector
and the ``pluto_lookup`` gathers; the ``bitonic_sort`` row sorter and the
``chain_dp`` banded DP).  Every plan gives the same results bit for bit.

The per-read program is the stage graph (``stages.execute_stages``):
``map_read`` runs it over one read, ``cheap_phase_vmap`` over a chunk's
cheap stages, and the chunk program's whole-graph route over a chunk
(with ``chain_compaction`` off, or a plan whose chain stages expose no
primitives).  Each stage body maps the chunk's (R, ...) tensors at once,
so under the kernels plan a stage is one launch a chunk, as the reference
package's vmap of its unit-batch kernels is one grid.

Everything runs eagerly on the device of the input tensors.  Where the
reference package branches on device values inside one compiled program
(``lax.cond``), this pipeline branches on the host: the compaction gate and
the width ladder read the chunk's surviving-read count and largest anchor
count in ONE device->host sync per chunk (``_chain_outputs``).  With the
final copy of the per-read outputs (core/driver.py) a chunk costs two
synchronisations.

Pad rows (chunks shorter than the static chunk size) are masked out of
every counter and of ``mapped`` via ``n_valid``.

Over a mesh (``launch/mesh.py``, one process per rank) ``map_chunk_sharded``
runs the same chunk program on each rank's share of the reads and returns
the whole chunk's outputs on every rank.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core import cheap, chaining, driver, stages
from repro_torch.core.config import MarsConfig
from repro_torch.core.index import (INDEX_AXIS, Index, TieredIndex,
                                    index_arrays, partition_index,
                                    tier_index)


class MapOutput(NamedTuple):
    t_start: torch.Tensor    # (R,) int32 double-genome event coords
    score: torch.Tensor      # (R,) f32
    mapped: torch.Tensor     # (R,) bool
    n_events: torch.Tensor   # (R,) int32
    counters: Dict[str, torch.Tensor]


def check_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  A CUDA device without a card raises — there is no CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain torch path on "
            "the CPU")
    return device


def map_read(signal: torch.Tensor, index: Dict[str, torch.Tensor],
             cfg: MarsConfig, plan: Optional[stages.Plan] = None):
    """signal: (S,) f32 -> (ChainResult, counters) of 0-d tensors via the
    stage engine (``stages.execute_read``), on the signal's device."""
    if plan is None:
        plan = stages.resolve_plan(cfg, stages.REFERENCE)
    return stages.execute_read(signal, index, cfg, plan)


# --------------------------------------------------------------------------- #
# Cheap phase (detect .. vote)
# --------------------------------------------------------------------------- #
def cheap_phase_vmap(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                     cfg: MarsConfig, plan: stages.Plan):
    """The cheap phase through the stage bodies: CHEAP_STAGES (detect..vote)
    over the chunk's state dict.  Level (3) of ``cheap_phase``'s ladder,
    for plans whose cheap stages have no batch-level expression, and the
    parity comparand of the other two levels.  Returns (q_pos, t_pos,
    hit_valid, per-read counters)."""
    state = stages.execute_stages({"signal": signals, "counters": {}},
                                  index, cfg, plan, stages.CHEAP_STAGES)
    return (state["q_pos"], state["t_pos"], state["hit_valid"],
            state["counters"])


def cheap_phase(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                cfg: MarsConfig, plan: stages.Plan, use_fused: bool = True):
    """The cheap phase (detect..vote) over a chunk.

    Dispatch ladder, most-fused first: (1) the whole-phase kernel
    (``stages.fused_cheap_backend``) when the plan engages one — detect..
    vote in ONE launch; (2) the per-stage batch program
    (``cheap.cheap_phase_stages``) with the plan's ``detector`` and
    ``gather``: detect runs once per chunk and the query issues two
    whole-chunk gathers (the ``event_detect`` and ``pluto_lookup`` kernels
    where the plan resolved them; the reference math for a stage that
    resolved to the reference, as in the reference package); (3)
    ``cheap_phase_vmap``, the stage bodies, when ``stages.cheap_primitives``
    finds no batch-level expression (a registered quantize, seed or vote
    backend, or a detect backend without a primitive).
    ``use_fused=False`` pins level (2) where the plan has one.  Returns
    (q_pos, t_pos, hit_valid, counters); ``counters["n_anchors_postvote"]``
    is the per-read post-filter anchor count the compaction gate keys on.

    A tiered index view that carries the pre-pass's planes
    (``tiered.PREPASS_KEYS``) skips detect, quantize and seed: the
    pre-pass ran those stages of this plan over these very signals, so its
    keys, validity and event counts are the ones they would give.
    """
    prims = stages.cheap_primitives(plan, cfg)
    if prims is None:
        return cheap_phase_vmap(signals, index, cfg, plan)
    if "t_pre_keys" in index:
        return cheap.cheap_from_keys(index["t_pre_keys"],
                                     index["t_pre_valid"],
                                     index["t_pre_nev"], index, cfg,
                                     gather=prims.gather,
                                     query_fn=prims.query_fn)
    if use_fused and prims.fused is not None:
        return prims.fused(signals, index)
    return cheap.cheap_phase_stages(signals, index, cfg,
                                    detector=prims.detector,
                                    gather=prims.gather,
                                    query_fn=prims.query_fn)


# --------------------------------------------------------------------------- #
# Chain phase
# --------------------------------------------------------------------------- #
# How many chunks took each route through the chaining phase, keyed by
# (branch, rows chained, sort width): branch "full" chains every read of the
# chunk, "compact" only the reads with anchors left, "empty" none (rows and
# width 0); the width is a ladder width, or the full E*H when no ladder
# width bounds the largest anchor count.  Branch "graph" is the whole-graph
# route (every stage body over every read, sorting all E*H keys).
# Host-side, one entry per chunk.
CHAIN_ROUTES: collections.Counter = collections.Counter()


def _chain_widths(cfg: MarsConfig, n_keys: int):
    """The select-then-sort width ladder: configured widths that actually
    shrink the sorted array, ascending, deduplicated."""
    full = min(cfg.max_anchors, n_keys)
    return tuple(sorted({w for w in cfg.chain_widths if 0 < w < full}))


def chain_phase(q_pos: torch.Tensor, t_pos: torch.Tensor,
                hit_valid: torch.Tensor, cnt: torch.Tensor, cfg: MarsConfig,
                prims, maxcnt: Optional[int] = None,
                branch: str = "full") -> tuple:
    """The batched chaining phase (sort -> dp -> finalize) over N reads.

    Runs at the smallest width W of ``cfg.chain_widths`` that bounds every
    read's post-vote anchor count (``cnt``; ``maxcnt`` is its max when the
    caller already has it on the host), else at full width: with cnt <= W
    the W smallest packed keys are ALL surviving anchors, so the result is
    bit-identical to the full-width pipeline.

    ``branch`` names the caller's gate branch in ``CHAIN_ROUTES``.
    Returns (t_start (N,), score (N,), mapped (N,)) int32/f32/bool.
    """
    sorter, dp = prims
    key = chaining.pack_anchor_keys(q_pos, t_pos, hit_valid)
    if maxcnt is None:
        maxcnt = int(cnt.max())
    width = next((w for w in _chain_widths(cfg, key.shape[1])
                  if maxcnt <= w), None)
    CHAIN_ROUTES[(branch, key.shape[0], width or key.shape[1])] += 1
    if width is None:
        skey = sorter(key)[:, : cfg.max_anchors]
    else:
        skey = sorter(chaining._SELECTORS[cfg.anchor_select](key, width))
    sq, st, sv = chaining.decode_anchor_keys(skey)
    f, d = dp(sq, st, sv)
    res = chaining.best_chain(f, d, sv, cfg)
    return res.t_start, res.score, res.mapped


def _chain_outputs(q_pos, t_pos, hit_valid, cnt, cfg: MarsConfig, prims):
    """Read-compaction gating around ``chain_phase``.

    Zero-anchor reads are finalized with the closed-form
    ``empty_chain_result``.  When at most C = ceil(chain_capacity_frac * R)
    reads have anchors left, exactly those reads are gathered (in order),
    chained, and their results scattered back; otherwise the whole chunk
    is chained.  Each read's result is the same either way (the chaining
    phase is row-wise).  The branch and the ladder width are chosen on the
    host from ONE sync of (surviving reads, largest anchor count) — where
    the reference package compiles a fixed C-row batch and a ``lax.cond``,
    eager torch can size the batch to the survivors.
    """
    R = cnt.shape[0]
    dev = cnt.device
    empty = chaining.empty_chain_result(cfg)
    cap = min(R, max(1, math.ceil(R * cfg.chain_capacity_frac)))
    needs = cnt > 0
    n_needs, maxcnt = torch.stack(
        [needs.sum(), cnt.max().to(torch.int64)]).tolist()

    if cap >= R or n_needs > cap:
        return chain_phase(q_pos, t_pos, hit_valid, cnt, cfg, prims,
                           maxcnt=maxcnt)

    t0 = torch.full((R,), empty.t_start, dtype=torch.int32, device=dev)
    s0 = torch.full((R,), empty.score, dtype=torch.float32, device=dev)
    m0 = torch.zeros((R,), dtype=torch.bool, device=dev)
    if n_needs == 0:
        CHAIN_ROUTES[("empty", 0, 0)] += 1
        return t0, s0, m0
    # stable: survivors first, in read order
    idx = torch.argsort((~needs).to(torch.int32), stable=True)[:n_needs]
    t_c, s_c, m_c = chain_phase(q_pos[idx], t_pos[idx], hit_valid[idx],
                                cnt[idx], cfg, prims, maxcnt=maxcnt,
                                branch="compact")
    t0[idx] = t_c
    s0[idx] = s_c
    m0[idx] = m_c
    return t0, s0, m0


def _chunk_program(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                   cfg: MarsConfig, plan: stages.Plan,
                   row_valid: torch.Tensor) -> MapOutput:
    """The chunk body: run the stage graph over a chunk, mask pad rows out
    of the counters, and sum the per-read counters to CHUNK_COUNTER_SCHEMA.

    With ``cfg.chain_compaction`` (default) the graph is split: the cheap
    phase over every read, then the chaining phase over the reads with
    anchors left (``_chain_outputs``).  The chain-stage counters are exact
    in closed form: n_sorted = min(cnt, A), n_dp_pairs = n_sorted * B.
    With compaction off, or a plan whose chain stages expose no primitives
    (``stages.chain_primitives`` is None), the whole graph runs through the
    stage bodies (``stages.execute_reads``), as the reference package's
    whole-graph vmap does."""
    rv = row_valid
    prims = (stages.chain_primitives(plan, cfg)
             if cfg.chain_compaction else None)
    if prims is None:
        res, counters = stages.execute_reads(signals, index, cfg, plan)
        CHAIN_ROUTES[("graph", signals.shape[0],
                      cfg.max_events * cfg.max_hits_per_seed)] += 1
        t_start, score, mapped = res.t_start, res.score, res.mapped
    else:
        q_pos, t_pos, hit_valid, counters = cheap_phase(signals, index, cfg,
                                                        plan)
        cnt = counters["n_anchors_postvote"]
        n_sorted = torch.clamp(cnt, max=cfg.max_anchors)
        counters = {**counters, "n_sorted": n_sorted,
                    "n_dp_pairs": n_sorted * cfg.chain_band}
        missing = stages.missing_counters(counters)
        if missing:
            raise RuntimeError(f"plan {plan} produced incomplete counters; "
                               f"missing {missing}")
        t_start, score, mapped = _chain_outputs(
            q_pos, t_pos, hit_valid, cnt, cfg, prims)
    zero = torch.zeros((), dtype=torch.int32, device=signals.device)
    summed = {k: torch.where(rv, v.to(torch.int32), zero).sum().to(
                  torch.int32)
              for k, v in counters.items()
              if k not in stages.DEBUG_COUNTER_SCHEMA}
    n_rows = rv.sum().to(torch.int32)
    summed["n_reads"] = n_rows
    summed["n_samples"] = n_rows * signals.shape[1]
    return MapOutput(
        t_start=t_start, score=score, mapped=mapped & rv,
        n_events=torch.where(rv, counters["n_events"].to(torch.int32), zero),
        counters=summed)


def map_chunk(signals: torch.Tensor, index: Dict[str, torch.Tensor],
              cfg: MarsConfig, use_kernels: bool = False,
              n_valid: Optional[int] = None,
              plan: Optional[stages.Plan] = None) -> MapOutput:
    """signals: (R, S) f32 on the index's device.  The mapping program for
    one chunk.

    ``plan`` overrides backend selection; otherwise every stage's kernel
    backend when ``use_kernels``, reference backends when not.  ``n_valid``
    (defaults to R) masks trailing pad rows out of counters and ``mapped``.
    The returned ``counters`` carry exactly ``stages.CHUNK_COUNTER_SCHEMA``.
    """
    if plan is None:
        plan = stages.resolve_plan(
            cfg, stages.KERNELS if use_kernels else stages.REFERENCE)
    if stages.plan_index_kind(plan) == "partitioned":
        raise ValueError(
            f"plan {plan} uses a partitioned-index query backend; run it "
            "through map_chunk_sharded with a mesh (partitions live on the "
            f"'{INDEX_AXIS}' axis)")
    R = signals.shape[0]
    row_valid = torch.arange(R, device=signals.device) < (
        R if n_valid is None else int(n_valid))
    return _chunk_program(signals, index, cfg, plan, row_valid)


# --------------------------------------------------------------------------- #
# Sharded chunk mapping (one process per rank of a mesh)
# --------------------------------------------------------------------------- #
def _local_index(index: Dict, mesh, partitioned: bool) -> Dict:
    """The index as this rank's chunk program consumes it: a partitioned
    index with the mesh its query backend rotates over; a tiered view's
    pre-pass planes (``tiered.PREPASS_KEYS``) cut to this rank's reads like
    the signals; anything else as it is (replicated)."""
    if partitioned:
        return {**index, "mesh": mesh}
    if "t_pre_keys" not in index:
        return index
    from repro_torch.core.tiered import PREPASS_KEYS
    from repro_torch.distributed.sharding import local_rows
    return {k: local_rows(v, mesh) if k in PREPASS_KEYS else v
            for k, v in index.items()}


def sharded_chunk_fn(cfg: MarsConfig, mesh, plan: stages.Plan):
    """The sharded chunk program for a resolved plan: ``fn(signals (R, S),
    index, n_valid) -> (t_start, score, mapped, n_events, counters)``.

    Every rank passes the WHOLE chunk (numpy or a tensor) and the index as
    it holds it (``Mapper`` builds both layouts), and gets the whole
    chunk's outputs.  Rank r maps rows [r*R/n, (r+1)*R/n) (the shard order
    is row-major over ``mesh.axis_names``, the rank order) with the
    single-device chunk program, so the chaining gate, the compaction
    capacity ceil(frac * R/n) and the width ladder are per rank; pad rows
    are those past ``n_valid`` in the whole chunk.  The per-read outputs
    come back by one all-gather, the int32 counters by one all-reduce."""
    from repro_torch.distributed.sharding import gather_rows, local_rows
    partitioned = stages.plan_index_kind(plan) == "partitioned"
    if partitioned and INDEX_AXIS not in mesh.axis_names:
        raise ValueError(f"plan {plan} partitions the index over the "
                         f"'{INDEX_AXIS}' axis, absent from mesh "
                         f"{mesh.axis_names}")

    def fn(signals, index, n_valid):
        R = signals.shape[0]
        if R % mesh.size:
            raise ValueError(f"chunk of {R} reads does not shard over "
                             f"{mesh.size} devices; pad the chunk to a "
                             "multiple")
        r_loc = R // mesh.size
        x = local_rows(signals, mesh)
        row_valid = (mesh.rank * r_loc + torch.arange(
            r_loc, device=x.device)) < int(n_valid)
        out = _chunk_program(x, _local_index(index, mesh, partitioned),
                             cfg, plan, row_valid)
        names = list(out.counters)
        summed = mesh.all_reduce_sum(torch.stack(
            [out.counters[k] for k in names]))
        # (R_loc, 4) int32 rows: t_start, score's bits, mapped, n_events
        rows = gather_rows(torch.stack(
            [out.t_start, out.score.view(torch.int32),
             out.mapped.to(torch.int32), out.n_events], dim=1), mesh)
        return (rows[:, 0].contiguous(),
                rows[:, 1].contiguous().view(torch.float32),
                rows[:, 2].bool(), rows[:, 3].contiguous(),
                dict(zip(names, summed.unbind())))
    return fn


def map_chunk_sharded(signals, index: Dict, cfg: MarsConfig, mesh,
                      use_kernels: bool = False,
                      n_valid: Optional[int] = None,
                      plan: Optional[stages.Plan] = None) -> MapOutput:
    """Data-parallel ``map_chunk`` over a mesh: reads sharded over EVERY
    mesh axis (the MARS "channel stripe"), counters summed over the mesh.
    Every rank calls it with the same whole chunk ``signals`` (R, S) (numpy
    or a tensor; R must divide over the ranks) and gets the whole
    ``MapOutput`` on its device.  ``index`` is the whole table on every
    rank (the default plans) or, for ``query:ring`` / ``query:a2a``, the
    rank's resident partition (``sharding.local_partition``) — either way
    the chunk program is the single-device one.

    Per-read programs are independent and each seed's bucket lives in
    exactly one partition, so outputs equal the single-device path's bit
    for bit; int32 counter sums are associative, so the all-reduce is
    exact."""
    if plan is None:
        plan = stages.resolve_plan(
            cfg, stages.KERNELS if use_kernels else stages.REFERENCE)
    nv = signals.shape[0] if n_valid is None else n_valid
    t, s, m, ne, counters = sharded_chunk_fn(cfg, mesh, plan)(
        signals, index, nv)
    return MapOutput(t_start=t, score=s, mapped=m, n_events=ne,
                     counters=counters)


# --------------------------------------------------------------------------- #
# Host-side mapper + accuracy scoring
# --------------------------------------------------------------------------- #
class Mapper:
    """Host wrapper: owns the index on ``device``, resolves the backend plan
    once, and streams chunks through the driver.

    ``device`` defaults to CUDA; without a card it raises unless the caller
    passes ``device="cpu"`` (the plain torch path — the kernel wrappers take
    their plain versions for CPU tensors).  ``backend`` names a registry
    backend ("reference", "kernels", "tiered", or the partitioned-index
    query schedules "ring" / "a2a"); ``use_kernels=True`` is shorthand for
    "kernels".

    With a ``mesh`` (``launch/mesh.make_mesh``; every rank builds the same
    Mapper from the same inputs) the chunks run through
    ``map_chunk_sharded`` on the mesh's device, and every rank gets every
    chunk's whole output, so ``map_signals``, ``serve`` and the realtime
    ladder keep their single-device contracts.  Replicated plans hold the
    whole index on every rank; "ring" / "a2a" REQUIRE a mesh with a
    'model' axis and hold one ``partition_index`` partition a rank (the
    partition of its 'model' coordinate); the tiered cache is replicated,
    each rank paging the same tiles.

    backend="tiered" keeps the index OUT OF CORE: the packed planes are
    split into ``tiles`` host-resident bucket-range tiles and only the
    tiles each chunk's seeds touch are paged into a ``cache_slots``-slot
    device cache (core/tiered.py, ``self.cache``), the next chunk's tiles
    while the current chunk computes.  Results equal the resident index's
    bit for bit for every cache size and eviction order.  ``index`` may be
    a prebuilt ``TieredIndex`` (e.g. from ``build_index_streaming``);
    ``tiles`` is then ignored.  ``reuse_prepass`` (default) hands the
    traffic pre-pass's detect/quantize/seed outputs to the main pass, so
    that work runs once a chunk.  ``fault_plan`` (tiered only) attaches a
    seeded ``core/faults.FaultPlan`` to the cache's page-in path;
    ``cache_retries`` / ``cache_backoff`` bound its checksummed retry
    loop; ``cache_replicas=K`` pins the K hottest tiles into extra slots;
    ``cache_policy`` / ``cache_seed`` choose the eviction order
    (``tiered.HotTileCache``).
    """

    def __init__(self, index: Union[Index, TieredIndex],
                 cfg: Optional[MarsConfig] = None,
                 use_kernels: bool = False, backend: Optional[str] = None,
                 device="cuda", tiles: int = 8, cache_slots: int = 4,
                 cache_policy: str = "lru", cache_seed: int = 0,
                 fault_plan=None, cache_retries: int = 3,
                 cache_backoff: float = 1.0, reuse_prepass: bool = True,
                 cache_replicas: int = 0, mesh=None):
        self.mesh = mesh
        self.device = check_device(device) if mesh is None else mesh.device
        self.index = index
        self.cfg = cfg or index.cfg
        self.backend = backend or (
            stages.KERNELS if use_kernels else stages.REFERENCE)
        self.plan = stages.resolve_plan(self.cfg, self.backend)
        kind = stages.plan_index_kind(self.plan)
        if fault_plan is not None and kind != "tiered":
            raise ValueError(
                f"fault_plan hooks the tiered backend's tile page-in path; "
                f"backend {self.backend!r} resolves to index kind {kind!r} "
                "(no page-in to inject into)")
        # the tiered index's host-to-device tile cache (the serving driver
        # and launcher read it); None for the resident index
        self.cache = None
        if kind == "tiered":
            from repro_torch.core.tiered import HotTileCache
            ti = (index if isinstance(index, TieredIndex)
                  else tier_index(index, tiles))
            self.cache = HotTileCache(
                ti, cache_slots, device=self.device, policy=cache_policy,
                seed=cache_seed, faults=fault_plan,
                max_retries=cache_retries, backoff_base=cache_backoff,
                reuse_prepass=reuse_prepass, replicas=cache_replicas)
            self.arrays = None
        elif kind == "partitioned":
            if mesh is None or INDEX_AXIS not in mesh.axis_names:
                raise ValueError(
                    f"backend {self.backend!r} partitions the index over "
                    f"the '{INDEX_AXIS}' axis; pass a mesh with one")
            from repro_torch.distributed.sharding import local_partition
            self.arrays = local_partition(
                partition_index(index, mesh.shape[INDEX_AXIS]), mesh)
        else:
            self.arrays = index_arrays(index, self.device)

    # cfg fields known NOT to shape the index arrays — the only ones
    # with_cfg may change (an allowlist, so a new index-shaping field fails
    # closed instead of silently querying a stale resident table).
    _NON_INDEX_CFG_FIELDS = frozenset((
        "signal_len", "max_events", "tstat_window", "tstat_threshold",
        "peak_window", "min_dwell", "max_hits_per_seed",
        "use_freq_filter", "thresh_freq", "use_vote_filter",
        "thresh_voting", "voting_window_log2", "vote_bins",
        "max_anchors", "chain_band", "max_gap", "gap_cost", "skip_cost",
        "anchor_score", "min_chain_score", "map_ratio",
        "chain_compaction", "chain_capacity_frac", "chain_widths",
        "anchor_select",
    ))

    def with_cfg(self, cfg: MarsConfig) -> "Mapper":
        """A Mapper over the SAME device-resident index arrays (or the same
        tile cache) with a different config; only fields that do not shape
        the index may change."""
        changed = [f.name for f in dataclasses.fields(MarsConfig)
                   if (getattr(cfg, f.name) != getattr(self.cfg, f.name)
                       and f.name not in self._NON_INDEX_CFG_FIELDS)]
        if changed:
            raise ValueError(
                f"with_cfg changes fields {changed} not known to leave the "
                "index unchanged; build a new Mapper (the resident index "
                "arrays could be stale)")
        m = copy.copy(self)
        m.cfg = cfg
        m.plan = stages.resolve_plan(cfg, self.backend)
        return m

    def chunk_fn(self):
        """The (signals, n_valid) -> MapOutput program for driver.stream_map
        consumers that bring their own chunk source (e.g. the launcher's
        SignalReader)."""
        arrays, cache, cfg, plan, device, mesh = (
            self.arrays, self.cache, self.cfg, self.plan, self.device,
            self.mesh)

        def fn(sig, nv):
            # the tiered index: page in this chunk's tiles first (or take
            # the view a prefetch prepared)
            index = arrays if cache is None else cache.prepare(sig, cfg,
                                                               plan)
            if mesh is not None:
                return map_chunk_sharded(sig, index, cfg, mesh, n_valid=nv,
                                         plan=plan)
            x = torch.from_numpy(np.ascontiguousarray(sig, np.float32))
            if device.type == "cuda":
                # pinned + non_blocking: the upload does not wait for the
                # previous chunk's device work
                x = x.pin_memory().to(device, non_blocking=True)
            return map_chunk(x, index, cfg, n_valid=nv, plan=plan)
        return fn

    def map_signals(self, signals: np.ndarray, chunk: int = 64) -> MapOutput:
        prefetch = None
        if self.cache is not None:
            cache, cfg, plan = self.cache, self.cfg, self.plan
            # page the NEXT chunk's tiles while this chunk computes
            prefetch = lambda sig, nv: cache.prefetch(sig, cfg, plan)
        stream = driver.stream_map(self.chunk_fn(),
                                   driver.array_chunks(signals, chunk),
                                   prefetch=prefetch)
        return driver.collect(stream)

    def serve(self, **kw):
        """A continuous-batching ``ServeDriver`` over this mapper: many
        concurrent client streams packed into this pipeline's chunks
        (core/server.py).  Results are bit-identical to ``map_signals``
        on each stream's reads for any interleaving."""
        from repro_torch.core.server import ServeDriver
        return ServeDriver(self, **kw)


def score_accuracy(out: MapOutput, true_pos: np.ndarray,
                   true_strand: np.ndarray, mappable: np.ndarray,
                   n_bases: np.ndarray, n_ref_events: int,
                   tol: int = 100) -> Dict[str, float]:
    """Precision/recall/F1 against simulator ground truth (UNCALLED
    pafstats-style; paper Section 8.1).  ``out`` holds host arrays."""
    t = np.asarray(out.t_start).astype(np.int64)
    strand = (t >= n_ref_events).astype(np.int8)
    span = np.maximum(np.asarray(n_bases).astype(np.int64), 1)
    fwd = np.where(strand == 0, t,
                   n_ref_events - 1 - ((t - n_ref_events) + span - 1))
    mapped = np.asarray(out.mapped)
    correct = (np.abs(fwd - true_pos) <= tol) & (strand == true_strand)
    tp = int(np.sum(mapped & mappable & correct))
    fp = int(np.sum(mapped & ~(mappable & correct)))
    fn = int(np.sum(~mapped & mappable))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return dict(precision=prec, recall=rec, f1=f1, tp=tp, fp=fp, fn=fn)
