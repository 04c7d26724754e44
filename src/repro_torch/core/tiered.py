"""Out-of-core tiered query backend: host-resident bucket-range tiles paged
into a fixed-slot device cache keyed on per-chunk bucket traffic.

MARS keeps the reference index in flash and loads partitions on demand
(paper Section 6.3).  Here:

  * the index lives on the host as a ``core/index.TieredIndex`` (the packed
    planes split into power-of-two bucket-range tiles), held in pinned
    memory when the cache is on a card;
  * ``HotTileCache`` owns a fixed number of device tile *slots*: two
    persistent int32 tensors, (n_slots + replicas, bl + 1) and
    (2, n_slots + replicas, emax).  Before a chunk runs, a pre-pass (the
    plan's own detect, quantize and seed) counts the chunk's valid seeds
    per tile; exactly the touched tiles are paged in, evicting by LRU over
    per-slot touch counts (``policy="random"`` lets tests show that results
    do not depend on eviction order).  A chunk touching more tiles than
    slots gets a transient wide view of every needed tile, padded to a
    power-of-two slot count; correctness never depends on cache size, only
    traffic does;
  * ``query:tiered`` is a registered ``query`` backend
    (``index_kind="tiered"``), so ``stages.resolve_plan(cfg, "tiered")`` and
    ``map_chunk`` / ``ServeDriver`` take it up unchanged.  It routes every
    bucket through its tile's slot with the two gathers of
    ``seeding.query_index`` and the shared ``seeding.match_entries`` math,
    so results equal the resident table's bit for bit for every cache size
    and eviction order (a seed whose tile is not resident is masked
    invalid; hit positions of non-hits are 0).

Page-ins write the persistent slots in place, on the current CUDA stream:
a chunk's query, enqueued before the next chunk's page-in, reads its slots
before they are overwritten.  Each view carries its own ``t_tile_slot``
(and, overflowing, its own planes), so a later page-in never reroutes an
earlier chunk.  A page-in copies from the pinned host tile itself, which
nothing writes, so an asynchronous copy cannot see a refilled buffer; a
copy made by the fault injector is pageable and uploads synchronously.

Cache telemetry (hits / misses / paged bytes / retries / corruptions)
rides ``stages.DEBUG_COUNTER_SCHEMA``, which the chunk program drops before
summing; the totals live on the cache object.

Fault tolerance: every page-in is checked against the tile's build-time
CRC32 (``core/index.tile_checksum``).  A failed or corrupted read is
retried with exponential backoff (virtual time, ``vtime_penalty``) up to
``max_retries`` times; an exhausted budget raises
``faults.TileReadError``: a corrupted tile never serves hits.  The seeded
injection harness (``core/faults.py``) hooks exactly this boundary.

The JAX package's ``repro.core.tiered``, ported: the same host-side
decisions in the same order (victims, random draws, replica refresh,
telemetry), so every number equals the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import seeding, stages
from repro_torch.core import faults as faults_mod
from repro_torch.core.config import MarsConfig
from repro_torch.core.index import TieredIndex, tile_checksum
from repro_torch.core.pipeline import check_device

# The keys of a device tile-cache view (what ``query_tiered`` consumes).
# For a view of n_view slots over n_tiles tiles (bl = buckets per tile,
# emax = padded entries per tile):
#
#   t_bucket_start   (n_view, bl + 1) int32   per-slot local prefix offsets
#   t_entries_packed (2, n_view, emax) int32  per-slot packed entry rows
#   t_tile_slot      (n_tiles,) int32         tile -> slot, -1 non-resident
#   t_cache_stats    (5,) int32               this chunk's (hits, misses,
#                                             paged bytes, page-in retries,
#                                             checksum mismatches)
TIERED_INDEX_KEYS = ("t_bucket_start", "t_entries_packed", "t_tile_slot",
                     "t_cache_stats")

# Optional view planes carrying the pre-pass's detect -> quantize -> seed
# outputs to the main pass (``reuse_prepass=True``, the default), which
# then skips recomputing them:
#
#   t_pre_keys  (R, E) int64 (uint32 values)   t_pre_valid (R, E) bool
#   t_pre_nev   (R,)   int32 per-read event counts
PREPASS_KEYS = ("t_pre_keys", "t_pre_valid", "t_pre_nev")

# The view's t_cache_stats, in order, as the debug counters they become.
_STATS_COUNTERS = ("n_tile_hits", "n_tile_misses", "n_tile_paged_bytes",
                   "n_tile_retries", "n_tile_corruptions")


# --------------------------------------------------------------------------- #
# The `query:tiered` stage backend
# --------------------------------------------------------------------------- #
def _cache_view(index: Dict[str, torch.Tensor]):
    missing = [k for k in TIERED_INDEX_KEYS if k not in index]
    if missing:
        raise ValueError(
            f"tiered query backend needs a HotTileCache view with keys "
            f"{TIERED_INDEX_KEYS} (core/tiered.HotTileCache.prepare); "
            f"missing {missing} — got {sorted(index)}")
    return index


def query_tiered(keys: torch.Tensor, valid: torch.Tensor,
                 index: Dict[str, torch.Tensor], cfg: MarsConfig):
    """Query seed keys (R, E) (int64 holding uint32 values; ``valid`` the
    same shape, bool) against the device tile-cache view.

    Every valid seed's tile must be resident (``HotTileCache.prepare``
    makes it so); a seed whose tile is not resident is treated as invalid,
    so a stale slot never contributes a hit or a counter.  Returns
    (t_pos, hit_valid, counters) with ``seeding.query_index``'s semantics;
    t_pos is 0 for non-hits.
    """
    view = _cache_view(index)
    H = cfg.max_hits_per_seed
    bstart = view["t_bucket_start"]          # (n_view, bl + 1)
    ent = view["t_entries_packed"]           # (2, n_view, emax)
    tile_slot = view["t_tile_slot"]          # (n_tiles,)
    blp1 = bstart.shape[1]
    emax = ent.shape[-1]
    n_tiles = tile_slot.shape[0]
    tile_log = int(np.log2(cfg.n_buckets // n_tiles))

    bucket = (keys & (cfg.n_buckets - 1)).to(torch.int32)
    tile = bucket >> tile_log
    local_b = bucket & ((1 << tile_log) - 1)
    slot = seeding._take_clip(tile_slot, tile)                # (R, E)
    valid = valid & (slot >= 0)

    # the two gathers of seeding.query_index, through the slot planes
    # flattened so one gather serves every slot; a non-resident (slot -1)
    # index clips to 0, and the residency-anded `valid` masks it
    flat_b = slot * blp1 + local_b
    start_end = seeding._take_clip(bstart.reshape(-1),
                                   torch.stack([flat_b, flat_b + 1]))
    start, end = start_end[0], start_end[1]
    cnt_bucket = end - start

    j = torch.arange(H, dtype=torch.int32, device=keys.device)
    eidx = torch.clamp(start.unsqueeze(-1) + j, max=emax - 1)  # (R, E, H)
    flat_e = slot.unsqueeze(-1) * emax + eidx
    ent2 = seeding._take_clip(ent.reshape(2, -1), flat_e)
    got_key, key_cnt = seeding.unpack_entries(ent2[0], keys, cfg)

    hit_valid, probes, raw, exact = seeding.match_entries(
        keys, valid, got_key, key_cnt, cnt_bucket, cfg)
    t_pos = torch.where(hit_valid, ent2[1], torch.zeros_like(ent2[1]))
    counters = seeding._query_counters(valid, hit_valid, probes, raw, exact)
    return t_pos, hit_valid, counters


def _query_tiered_stage(state, cfg: MarsConfig, index):
    """The ``query:tiered`` stage body: ``query_tiered`` plus the chunk's
    cache telemetry as per-read DEBUG counters (dropped by the chunk
    program before summing)."""
    keys = state["keys"]
    t_pos, hit_valid, c = query_tiered(keys, state["seed_valid"], index, cfg)
    s = index["t_cache_stats"]
    rows = keys.shape[:-1]
    c.update({name: s[i].expand(rows)
              for i, name in enumerate(_STATS_COUNTERS)})
    return stages.with_query(state, cfg, t_pos, hit_valid, c)


stages.register_backend("query", "tiered", _query_tiered_stage,
                        index_kind="tiered")


# --------------------------------------------------------------------------- #
# Per-chunk tile-traffic pre-pass
# --------------------------------------------------------------------------- #
def prepass(signals: torch.Tensor, cfg: MarsConfig, plan: stages.Plan,
            n_tiles: int):
    """The traffic probe: the plan's own detect, quantize and seed stages
    over a chunk (``stages.execute_stages``), and a count of valid seeds
    per tile.  Its keys equal the chunk program's, so the tiles it pages in
    cover every seed the query will issue (pad rows included).  Returns
    (hist (n_tiles,) int64 on the host, keys, seed_valid, n_events int32)
    with the last three on the device."""
    tile_log = int(np.log2(cfg.n_buckets // n_tiles))
    st = stages.execute_stages({"signal": signals, "counters": {}}, {}, cfg,
                               plan, ("detect", "quantize", "seed"))
    keys, valid, n_ev = st["keys"], st["seed_valid"], st["n_events"]
    tile = (keys & (cfg.n_buckets - 1)) >> tile_log
    # invalid seeds count in an extra bin, dropped
    hist = torch.bincount(torch.where(valid, tile, n_tiles).reshape(-1),
                          minlength=n_tiles + 1)[:n_tiles]
    return hist.cpu().numpy(), keys, valid, n_ev.to(torch.int32)


# --------------------------------------------------------------------------- #
# The traffic-keyed device cache
# --------------------------------------------------------------------------- #
class HotTileCache:
    """Fixed device tile slots over a host-resident ``TieredIndex``.

    ``prepare(signals, cfg, plan)`` runs the traffic pre-pass, pages the
    chunk's touched tiles into slots (evicting per ``policy``) and returns
    the device view dict for ``map_chunk``.  ``prefetch`` prepares the view
    of a later chunk now (``driver.stream_map`` calls it on chunk i+1 while
    chunk i computes) and memoizes it by signal-array identity; the
    matching ``prepare`` call pops it.

    policy: "lru" (least-recent chunk serial, then touch count; empty
    slots first) or "random" (seeded).  A chunk needing more tiles than
    slots gets a transient wide view of every needed tile (power-of-two
    slot count); the persistent slots are untouched and misses are charged
    for the tiles that were not resident.

    replicas: K extra slots pinned to the K hottest tiles by the cumulative
    traffic histogram (``tile_traffic()``).  They are loaded through the
    same CRC-checked path, hold byte-identical planes, win the tile->slot
    routing and are never eviction victims, so results equal
    ``replicas=0``'s.  Replica paging is counted apart (``replica_loads``
    / ``replica_bytes``).

    Telemetry (cumulative host ints): ``hits`` / ``misses`` (tile touches
    found / not found resident), ``paged_bytes`` (host->device bytes for
    missed tiles), ``retries`` (page-in re-reads), ``corruptions``
    (checksum mismatches caught), ``n_chunks``; ``hit_rate`` derives.

    Every page-in is checked against the build-time per-tile CRC32 and
    retried with exponential backoff (``backoff_base * 2**k`` virtual time
    units, summed in ``vtime_penalty``) up to ``max_retries`` times; then
    ``faults.TileReadError`` is raised.  ``faults`` attaches a seeded
    ``core/faults.FaultPlan`` at this boundary; a plan that injects nothing
    (``FaultPlan.enabled`` false) is dropped.

    ``device`` holds the slots (and runs the pre-pass): CUDA unless the
    caller asks for the CPU.  On a card the host tiles are copied once into
    pinned memory, and each page-in is an asynchronous copy from there.

    The slots are per rank: under a mesh (``launch/mesh.py``) each rank's
    ``Mapper`` builds its own cache on the rank's device, runs the pre-pass
    over the whole chunk, and so takes the same paging decisions and
    telemetry as the single-device cache; ``pipeline.map_chunk_sharded``
    cuts the view's per-read pre-pass planes to the rank's reads, like the
    signals.
    """

    def __init__(self, tiered: TieredIndex, n_slots: int, device="cuda",
                 policy: str = "lru", seed: int = 0,
                 faults: Optional[faults_mod.FaultPlan] = None,
                 max_retries: int = 3, backoff_base: float = 1.0,
                 reuse_prepass: bool = True, replicas: int = 0):
        if n_slots < 1:
            raise ValueError(f"need at least one cache slot; got {n_slots}")
        if policy not in ("lru", "random"):
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             "use 'lru' or 'random'")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0; got {max_retries}")
        if backoff_base < 0:
            raise ValueError(f"backoff_base must be >= 0; "
                             f"got {backoff_base}")
        if replicas < 0:
            raise ValueError(f"replicas must be >= 0 extra hot-tile slots; "
                             f"got {replicas}")
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self._inj = (faults_mod.FaultInjector(faults)
                     if faults is not None and faults.enabled else None)
        self._prefetch_serial = 0
        self.tiered = tiered
        self.device = check_device(device)
        self.n_slots = min(int(n_slots), tiered.n_tiles)
        self.reuse_prepass = bool(reuse_prepass)
        self.policy = policy
        self._rng = np.random.default_rng(seed)
        # Replica slots sit AFTER the n_slots primary slots.
        self.n_replicas = min(int(replicas), tiered.n_tiles)
        self.n_total = self.n_slots + self.n_replicas
        blp1 = tiered.buckets_per_tile + 1
        self._slot_tile = np.full(self.n_total, -1, np.int64)
        self._slot_last = np.zeros(self.n_total, np.int64)   # chunk serial
        self._slot_touch = np.zeros(self.n_total, np.int64)  # seed traffic
        self._tile_traffic = np.zeros(tiered.n_tiles, np.int64)
        self._serial = 0
        # the host tiles, read-only from here on: pinned on a card so a
        # page-in is one asynchronous copy from the tile itself
        self._host_bstart = torch.from_numpy(np.ascontiguousarray(
            tiered.tile_bucket_start, np.int32))
        self._host_ent = torch.from_numpy(np.ascontiguousarray(
            tiered.tile_entries_packed, np.int32))
        if self.device.type == "cuda":
            self._host_bstart = self._host_bstart.pin_memory()
            self._host_ent = self._host_ent.pin_memory()
        i32 = dict(dtype=torch.int32, device=self.device)
        self._dev_bstart = torch.zeros((self.n_total, blp1), **i32)
        self._dev_ent = torch.zeros((2, self.n_total, tiered.emax), **i32)
        self._ready: Dict[int, Dict] = {}    # id(signals) -> prepared view
        self._keep: Dict[int, object] = {}   # keeps ids unique until popped
        self.reset_stats()

    # -------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0
        self.paged_bytes = 0
        self.n_chunks = 0
        self.retries = 0          # page-in re-reads (failures + mismatches)
        self.corruptions = 0      # checksum mismatches caught at page-in
        self.vtime_penalty = 0.0  # virtual time lost to spikes + backoff
        self.replica_loads = 0    # hot-tile copies paged into replica slots
        self.replica_bytes = 0    # host->device bytes those copies cost
        self._chunk_retries = 0
        self._chunk_corruptions = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    @property
    def cache_nbytes(self) -> int:
        return self.n_total * self.tiered.tile_nbytes

    def tile_traffic(self) -> np.ndarray:
        """Cumulative per-tile seed-traffic histogram (a copy): the
        replication policy's input, and the skew statistic of the cost
        model's ``skewed_serving`` term."""
        return self._tile_traffic.copy()

    # ---------------------------------------------------------- prefetch
    def prefetch(self, signals, cfg: MarsConfig, plan: stages.Plan) -> None:
        """Page the tiles a later chunk needs now; the view is handed back
        by the ``prepare`` call for the same signals object."""
        key = id(signals)
        if key in self._ready:
            return
        serial = self._prefetch_serial
        self._prefetch_serial += 1
        if self._inj is not None:
            self._inj.check_prefetch(serial)
        # build the view BEFORE memoizing: a failed page-in must leave no
        # `_keep` pin and no half-built `_ready` entry
        view = self._prepare(signals, cfg, plan)
        self._keep[key] = signals
        self._ready[key] = view

    def prepare(self, signals, cfg: MarsConfig,
                plan: stages.Plan) -> Dict[str, torch.Tensor]:
        """The device view for this chunk (``signals`` (R, S) f32 numpy):
        every tile its valid seeds touch is resident.  Pops a prefetched
        view when one exists."""
        key = id(signals)
        view = self._ready.pop(key, None)
        self._keep.pop(key, None)
        if view is not None:
            return view
        return self._prepare(signals, cfg, plan)

    # ---------------------------------------------------------- internals
    def _read_tile(self, t: int, attempt: int):
        """One raw page-in attempt: the tile's planes (numpy views of the
        host tiles), through the fault injector when one is attached (it
        corrupts a copy, never the host tile).  Raises
        ``TransientTileError`` on an injected read failure; latency spikes
        land in ``vtime_penalty``."""
        bstart = self._host_bstart[t].numpy()
        ent = self._host_ent[t].numpy()
        if self._inj is not None:
            bstart, ent, lat = self._inj.tile_read(t, attempt, bstart, ent)
            if lat:
                self.vtime_penalty += lat
        return bstart, ent

    def _fetch_tile(self, t: int):
        """Page in one tile, checked: read -> CRC32 -> (bstart, ent), or a
        bounded retry with exponential backoff (virtual time).  Every read
        failure and checksum mismatch is counted; an exhausted budget
        raises ``TileReadError``."""
        t = int(t)
        expect = self.tiered.checksum(t)
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.retries += 1
                self._chunk_retries += 1
                self.vtime_penalty += self.backoff_base * 2.0 ** (attempt - 1)
            try:
                bstart, ent = self._read_tile(t, attempt)
            except faults_mod.TransientTileError as e:
                last = e
                continue
            if tile_checksum(bstart, ent) == expect:
                return bstart, ent
            self.corruptions += 1
            self._chunk_corruptions += 1
            last = faults_mod.TileReadError(
                f"checksum mismatch paging tile {t} "
                f"(attempt {attempt}, expected {expect:#010x})")
        raise faults_mod.TileReadError(
            f"tile {t} page-in failed after {self.max_retries + 1} "
            f"attempts: {last}") from last

    def _upload(self, dst_b, dst_e, t: int, bstart, ent) -> None:
        """Copy tile ``t``'s checked planes into device slot tensors
        (``dst_b`` (bl + 1,), ``dst_e`` (2, emax)), on the current stream.
        Planes that are the host tile itself (pinned on a card, never
        written) copy asynchronously from it; a copy the fault injector
        made (pageable) uploads synchronously."""
        for dst, src, host in ((dst_b, bstart, self._host_bstart[t]),
                               (dst_e[0], ent[0], self._host_ent[t, 0]),
                               (dst_e[1], ent[1], self._host_ent[t, 1])):
            if np.may_share_memory(src, host.numpy()):
                dst.copy_(host, non_blocking=True)
            else:
                dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))

    def _write_slot(self, s: int, t: int, bstart, ent) -> None:
        self._upload(self._dev_bstart[s], self._dev_ent[:, s], t, bstart,
                     ent)

    def _refresh_replicas(self) -> None:
        """Keep the replica slots holding the current top-K hottest tiles
        (highest cumulative traffic, ties to the lower tile id), loaded
        through the CRC-checked ``_fetch_tile``."""
        if not self.n_replicas:
            return
        traffic = self._tile_traffic
        hot = np.nonzero(traffic > 0)[0]
        hot = hot[np.lexsort((hot, -traffic[hot]))][:self.n_replicas]
        for j, t in enumerate(hot):
            s = self.n_slots + j
            if self._slot_tile[s] == int(t):
                continue
            bstart, ent = self._fetch_tile(int(t))
            self._write_slot(s, int(t), bstart, ent)
            self._slot_tile[s] = int(t)
            self._slot_touch[s] = 0
            self.replica_loads += 1
            self.replica_bytes += self.tiered.tile_nbytes

    def _prepare(self, signals, cfg, plan):
        ti = self.tiered
        x = torch.from_numpy(np.ascontiguousarray(signals, np.float32))
        hist, keys, valid, n_ev = prepass(x.to(self.device), cfg, plan,
                                          ti.n_tiles)
        needed = np.nonzero(hist > 0)[0]
        self._serial += 1
        self.n_chunks += 1
        self._chunk_retries = 0
        self._chunk_corruptions = 0
        self._tile_traffic += hist
        self._refresh_replicas()
        if needed.size <= self.n_slots:
            view = self._ensure_resident(needed, hist)
        else:
            view = self._overflow_view(needed, hist)
        if self.reuse_prepass:
            # the probe's outputs are what the cheap phase would recompute
            # (the same stages of the same plan on the same signals)
            view = dict(view, t_pre_keys=keys, t_pre_valid=valid,
                        t_pre_nev=n_ev)
        return view

    def _victim(self, needed: set) -> int:
        """A PRIMARY slot whose tile is not needed this chunk: empty slots
        first, then least-recently-used / least-trafficked (or random).
        Replica slots are never victims."""
        cands = [s for s in range(self.n_slots)
                 if self._slot_tile[s] not in needed]
        empties = [s for s in cands if self._slot_tile[s] < 0]
        if empties:
            return empties[0]
        if self.policy == "random":
            return int(self._rng.choice(cands))
        return min(cands, key=lambda s: (self._slot_last[s],
                                         self._slot_touch[s], s))

    def _load_slot(self, s: int, t: int) -> None:
        # fetch (check + retry) BEFORE touching device state: a failed
        # page-in raises here and leaves every persistent slot unchanged
        bstart, ent = self._fetch_tile(t)
        self._write_slot(s, t, bstart, ent)
        self._slot_tile[s] = t
        self._slot_touch[s] = 0

    def _view(self, bstart, ent, tile_slot, chunk_hits, chunk_misses):
        paged = chunk_misses * self.tiered.tile_nbytes
        self.hits += chunk_hits
        self.misses += chunk_misses
        self.paged_bytes += paged
        stats = np.asarray([chunk_hits, chunk_misses,
                            min(paged, np.iinfo(np.int32).max),
                            self._chunk_retries,
                            self._chunk_corruptions], np.int32)
        return dict(t_bucket_start=bstart, t_entries_packed=ent,
                    t_tile_slot=self._to_device(tile_slot),
                    t_cache_stats=self._to_device(stats))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A small host array on the cache's device; on a card through a
        pinned buffer, so the copy does not wait for queued device work
        (the caching host allocator keeps the buffer until it is done)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _ensure_resident(self, needed, hist):
        nset = set(int(t) for t in needed)
        resident = {int(t): s for s, t in enumerate(self._slot_tile)
                    if t >= 0}
        missing = [t for t in nset if t not in resident]
        for t in sorted(missing):
            self._load_slot(self._victim(nset), t)
        slot_of = {int(t): s for s, t in enumerate(self._slot_tile)}
        for t in nset:
            s = slot_of[t]
            self._slot_last[s] = self._serial
            self._slot_touch[s] += int(hist[t])
        tile_slot = np.full(self.tiered.n_tiles, -1, np.int32)
        for s, t in enumerate(self._slot_tile):
            if t >= 0:
                tile_slot[int(t)] = s
        return self._view(self._dev_bstart, self._dev_ent, tile_slot,
                          len(nset) - len(missing), len(missing))

    def _overflow_view(self, needed, hist):
        """More tiles touched than slots: a transient view holding every
        needed tile in planes of its own (padded to a power-of-two slot
        count).  Persistent slots are left as they are; misses are charged
        for the tiles that were not resident."""
        ti = self.tiered
        n_need = int(needed.size)
        n_view = 1 << (n_need - 1).bit_length()
        blp1 = ti.buckets_per_tile + 1
        i32 = dict(dtype=torch.int32, device=self.device)
        bstart = torch.zeros((n_view, blp1), **i32)
        ent = torch.zeros((2, n_view, ti.emax), **i32)
        tile_slot = np.full(ti.n_tiles, -1, np.int32)
        for i, t in enumerate(needed):
            b, e = self._fetch_tile(t)
            self._upload(bstart[i], ent[:, i], int(t), b, e)
            tile_slot[int(t)] = i
        resident = {int(t) for t in self._slot_tile if t >= 0}
        hits = sum(1 for t in needed if int(t) in resident)
        nset = set(int(x) for x in needed)
        for s, t in enumerate(self._slot_tile):
            if int(t) in nset:
                self._slot_last[s] = self._serial
                self._slot_touch[s] += int(hist[int(t)])
        return self._view(bstart, ent, tile_slot, hits, n_need - hits)
