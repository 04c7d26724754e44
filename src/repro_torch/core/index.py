"""Reference index construction (paper Fig. 1, stage A — offline).

The reference genome's expected event sequence (forward ++ reverse strand,
"double genome") is quantized with global statistics, packed into seed keys
and stored in a direct-address bucket table:

    bucket_start : (2^h + 1,) int32   prefix offsets into the entry arrays
    entries_key  : (N,) uint32        full hash key per entry (collision check)
    entries_pos  : (N,) int32         seed position in double-genome coords
    entries_cnt  : (N,) int32         occurrences of this exact key in the
                                      reference (exact frequency-filter input)

Built offline with numpy; ``index_arrays`` uploads the online view to a
torch device.  The online view is the packed two-plane layout: every
in-bucket entry's low ``hash_bits`` key bits equal its bucket id, so the
entry table stores the count in that field instead and each entry is ONE
two-word row:

    entries_packed : (2, N) int32
        row 0   (key & ~bucket_mask) | cnt      key distinguisher + count
        row 1   t_pos                           seed position

``seeding.query_index`` serves a whole chunk with exactly two gathers (the
bucket boundaries and one entry-row lookup).  ``build_index`` guards the
packing: every count must fit the ``hash_bits`` spare bits.

Out of core, the packed planes split into power-of-two bucket-range tiles
that stay on the host (``TieredIndex``: ``tier_index`` of an ``Index``, or
``build_index_streaming`` straight from the event stream); only the tiles a
chunk's seeds touch are paged into device slots (core/tiered.py).  Each
tile carries the CRC32 of its planes (``tile_checksum``), checked at every
page-in.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import driver, hashing
from repro_torch.core.config import MarsConfig

# packed anchor sort key [t_pos : T_BITS | q_pos : _Q_BITS] in a
# non-negative int32 (core/chaining.py owns the packing; these are the
# bounds the builder guards)
_Q_BITS = 8
T_BITS = 31 - _Q_BITS          # 23


@dataclasses.dataclass
class Index:
    bucket_start: np.ndarray   # (2^h + 1,) int32
    entries_key: np.ndarray    # (N,) uint32
    entries_pos: np.ndarray    # (N,) int32
    entries_cnt: np.ndarray    # (N,) int32
    n_ref_events: int          # Le (single strand)
    n_entries: int
    cfg: MarsConfig

    @property
    def nbytes(self) -> int:
        return (self.bucket_start.nbytes + self.entries_key.nbytes +
                self.entries_pos.nbytes + self.entries_cnt.nbytes)

    @property
    def entries_packed(self) -> np.ndarray:
        """(2, N) int32 packed online entry rows, packed once on first
        access (build_index's overflow guard) and memoized."""
        packed = getattr(self, "_entries_packed", None)
        if packed is None:
            packed = pack_entries(self.entries_key, self.entries_pos,
                                  self.entries_cnt, self.cfg)
            self._entries_packed = packed
        return packed


def pack_entries(keys: np.ndarray, pos: np.ndarray, cnt: np.ndarray,
                 cfg: MarsConfig) -> np.ndarray:
    """Interleave (key, cnt, pos) into the (2, N) int32 online entry rows.
    A count that does not fit the bucket-implied low key bits would corrupt
    its neighbour's key distinguisher, so overflow fails loudly here."""
    mask = np.uint32(cfg.n_buckets - 1)
    if cnt.size and int(cnt.max()) >= cfg.n_buckets:
        raise ValueError(
            f"entry count {int(cnt.max())} does not fit the {cfg.hash_bits} "
            "bucket-implied spare bits of the packed entry plane "
            "(entries_packed); raise hash_bits or deduplicate the reference")
    keycnt = (keys.astype(np.uint32) & ~mask) | cnt.astype(np.uint32)
    return np.stack([keycnt.view(np.int32), pos.astype(np.int32)])


def quantize_stats(events: np.ndarray):
    """The global z-normalization statistics of ``quantize_reference_events``."""
    return float(events.mean()), float(events.std()) + 1e-6


def quantize_reference_events(events: np.ndarray, cfg: MarsConfig,
                              stats=None) -> np.ndarray:
    """Global z-normalization + uniform buckets over the reference events.
    ``stats`` overrides the (mean, std) pair."""
    mean, std = quantize_stats(events) if stats is None else stats
    z = (events - mean) / std
    clip = cfg.quant_clip_sigma
    step = (2.0 * clip) / cfg.quant_levels
    sym = np.floor((np.clip(z, -clip, clip - 1e-4) + clip) / step)
    return np.clip(sym.astype(np.int64), 0, cfg.quant_levels - 1)


def build_index(ref_events_concat: np.ndarray, n_ref_events: int,
                cfg: MarsConfig) -> Index:
    """ref_events_concat: (2*Le,) f32 — forward ++ reverse expected events."""
    # overflow guards for the packed anchor sort key [t : T_BITS | q : _Q_BITS]
    # (chaining.pack_anchor_keys): every t_pos (< 2*Le) must fit the t field
    # of a NON-NEGATIVE int32, and every q_pos the q field.
    if ref_events_concat.shape[0] >= (1 << T_BITS):
        raise ValueError(
            f"double genome must stay under 2^{T_BITS} events so "
            "(t_pos, q_pos) packs into a non-negative int32 sort key "
            "(chaining.pack_anchor_keys)")
    if cfg.max_events > (1 << (31 - T_BITS)):
        raise ValueError(
            f"max_events must fit the {31 - T_BITS}-bit q_pos "
            "field of the packed anchor sort key")
    sym = quantize_reference_events(ref_events_concat.astype(np.float64), cfg)
    keys = hashing.pack_seeds_np(sym, cfg)                 # (2Le - w + 1,)
    pos = np.arange(keys.shape[0], dtype=np.int64)
    # drop seeds spanning the forward/reverse junction
    Le, w = n_ref_events, cfg.seed_width
    keep = ~((pos > Le - w) & (pos < Le))
    # minimizer winnowing (same rule as the online side)
    keep &= hashing.minimizer_mask_np(keys, cfg.minimizer_radius)
    keys, pos = keys[keep], pos[keep]

    # exact per-key occurrence counts (frequency filter input)
    order_k = np.argsort(keys, kind="stable")
    ks = keys[order_k]
    _, counts = np.unique(ks, return_counts=True)
    cnt_sorted = np.repeat(counts, counts)
    cnt = np.empty_like(cnt_sorted)
    cnt[order_k] = cnt_sorted

    # bucket layout: sort by (bucket, key) so equal keys are contiguous
    mask = np.uint32(cfg.n_buckets - 1)
    bucket = (keys & mask).astype(np.int64)
    order = np.lexsort((keys, bucket))
    bucket_s, keys_s, pos_s, cnt_s = (bucket[order], keys[order], pos[order],
                                      cnt[order])
    bucket_start = np.zeros(cfg.n_buckets + 1, np.int64)
    np.add.at(bucket_start, bucket_s + 1, 1)
    bucket_start = np.cumsum(bucket_start)

    return index_from_numpy(
        bucket_start.astype(np.int32), keys_s.astype(np.uint32),
        pos_s.astype(np.int32),
        np.minimum(cnt_s, np.iinfo(np.int32).max).astype(np.int32),
        n_ref_events, cfg)


def index_from_numpy(bucket_start: np.ndarray, entries_key: np.ndarray,
                     entries_pos: np.ndarray, entries_cnt: np.ndarray,
                     n_ref_events: int, cfg: MarsConfig) -> Index:
    """An ``Index`` over existing planes (e.g. another builder's arrays), with
    the packed-plane overflow guard applied at once."""
    idx = Index(
        bucket_start=np.asarray(bucket_start, np.int32),
        entries_key=np.asarray(entries_key, np.uint32),
        entries_pos=np.asarray(entries_pos, np.int32),
        entries_cnt=np.asarray(entries_cnt, np.int32),
        n_ref_events=int(n_ref_events),
        n_entries=int(np.asarray(entries_key).shape[0]),
        cfg=cfg,
    )
    idx.entries_packed                 # packed-plane overflow guard
    return idx


def index_arrays(index: Index, device) -> Dict[str, torch.Tensor]:
    """The online index view on ``device``: ``bucket_start`` (2^h+1,) and
    ``entries_packed`` (2, N), both contiguous int32."""
    return dict(
        bucket_start=torch.from_numpy(
            np.ascontiguousarray(index.bucket_start)).to(device),
        entries_packed=torch.from_numpy(
            np.ascontiguousarray(index.entries_packed)).to(device),
    )


def index_arrays_unpacked(index: Index, device) -> Dict[str, torch.Tensor]:
    """The pre-fast-path four-plane view on ``device``, consumed by
    ``seeding.query_index_reference`` (parity oracle / microbenchmark):
    ``bucket_start``, ``entries_key`` (the uint32 keys' bits as int32, so
    the lookup kernel gathers them), ``entries_pos``, ``entries_cnt``."""
    planes = dict(bucket_start=index.bucket_start,
                  entries_key=index.entries_key.view(np.int32),
                  entries_pos=index.entries_pos,
                  entries_cnt=index.entries_cnt)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
            for k, v in planes.items()}


# --------------------------------------------------------------------------- #
# Bucket-range partitioning
# --------------------------------------------------------------------------- #
# The mesh axis holding index partitions: the ONE name the partitioned query
# backends' collectives and the partition layouts key on (core/distributed.py,
# distributed/sharding.py).
INDEX_AXIS = "model"

# The keys of a partitioned index (every leaf has a leading (n_parts,)
# partition axis, split over INDEX_AXIS by distributed/sharding.py).  The
# entry plane is the packed [keycnt | t_pos] layout of ``entries_packed``,
# per partition.
PARTITIONED_INDEX_KEYS = ("p_bucket_start", "p_entries_packed")


def partition_index(index: Index, n_parts: int):
    """Range-partition by bucket: partition p owns an equal bucket range
    [p*B/n, (p+1)*B/n).  Entries are padded to the max partition size so
    every partition has the same shapes.  Entry order inside a partition
    matches the global index (contiguous bucket ranges), and each partition
    carries the packed entry rows unchanged: ``p_entries_packed[p]`` is
    (2, emax) int32, the [keycnt; t_pos] row layout of ``entries_packed``.
    """
    nb = index.cfg.n_buckets
    if n_parts & (n_parts - 1):
        raise ValueError(f"n_parts must be a power of two (bucket owner is "
                         f"key >> log2(bucket_range)); got {n_parts}")
    assert nb % n_parts == 0, (nb, n_parts)
    bl = nb // n_parts
    starts = index.bucket_start
    sizes = [int(starts[(p + 1) * bl] - starts[p * bl])
             for p in range(n_parts)]
    emax = max(max(sizes), 1)
    packed_all = index.entries_packed
    packed = np.zeros((n_parts, 2, emax), np.int32)
    bstart = np.zeros((n_parts, bl + 1), np.int32)
    for p in range(n_parts):
        lo, hi = int(starts[p * bl]), int(starts[(p + 1) * bl])
        n = hi - lo
        packed[p, :, :n] = packed_all[:, lo:hi]
        bstart[p] = starts[p * bl:(p + 1) * bl + 1] - starts[p * bl]
    return dict(p_bucket_start=bstart, p_entries_packed=packed)


def repartition_index(index: Index, n_parts: int, failed: int, parts=None):
    """Online drive-failure rebalancing: fold the failed drive's bucket
    range onto the survivors by HALVING the partition count (N -> N/2; the
    owner rule stays ``bucket >> log2(range)``, so ``partition_index``'s
    power-of-two invariants survive a single-drive loss).

    Merged partition p owns the union of old partitions (2p, 2p+1): entries
    are the pairwise concatenation of the old planes (global bucket order
    kept) and local bucket offsets rebase, so the result equals a fresh
    ``partition_index(index, n_parts // 2)`` bit for bit.  ``parts`` may
    pass the live N-partition planes to merge from (the survivors re-serve
    their resident planes; the failed rank's range is re-read from the
    host copy, here the same plane).

    Returns ``(parts_half, remap)``: the N/2-partition planes and
    ``remap[p]``, the surviving old drive serving merged partition p (old
    drive 2p when it survived, else 2p+1, which already holds half the
    merged range).
    """
    if n_parts < 2 or (n_parts & (n_parts - 1)):
        raise ValueError(f"n_parts must be a power of two >= 2 to fold a "
                         f"failed drive onto survivors; got {n_parts}")
    if not 0 <= failed < n_parts:
        raise ValueError(f"failed drive must be in [0, {n_parts}); "
                         f"got {failed}")
    if parts is None:
        parts = partition_index(index, n_parts)
    bs = np.asarray(parts["p_bucket_start"])
    pk = np.asarray(parts["p_entries_packed"])
    half = n_parts // 2
    bl = bs.shape[1] - 1                      # buckets per OLD partition
    sizes = bs[:, -1].astype(np.int64)        # true entries per partition
    emax = max(int((sizes[0::2] + sizes[1::2]).max()), 1)
    packed = np.zeros((half, 2, emax), np.int32)
    bstart = np.zeros((half, 2 * bl + 1), np.int32)
    remap = []
    for p in range(half):
        a, b = 2 * p, 2 * p + 1
        na, nb = int(sizes[a]), int(sizes[b])
        packed[p, :, :na] = pk[a, :, :na]
        packed[p, :, na:na + nb] = pk[b, :, :nb]
        bstart[p, :bl + 1] = bs[a]
        bstart[p, bl:] = bs[b] + na
        remap.append(a if a != failed else b)
    return (dict(p_bucket_start=bstart, p_entries_packed=packed),
            tuple(remap))


# --------------------------------------------------------------------------- #
# Out-of-core tiered index (host-resident bucket-range tiles)
# --------------------------------------------------------------------------- #
def tile_checksum(bstart_row: np.ndarray, ent_tile: np.ndarray) -> int:
    """CRC32 of one tile's planes (the (bl+1,) local offsets chained with
    the padded (2, emax) packed rows), over the exact bytes that page into
    a device cache slot.  CRC32 detects every single-bit and burst-<=32-bit
    error, so every injected corruption (core/faults.py flips one bit) is
    caught."""
    c = zlib.crc32(np.ascontiguousarray(bstart_row, np.int32).tobytes())
    c = zlib.crc32(np.ascontiguousarray(ent_tile, np.int32).tobytes(), c)
    return c & 0xFFFFFFFF


@dataclasses.dataclass
class TieredIndex:
    """The packed planes split into power-of-two bucket-range *tiles* that
    stay on the host (numpy, optionally a memory-mapped entry plane).

    Tile t owns buckets [t*bl, (t+1)*bl) with bl = n_buckets / n_tiles;
    ``tile_bucket_start[t]`` holds the (bl+1,) tile-local prefix offsets and
    ``tile_entries_packed[t]`` the (2, emax) packed [keycnt; t_pos] rows,
    zero-padded to the largest tile so every tile pages into a fixed-size
    device slot (core/tiered.HotTileCache).  Entry order inside a tile
    matches the global index, so concatenating the unpadded tiles
    (``global_planes``) gives the ``Index`` planes byte for byte.
    """
    tile_bucket_start: np.ndarray    # (n_tiles, bl + 1) int32, tile-local
    tile_entries_packed: np.ndarray  # (n_tiles, 2, emax) int32 (may be memmap)
    tile_n_entries: np.ndarray       # (n_tiles,) int64 real entries per tile
    n_ref_events: int
    n_entries: int
    cfg: MarsConfig
    # (n_tiles,) uint32 per-tile CRC32 (``tile_checksum``) checked at every
    # page-in; the builders fill it, a hand-built instance computes it on
    # first use
    tile_checksums: Optional[np.ndarray] = None

    def checksum(self, t: int) -> int:
        """The expected CRC32 of tile ``t``'s planes (the checksum array is
        computed and kept on first use when the instance has none)."""
        if self.tile_checksums is None:
            self.tile_checksums = np.asarray(
                [tile_checksum(self.tile_bucket_start[i],
                               self.tile_entries_packed[i])
                 for i in range(self.n_tiles)], np.uint32)
        return int(self.tile_checksums[t])

    @property
    def n_tiles(self) -> int:
        return self.tile_bucket_start.shape[0]

    @property
    def buckets_per_tile(self) -> int:
        return self.tile_bucket_start.shape[1] - 1

    @property
    def emax(self) -> int:
        return self.tile_entries_packed.shape[-1]

    @property
    def tile_nbytes(self) -> int:
        """Bytes paged host->device per tile load (both planes)."""
        return 4 * (self.tile_bucket_start.shape[1] +
                    2 * self.tile_entries_packed.shape[-1])

    @property
    def nbytes(self) -> int:
        return (self.tile_bucket_start.nbytes +
                self.tile_entries_packed.nbytes + self.tile_n_entries.nbytes)

    def global_planes(self):
        """The resident-index planes reassembled: (bucket_start (2^h+1,)
        int32, entries_packed (2, N) int32), byte-identical to the
        in-memory ``Index`` build."""
        sizes = self.tile_n_entries.astype(np.int64)
        off = np.concatenate([[0], np.cumsum(sizes)])
        packed = np.zeros((2, int(off[-1])), np.int32)
        bs = np.zeros(self.cfg.n_buckets + 1, np.int64)
        bl = self.buckets_per_tile
        for t in range(self.n_tiles):
            n = int(sizes[t])
            packed[:, int(off[t]):int(off[t]) + n] = \
                self.tile_entries_packed[t, :, :n]
            bs[t * bl:(t + 1) * bl + 1] = \
                self.tile_bucket_start[t].astype(np.int64) + off[t]
        return bs.astype(np.int32), packed


def tier_index(index: Index, n_tiles: int) -> TieredIndex:
    """Split an in-memory ``Index`` into ``n_tiles`` host-resident
    bucket-range tiles (``partition_index``'s layout and power-of-two
    guard)."""
    parts = partition_index(index, n_tiles)
    starts = index.bucket_start
    bl = index.cfg.n_buckets // n_tiles
    sizes = np.asarray([int(starts[(t + 1) * bl] - starts[t * bl])
                        for t in range(n_tiles)], np.int64)
    return TieredIndex(
        tile_bucket_start=parts["p_bucket_start"],
        tile_entries_packed=parts["p_entries_packed"],
        tile_n_entries=sizes,
        n_ref_events=index.n_ref_events,
        n_entries=index.n_entries,
        cfg=index.cfg,
        tile_checksums=np.asarray(
            [tile_checksum(parts["p_bucket_start"][t],
                           parts["p_entries_packed"][t])
             for t in range(n_tiles)], np.uint32))


def build_index_streaming(ref_events_concat: np.ndarray, n_ref_events: int,
                          cfg: MarsConfig, n_tiles: int,
                          chunk_events: int = 1 << 16,
                          mmap_path=None) -> TieredIndex:
    """The streaming out-of-core twin of ``build_index``: bucket-range
    bucketing over ``driver.array_chunks`` blocks of the event stream
    instead of one in-memory sort.

    Each block (with a carried overlap of seed width + minimizer radius) is
    quantized with the global statistics of one pass over the stream,
    seeded and winnowed with the in-memory math (a key is emitted only once
    its minimizer window is fully buffered, so block boundaries are
    invisible), and the surviving entries go to their bucket-range tile.
    Each tile is then counted, sorted and packed on its own: equal keys
    share a bucket, so per-key counts and the stable (bucket, key) sort
    never cross a tile, and the planes equal ``tier_index(build_index(...))``
    byte for byte.  Peak memory is the event stream plus one tile's sort;
    with ``mmap_path`` the padded entry plane is a memory-mapped file.
    """
    if ref_events_concat.shape[0] >= (1 << T_BITS):
        raise ValueError(
            f"double genome must stay under 2^{T_BITS} events so "
            "(t_pos, q_pos) packs into a non-negative int32 sort key "
            "(chaining.pack_anchor_keys); shard larger references across "
            "the model axis instead.")
    if cfg.max_events > (1 << (31 - T_BITS)):
        raise ValueError(
            f"max_events must fit the {31 - T_BITS}-bit q_pos "
            "field of the packed anchor sort key")
    if n_tiles < 1 or (n_tiles & (n_tiles - 1)):
        raise ValueError(f"n_tiles must be a power of two (tile owner is "
                         f"bucket >> log2(bucket_range)); got {n_tiles}")
    nb = cfg.n_buckets
    assert nb % n_tiles == 0, (nb, n_tiles)
    bl = nb // n_tiles
    tile_log = int(np.log2(bl))

    ref = np.asarray(ref_events_concat, np.float32)
    n_ev = ref.shape[0]
    Le, w, r = n_ref_events, cfg.seed_width, cfg.minimizer_radius
    nk = n_ev - w + 1
    # pass 1: global quantization statistics (the in-memory build's f64
    # mean/std calls, so the blockwise quantization below is bit-identical)
    stats = quantize_stats(ref.astype(np.float64))
    kmask = np.uint32(nb - 1)

    spill_keys = [[] for _ in range(n_tiles)]
    spill_pos = [[] for _ in range(n_tiles)]

    def emit(lo, hi, buf, buf_start):
        """Emit keys [lo, hi): quantize + seed + winnow the buffered slice
        (extended by the minimizer radius so every emitted key sees its full
        window) and scatter the survivors to their tiles."""
        klo, khi = max(0, lo - r), min(nk, hi + r)
        ev = buf[klo - buf_start:khi + w - 1 - buf_start].astype(np.float64)
        sym = quantize_reference_events(ev, cfg, stats=stats)
        keys_ext = hashing.pack_seeds_np(sym, cfg)
        mmask = hashing.minimizer_mask_np(keys_ext, r)[lo - klo:hi - klo]
        keys_b = keys_ext[lo - klo:hi - klo]
        pos_b = np.arange(lo, hi, dtype=np.int64)
        keep = ~((pos_b > Le - w) & (pos_b < Le)) & mmask
        keys_b, pos_b = keys_b[keep], pos_b[keep]
        tile = ((keys_b & kmask).astype(np.int64) >> tile_log)
        for t in np.unique(tile):
            m = tile == t
            spill_keys[int(t)].append(keys_b[m])
            spill_pos[int(t)].append(pos_b[m])

    # pass 2: event blocks through the driver's chunk loop, carrying the
    # (w - 1 + r)-event overlap a key's seed and minimizer windows need
    # before it can be emitted
    emitted, buf_start = 0, 0
    buf = np.zeros(0, np.float32)
    for _ci, n_valid, block in driver.array_chunks(ref, chunk_events):
        buf = np.concatenate([buf, block[:n_valid]])
        have = buf_start + buf.shape[0]
        hi = nk if have >= n_ev else min(nk, have - (w - 1) - r)
        if hi > emitted:
            emit(emitted, hi, buf, buf_start)
            emitted = hi
            keep_from = max(0, emitted - r)
            buf = buf[keep_from - buf_start:]
            buf_start = keep_from

    # pass 3: per-tile count + stable (bucket, key) sort + pack.  Spills
    # arrive in global position order, so each tile's lexsort equals the
    # global lexsort restricted to its bucket range.
    sizes = np.asarray([sum(a.shape[0] for a in sk) for sk in spill_keys],
                       np.int64)
    emax = max(int(sizes.max()) if sizes.size else 0, 1)
    if mmap_path is not None:
        packed = np.lib.format.open_memmap(
            str(mmap_path), mode="w+", dtype=np.int32,
            shape=(n_tiles, 2, emax))
        packed[:] = 0
    else:
        packed = np.zeros((n_tiles, 2, emax), np.int32)
    bstart = np.zeros((n_tiles, bl + 1), np.int32)
    checksums = np.zeros(n_tiles, np.uint32)
    for t in range(n_tiles):
        keys_t = (np.concatenate(spill_keys[t]) if spill_keys[t]
                  else np.zeros(0, np.uint32))
        pos_t = (np.concatenate(spill_pos[t]) if spill_pos[t]
                 else np.zeros(0, np.int64))
        spill_keys[t] = spill_pos[t] = None      # free as we go
        if keys_t.size:
            order_k = np.argsort(keys_t, kind="stable")
            _, counts = np.unique(keys_t[order_k], return_counts=True)
            cnt_sorted = np.repeat(counts, counts)
            cnt_t = np.empty_like(cnt_sorted)
            cnt_t[order_k] = cnt_sorted
        else:
            cnt_t = np.zeros(0, np.int64)
        bucket_t = (keys_t & kmask).astype(np.int64)
        order = np.lexsort((keys_t, bucket_t))
        keys_s, pos_s, cnt_s, bucket_s = (keys_t[order], pos_t[order],
                                          cnt_t[order], bucket_t[order])
        counts_b = np.zeros(bl + 1, np.int64)
        np.add.at(counts_b, (bucket_s - t * bl) + 1, 1)
        bstart[t] = np.cumsum(counts_b).astype(np.int32)
        cnt_s = np.minimum(cnt_s, np.iinfo(np.int32).max).astype(np.int32)
        packed[t, :, :keys_s.size] = pack_entries(
            keys_s.astype(np.uint32), pos_s, cnt_s, cfg)
        # the planes equal tier_index's, so the CRCs agree too
        checksums[t] = tile_checksum(bstart[t], packed[t])
    if mmap_path is not None:
        packed.flush()
    return TieredIndex(
        tile_bucket_start=bstart, tile_entries_packed=packed,
        tile_n_entries=sizes, n_ref_events=n_ref_events,
        n_entries=int(sizes.sum()), cfg=cfg, tile_checksums=checksums)
