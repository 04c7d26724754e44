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
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import hashing
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
