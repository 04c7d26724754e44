"""Seeding (paper Fig. 1, mapping step 2): hash-table query + frequency filter.

For each seed key we gather up to H entries from its bucket, mask
collisions (stored key != query key) and apply the exact frequency filter
(entries_cnt > thresh_freq -> drop, Section 5.1).

The online index stores the entries as (2, N) int32 ROWS
(``entries_packed``, core/index.py) — word 0 packs [key-distinguisher |
count], word 1 holds t_pos — so ``query_index`` issues exactly TWO gathers
per chunk: the bucket-boundary gather and ONE entry-row gather that
returns both words per probed entry.  Indices are clipped into the table,
as the reference's clipping gather does, so the words at out-of-bucket
slots are deterministic (they surface in the t_pos output).

Keys are uint32 values held in int64 tensors (core/hashing.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.config import MarsConfig
from repro_torch.core.hashing import MASK32


def _take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Clipping gather along the table's last axis: a 1-D (N,) table returns
    ``idx``-shaped values, the 2-D (2, N) packed-row table (2, *idx.shape)."""
    n = table.shape[-1]
    flat = torch.clamp(idx, 0, n - 1).reshape(-1).to(torch.int64)
    out = table.index_select(table.ndim - 1, flat)
    return out.reshape(table.shape[:-1] + idx.shape)


def unpack_entries(packed: torch.Tensor, keys: torch.Tensor,
                   cfg: MarsConfig):
    """Split gathered packed-entry words back into (got_key, key_cnt).

    packed: (..., H) int32 — the [key & ~bucket_mask | cnt] half of the
    entry plane; keys: (...,) int64 query keys.  The stored low bits equal
    the bucket id, i.e. the query key's own low bits, so their field holds
    the count; ``(packed & ~mask) | (query_key & mask)`` is the full stored
    key for in-bucket entries.
    """
    mask = cfg.n_buckets - 1
    pu = packed.to(torch.int64) & MASK32
    got_key = (pu & (MASK32 ^ mask)) | (keys.unsqueeze(-1) & mask)
    key_cnt = (pu & mask).to(torch.int32)
    return got_key, key_cnt


def match_entries(keys: torch.Tensor, valid: torch.Tensor,
                  got_key: torch.Tensor, key_cnt: torch.Tensor,
                  cnt_bucket: torch.Tensor, cfg: MarsConfig):
    """The post-gather query math.  keys/valid: (..., E); got_key/key_cnt:
    (..., E, H); cnt_bucket: (..., E).  Reductions are per read.

    Returns (hit_valid (..., E, H), probes, raw, exact per-read counters):
    post-frequency-filter hits, bucket probes (capped at H per seed), raw
    pre-filter hits, and the uncapped exact hit count (the matched key's
    reference occurrences, counted once per seed).
    """
    H = cfg.max_hits_per_seed
    red = (-2, -1)
    j = torch.arange(H, dtype=torch.int32, device=keys.device)
    in_bucket = j < cnt_bucket.unsqueeze(-1)
    key_match = got_key == keys.unsqueeze(-1)
    raw_hit = in_bucket & key_match & valid.unsqueeze(-1)

    if cfg.use_freq_filter:
        hit_valid = raw_hit & (key_cnt <= cfg.thresh_freq)
    else:
        hit_valid = raw_hit

    fm = key_match & in_bucket
    first_match = fm & (torch.cumsum(fm.to(torch.int32), dim=-1) == 1)
    probes = (torch.clamp(cnt_bucket, max=H) * valid).sum(-1)
    raw = raw_hit.sum(red)
    exact = torch.where(first_match & valid.unsqueeze(-1), key_cnt,
                        torch.zeros_like(key_cnt)).sum(red)
    i32 = torch.int32
    return hit_valid, probes.to(i32), raw.to(i32), exact.to(i32)


def _query_counters(valid, hit_valid, probes, raw, exact) -> Dict:
    i32 = torch.int32
    return dict(
        n_seeds=valid.sum(-1).to(i32),
        n_bucket_probes=probes,
        n_hits_raw=raw,
        n_hits_postfreq=hit_valid.sum((-2, -1)).to(i32),
        n_hits_exact=exact,
    )


def query_index(keys: torch.Tensor, valid: torch.Tensor,
                index: Dict[str, torch.Tensor], cfg: MarsConfig,
                gather=None) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """keys: (R, E) int64 uint32 values, valid: same-shape bool.

    Returns (t_pos (R, E, H) int32, hit_valid (R, E, H) bool, counters dict
    of (R,) int32 vectors).  ``gather(table, idx)`` is injectable; defaults
    to the clipping index_select.  The packed layout (``index_arrays``)
    takes the two-gather path; the unpacked four-plane view
    (``index_arrays_unpacked``) falls through to ``query_index_reference``.
    """
    if "entries_packed" not in index:
        return query_index_reference(keys, valid, index, cfg, gather=gather)
    if gather is None:
        gather = _take_clip
    H = cfg.max_hits_per_seed
    bucket = (keys & (cfg.n_buckets - 1)).to(torch.int32)

    # gather 1: both bucket boundaries (start of bucket b and of b+1)
    start_end = gather(index["bucket_start"],
                       torch.stack([bucket, bucket + 1]))    # (2, R, E)
    start, end = start_end[0], start_end[1]
    cnt_bucket = end - start

    j = torch.arange(H, dtype=torch.int32, device=keys.device)
    idx = start.unsqueeze(-1) + j                            # (R, E, H)
    n_entries = index["entries_packed"].shape[-1]
    idx_c = torch.clamp(idx, max=n_entries - 1)

    # gather 2: ONE packed-row lookup returns both entry words
    ent = gather(index["entries_packed"], idx_c)             # (2, R, E, H)
    got_key, key_cnt = unpack_entries(ent[0], keys, cfg)
    t_pos = ent[1]

    hit_valid, probes, raw, exact = match_entries(
        keys, valid, got_key, key_cnt, cnt_bucket, cfg)
    return t_pos, hit_valid, _query_counters(valid, hit_valid, probes, raw,
                                             exact)


def query_index_reference(keys: torch.Tensor, valid: torch.Tensor,
                          index: Dict[str, torch.Tensor], cfg: MarsConfig,
                          gather=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                Dict]:
    """Pre-fast-path query over the UNPACKED index view
    (``index.index_arrays_unpacked``): four separate table gathers.  Parity
    oracle + the "pre" side of the cheap-phase microbenchmark.  Same
    signature and batch semantics as ``query_index``; ``entries_key``
    holds the uint32 keys' bits as int32."""
    if gather is None:
        gather = _take_clip
    H = cfg.max_hits_per_seed
    bucket = (keys & (cfg.n_buckets - 1)).to(torch.int32)

    start_end = gather(index["bucket_start"],
                       torch.stack([bucket, bucket + 1]))    # (2, R, E)
    start, end = start_end[0], start_end[1]
    cnt_bucket = end - start

    j = torch.arange(H, dtype=torch.int32, device=keys.device)
    idx = start.unsqueeze(-1) + j                            # (R, E, H)
    n_entries = index["entries_key"].shape[0]
    idx_c = torch.clamp(idx, max=n_entries - 1)

    got_key = gather(index["entries_key"], idx_c).to(torch.int64) & MASK32
    t_pos = gather(index["entries_pos"], idx_c)
    key_cnt = gather(index["entries_cnt"], idx_c)

    hit_valid, probes, raw, exact = match_entries(
        keys, valid, got_key, key_cnt, cnt_bucket, cfg)
    return t_pos, hit_valid, _query_counters(valid, hit_valid, probes, raw,
                                             exact)
