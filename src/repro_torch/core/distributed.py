"""Distributed query backends: the partitioned-index mapper as ``query``
stage backends.

MARS distributes raw reads across flash channels and queries index
partitions in turn, overlapping partition loads with compute (paper
Section 6.3).  Over a mesh (``launch/mesh.py``, one process per rank):

  * reads shard over ALL mesh axes (every rank maps its own reads, the
    "channel stripe");
  * the reference index is range-partitioned by bucket over the 'model'
    axis (``core/index.partition_index``: partition p owns buckets
    [p*B/n, (p+1)*B/n)), one partition resident a rank;
  * ``query:ring`` rotates the chunk's seed keys, with the hits and counter
    partials gathered so far, around the 'model' axis: at step k a rank
    queries its resident partition with the keys that started k ranks
    upstream.  After n steps every seed has visited every partition and
    its hits are home.  One message a step carries the whole local chunk
    (the reference vmaps the stage per read; same result);
  * ``query:a2a`` rotates ONLY the keys; each rank keeps the hits for every
    source rank and ONE all-to-all a buffer returns them home, so the
    (E, H) hit plane crosses the wire once instead of n times.

There is NO separate per-read program here: the backends are registered
``query`` backends (a stage body without a primitive, over the
``"partitioned"`` index kind), so ``stages.resolve_plan(cfg,
"ring"|"a2a")`` plus ``pipeline.map_chunk_sharded`` run the same chunk program as the
single-device path, with every stage but ``query`` on the reference.  The
per-read counter partials ride home with the hits, so pad-row masking and
the chunk counter schema are those of the single-device path.
``map_chunk_sharded`` hands the backends the mesh with the rank's
partition (the ``"mesh"`` entry of the index it passes).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import seeding, stages
from repro_torch.core.config import MarsConfig
from repro_torch.core.index import (INDEX_AXIS,  # noqa: F401 (re-export)
                                    PARTITIONED_INDEX_KEYS, partition_index)


# --------------------------------------------------------------------------- #
# The query of one resident partition
# --------------------------------------------------------------------------- #
def _query_partition(keys: torch.Tensor, valid: torch.Tensor,
                     part: Dict[str, torch.Tensor], my_part: int,
                     n_parts: int, cfg: MarsConfig):
    """keys (R, E) int64 holding uint32 values, valid (R, E) bool; ``part``
    is THIS rank's partition (leading axis squeezed).

    Returns (t_pos (R, E, H), hit (R, E, H), probes, raw, exact) for the
    seeds whose bucket lives in this partition: ``hit`` is post-frequency-
    filter, and the three (R,) int32 vectors are this partition's share of
    each read's n_bucket_probes / n_hits_raw / n_hits_exact.  The math is
    ``seeding.match_entries`` with the seed mask restricted to owned seeds:
    each seed's bucket lives in exactly one partition, so the partials sum
    to the replicated table's counters exactly.
    """
    H = cfg.max_hits_per_seed
    bl_log = cfg.hash_bits - int(np.log2(n_parts))
    bucket = (keys & (cfg.n_buckets - 1)).to(torch.int32)
    owner = bucket >> bl_log
    local_b = bucket & ((1 << bl_log) - 1)
    mine = (owner == my_part) & valid

    # the two gathers of seeding.query_index, against the resident planes
    start_end = seeding._take_clip(part["p_bucket_start"],
                                   torch.stack([local_b, local_b + 1]))
    start, end = start_end[0], start_end[1]
    cnt_bucket = end - start
    j = torch.arange(H, dtype=torch.int32, device=keys.device)
    n_entries = part["p_entries_packed"].shape[-1]
    idx_c = torch.clamp(start.unsqueeze(-1) + j, max=n_entries - 1)
    ent = seeding._take_clip(part["p_entries_packed"], idx_c)  # (2, R, E, H)
    got_key, key_cnt = seeding.unpack_entries(ent[0], keys, cfg)

    hit, probes, raw, exact = seeding.match_entries(
        keys, mine, got_key, key_cnt, cnt_bucket, cfg)
    return ent[1], hit, probes, raw, exact


def _partition_view(index: Dict, cfg: MarsConfig):
    """The rank's resident partition (leading (1, ...) axis squeezed, or
    already squeezed), the partition count, and the mesh."""
    missing = [k for k in PARTITIONED_INDEX_KEYS if k not in index]
    if missing:
        raise ValueError(
            f"partitioned query backend needs index keys "
            f"{PARTITIONED_INDEX_KEYS} (core/index.partition_index); "
            f"missing {missing} — got {sorted(index)}")
    shape = tuple(index["p_bucket_start"].shape)
    if len(shape) == 2 and shape[0] == 1:
        part = {k: index[k][0] for k in PARTITIONED_INDEX_KEYS}
    elif len(shape) == 1:
        part = {k: index[k] for k in PARTITIONED_INDEX_KEYS}
    else:
        raise ValueError(
            "partitioned index must arrive as ONE resident partition per "
            f"rank (leading partition axis split over the mesh "
            f"'{INDEX_AXIS}' axis: distributed/sharding.local_partition); "
            f"got local p_bucket_start shape {shape}")
    mesh = index.get("mesh")
    if mesh is None:
        raise ValueError("partitioned query backend runs inside "
                         "pipeline.map_chunk_sharded, which hands it the "
                         "mesh; the index carries none")
    bl = part["p_bucket_start"].shape[0] - 1
    n_parts = cfg.n_buckets // bl
    if n_parts != mesh.shape[INDEX_AXIS]:
        raise ValueError(f"index of {n_parts} partitions on a mesh of "
                         f"{mesh.shape[INDEX_AXIS]} '{INDEX_AXIS}' ranks")
    return part, n_parts, mesh


# --------------------------------------------------------------------------- #
# The `query` stage backends
# --------------------------------------------------------------------------- #
def _query_ring(keys: torch.Tensor, valid: torch.Tensor, index: Dict,
                cfg: MarsConfig):
    """Ring schedule (paper Section 6.3 analogue): keys, the packed hits and
    the counter partials all rotate around the index axis; after n_parts
    steps everything is back on the reads' home rank."""
    part, n_parts, mesh = _partition_view(index, cfg)
    me = mesh.coords[INDEX_AXIS]
    R, E = keys.shape
    i32 = dict(dtype=torch.int32, device=keys.device)
    z = torch.zeros((R,), **i32)
    carry = [keys, valid, torch.zeros((R, E, cfg.max_hits_per_seed), **i32),
             z, z, z]
    for _ in range(n_parts):
        keys_r, valid_r, packed, probes, raw, exact = carry
        tp, hv, pr, rw, ex = _query_partition(keys_r, valid_r, part, me,
                                              n_parts, cfg)
        # hit -> t_pos+1, miss -> 0: ONE int32 plane on the wire; each
        # (e, h) slot is hit by at most one partition, so max combines
        # exactly
        packed = torch.maximum(packed, torch.where(hv, tp + 1, 0))
        carry = mesh.ring_shift([keys_r, valid_r, packed, probes + pr,
                                 raw + rw, exact + ex], INDEX_AXIS)
    # after n_parts rotations everything is back home
    return _finish_query(valid, *carry[2:])


def _query_a2a(keys: torch.Tensor, valid: torch.Tensor, index: Dict,
               cfg: MarsConfig):
    """All-to-all schedule: only (keys, valid) rotate; the hits and counter
    partials stay where they were found, by source rank, and ONE
    all-to-all a buffer returns them home."""
    part, n_parts, mesh = _partition_view(index, cfg)
    me = mesh.coords[INDEX_AXIS]
    R, E = keys.shape
    i32 = dict(dtype=torch.int32, device=keys.device)
    pbuf = torch.zeros((n_parts, R, E, cfg.max_hits_per_seed), **i32)
    sbuf = torch.zeros((n_parts, 3, R), **i32)
    keys_r, valid_r = keys, valid
    for k in range(n_parts):
        tp, hv, pr, rw, ex = _query_partition(keys_r, valid_r, part, me,
                                              n_parts, cfg)
        src = (me - k) % n_parts                 # the keys' home rank
        pbuf[src] = torch.where(hv, tp + 1, 0)
        sbuf[src] = torch.stack([pr, rw, ex])
        if k + 1 < n_parts:
            keys_r, valid_r = mesh.ring_shift([keys_r, valid_r], INDEX_AXIS)
    # send each source rank its hits and counter partials
    packed = mesh.all_to_all(pbuf, INDEX_AXIS).amax(0)
    scal = mesh.all_to_all(sbuf, INDEX_AXIS).sum(0, dtype=torch.int32)
    return _finish_query(valid, packed, scal[0], scal[1], scal[2])


def _finish_query(valid, packed, probes, raw, exact):
    """Unpack the combined hit plane and emit the query-stage counters of
    ``seeding.query_index`` (t_pos is 0 off the hits)."""
    hit_valid = packed > 0
    t_pos = torch.clamp(packed - 1, min=0)
    return t_pos, hit_valid, seeding._query_counters(valid, hit_valid,
                                                     probes, raw, exact)


def _stage(query):
    """The ``query`` stage body of a schedule (the state-dict protocol)."""
    def body(state, cfg: MarsConfig, index):
        t_pos, hit_valid, c = query(state["keys"], state["seed_valid"],
                                    index, cfg)
        return stages.with_query(state, cfg, t_pos, hit_valid, c)
    return body


stages.register_backend("query", "ring", _stage(_query_ring),
                        index_kind="partitioned")
stages.register_backend("query", "a2a", _stage(_query_a2a),
                        index_kind="partitioned")


# --------------------------------------------------------------------------- #
# Compatibility wrappers (the reference package's distributed-mapper API)
# --------------------------------------------------------------------------- #
def make_distributed_mapper(cfg: MarsConfig, mesh, schedule: str = "a2a"):
    """``fn(signals, parts) -> (t_start, score, mapped, counters)`` over the
    shared sharded chunk program (``pipeline.sharded_chunk_fn``) with the
    ``query:ring`` / ``query:a2a`` backend: ``signals`` the whole chunk
    (R, S), ``parts`` the rank's partition as ``input_shardings`` lays it
    out; counters carry the full ``stages.CHUNK_COUNTER_SCHEMA``."""
    from repro_torch.core.pipeline import sharded_chunk_fn
    inner = sharded_chunk_fn(cfg, mesh, stages.resolve_plan(cfg, schedule))

    def fn(signals, parts):
        t, s, m, _, counters = inner(signals, parts, signals.shape[0])
        return t, s, m, counters
    return fn


def input_shardings(mesh):
    """(signals layout, partitioned-index layouts) for the wrapper."""
    from repro_torch.distributed.sharding import mapping_chunk_shardings
    return mapping_chunk_shardings(mesh, partitioned_index=True)
