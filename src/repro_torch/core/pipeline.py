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

Everything runs eagerly on the device of the input tensors.  Where the
reference package branches on device values inside one compiled program
(``lax.cond``), this pipeline branches on the host: the compaction gate and
the width ladder read the chunk's surviving-read count and largest anchor
count in ONE device->host sync per chunk (``_chain_outputs``).  With the
final copy of the per-read outputs (core/driver.py) a chunk costs two
synchronisations.

Pad rows (chunks shorter than the static chunk size) are masked out of
every counter and of ``mapped`` via ``n_valid``.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import cheap, chaining, driver, stages
from repro_torch.core.config import MarsConfig
from repro_torch.core.index import Index, index_arrays


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


# --------------------------------------------------------------------------- #
# Cheap phase (detect .. vote)
# --------------------------------------------------------------------------- #
def cheap_phase(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                cfg: MarsConfig, plan: stages.Plan, use_fused: bool = True):
    """The cheap phase (detect..vote) over a chunk.

    Dispatch ladder, most-fused first: (1) the whole-phase kernel
    (``stages.register_fused_cheap``) when the plan resolved one — detect..
    vote in ONE launch; (2) the per-stage batch program
    (``cheap.cheap_phase_stages``) with the plan's ``detector`` and
    ``gather``: detect runs once per chunk and the query issues two
    whole-chunk gathers (the ``event_detect`` and ``pluto_lookup`` kernels
    where the plan resolved them; the reference math for a stage that
    resolved to the reference, as in the reference package).
    ``use_fused=False`` pins level (2).  Returns (q_pos, t_pos, hit_valid,
    counters); ``counters["n_anchors_postvote"]`` is the per-read
    post-filter anchor count the compaction gate keys on.
    """
    prims = stages.cheap_primitives(plan, cfg)
    if use_fused and prims.fused is not None:
        return prims.fused(signals, index)
    return cheap.cheap_phase_stages(signals, index, cfg,
                                    detector=prims.detector,
                                    gather=prims.gather)


# --------------------------------------------------------------------------- #
# Chain phase
# --------------------------------------------------------------------------- #
# How many chunks took each route through the chaining phase, keyed by
# (branch, rows chained, sort width): branch "full" chains every read of the
# chunk, "compact" only the reads with anchors left, "empty" none (rows and
# width 0); the width is a ladder width, or the full E*H when no ladder
# width bounds the largest anchor count.  Host-side, one entry per chunk.
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
    """The chunk body: cheap phase over every read, the chaining phase over
    the reads with anchors left (``_chain_outputs``; with
    ``chain_compaction`` off, the whole chunk at full width), pad rows
    masked out of the counters, and the per-read counters summed to
    CHUNK_COUNTER_SCHEMA.  The chain-stage counters are exact in closed
    form: n_sorted = min(cnt, A), n_dp_pairs = n_sorted * B."""
    rv = row_valid
    prims = stages.chain_primitives(plan, cfg)
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
    if cfg.chain_compaction:
        t_start, score, mapped = _chain_outputs(
            q_pos, t_pos, hit_valid, cnt, cfg, prims)
    else:
        # no gate, no ladder: every read at full width
        t_start, score, mapped = chain_phase(
            q_pos, t_pos, hit_valid, cnt, cfg, prims, maxcnt=math.inf)
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
    R = signals.shape[0]
    row_valid = torch.arange(R, device=signals.device) < (
        R if n_valid is None else int(n_valid))
    return _chunk_program(signals, index, cfg, plan, row_valid)


# --------------------------------------------------------------------------- #
# Host-side mapper + accuracy scoring
# --------------------------------------------------------------------------- #
class Mapper:
    """Host wrapper: owns the index arrays on ``device``, resolves the
    backend plan once, and streams chunks through the driver.

    ``device`` defaults to CUDA; without a card it raises unless the caller
    passes ``device="cpu"`` (the plain torch path — the kernel wrappers take
    their plain versions for CPU tensors).  ``use_kernels=True`` resolves
    the "kernels" backend.  Only the replicated (whole index on one device)
    layout exists in this package so far.
    """

    def __init__(self, index: Index, cfg: Optional[MarsConfig] = None,
                 use_kernels: bool = False, device="cuda"):
        self.device = check_device(device)
        self.index = index
        self.cfg = cfg or index.cfg
        self.backend = stages.KERNELS if use_kernels else stages.REFERENCE
        self.plan = stages.resolve_plan(self.cfg, self.backend)
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
        """A Mapper over the SAME device-resident index arrays with a
        different config; only fields that do not shape the index may
        change."""
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
        arrays, cfg, plan, device = (self.arrays, self.cfg, self.plan,
                                     self.device)

        def fn(sig, nv):
            x = torch.from_numpy(np.ascontiguousarray(sig, np.float32))
            if device.type == "cuda":
                # pinned + non_blocking: the upload does not wait for the
                # previous chunk's device work
                x = x.pin_memory().to(device, non_blocking=True)
            return map_chunk(x, arrays, cfg, n_valid=nv, plan=plan)
        return fn

    def map_signals(self, signals: np.ndarray, chunk: int = 64) -> MapOutput:
        stream = driver.stream_map(self.chunk_fn(),
                                   driver.array_chunks(signals, chunk))
        return driver.collect(stream)


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
