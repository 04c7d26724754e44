"""Stage-graph execution engine for the MARS RSGA pipeline.

The MARS Control Unit (paper Section 6.1.3) sequences fine-grained tasks —
event detection, quantization, seeding, hash-table query, seed-and-vote,
anchor sort, chaining DP — across heterogeneous in-storage units.  This
module is the software analogue, as the reference package's
``repro.core.stages`` is: the per-read program is an explicit graph of
named stages, each with one or more registered ``Backend``s (the plain
torch *reference* implementation and, where a hand-written CUDA kernel
exists, a *kernels* one).  Backend selection is resolved per config into a
static, hashable *plan*: one (stage, backend) pair per stage of
STAGE_ORDER.

Dataflow state is a flat dict of tensors keyed by the names below; every
stage consumes/produces a documented subset.  Each tensor carries a leading
read axis R (the reference package's ``vmap`` made explicit), and a body
must be row-independent: row r of its outputs depends on row r of its
inputs only, so a chunk's rows equal R single-read runs.

    signal      (R, S)    f32   raw read samples            [input]
    events      (R, E)    f32   event means                 [detect]
    n_events    (R,)      i32   valid event count           [detect]
    symbols     (R, E)    i32   quantized event symbols     [quantize]
    keys        (R, E)    i64   seed hash keys (uint32)     [seed]
    seed_valid  (R, E)    bool  valid seed mask             [seed]
    q_pos       (R, E, H) i32   query positions of anchors  [query]
    t_pos       (R, E, H) i32   target positions of anchors [query]
    hit_valid   (R, E, H) bool  surviving anchors           [query, vote]
    sq, st, sv  (R, A)          sorted anchors + validity   [sort]
    f, diag0    (R, A)          DP chain scores/start diags [dp]
    result      ChainResult     mapping decision            [finalize]
    counters    dict of (R,)    uniform counter schema (COUNTER_SCHEMA)

Registering a kernel backend (each kernel's ``ops.py`` does this at
import; ``resolve_plan`` imports them lazily):

    from repro_torch.core import stages
    stages.register_backend("sort", stages.KERNELS, body,
                            primitive=sort_rows)

``body(state, cfg, index) -> state`` is the stage body; ``primitive`` is
the batch-level kernel the chunk program's fast paths call directly.  A
``query`` backend over another index layout (the tiered index's
``query:tiered``, core/tiered.py; the partitioned index's ``query:ring`` /
``query:a2a``, core/distributed.py) is a body without a primitive.  The
cheap stages also have ONE whole-phase kernel (``register_fused_cheap``,
kernels/cheap_fused), which ``fused_cheap_backend`` engages when the plan's
detect and query resolved to its backend, quantize, seed and vote to the
reference, and its own ``supports`` gate admits the config.  The float
detection's in-order segment sum is a helper of the detect stage's
reference math (``register_segment_sum``), not a stage: a plan binds the
one its backends registered.

Backends unavailable for a config (``supports`` false) or unregistered
fall back to the reference implementation, so a plan always covers every
stage.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import (chaining, events, hashing, quantization,
                              seeding, vote)
from repro_torch.core.config import MarsConfig

State = Dict[str, Any]

# Execution order of the per-read program (paper Fig. 1 steps 1a-3i).
STAGE_ORDER: Tuple[str, ...] = (
    "detect",     # (1a/1b) signal -> event means
    "quantize",   # (1b)    event means -> symbols
    "seed",       # (2c)    symbols -> hash keys (+ minimizer winnowing)
    "query",      # (2d/2e) hash-table gather + frequency filter
    "vote",       # (2f)    seed-and-vote filter
    "sort",       # (3g/3h) anchor sort (bitonic Sorter/Merger)
    "dp",         # (3i)    banded chaining DP
    "finalize",   #         best/second-best chain -> mapping decision
)

# The filter-aware split used by the chunk program (core/pipeline.py): the
# cheap phase runs on every read; the chaining phase runs only on the
# compacted batch of reads that still have anchors after the filters.
CHEAP_STAGES: Tuple[str, ...] = STAGE_ORDER[:5]   # detect .. vote
CHAIN_STAGES: Tuple[str, ...] = STAGE_ORDER[5:]   # sort, dp, finalize

# Canonical backend names ("kernels" plays the reference package's
# "pallas" role: the hand-written CUDA kernels).
REFERENCE = "reference"
KERNELS = "kernels"

# Modules that register kernel backends, imported the first time a plan
# asks for them (importing core never loads a kernel module).
_BACKEND_MODULES: Dict[str, Tuple[str, ...]] = {
    KERNELS: (
        "repro_torch.kernels.event_detect.ops",
        "repro_torch.kernels.pluto_lookup.ops",
        "repro_torch.kernels.bitonic_sort.ops",
        "repro_torch.kernels.chain_dp.ops",
        # whole-phase fused cheap kernel (registers through
        # register_fused_cheap, not the per-stage registry)
        "repro_torch.kernels.cheap_fused.ops",
        "repro_torch.kernels.segment_sum.ops",
    ),
    # the distributed query schedules over a bucket-range-partitioned index
    # (a collective-permute ring / one all-to-all), each just another
    # ``query`` backend of the same chunk program (core/distributed.py)
    "ring": ("repro_torch.core.distributed",),
    "a2a": ("repro_torch.core.distributed",),
    # out-of-core query over host-resident bucket-range tiles paged into a
    # device tile cache (core/tiered.py)
    "tiered": ("repro_torch.core.tiered",),
}
_loaded_backend_modules = set()

# The index layouts a query backend consumes: the whole packed table on the
# device (``index.index_arrays``), one bucket-range partition of
# ``index.partition_index`` a 'model' rank of a mesh, or a
# ``tiered.HotTileCache`` view of the host-resident tiles.
INDEX_KINDS: Tuple[str, ...] = ("replicated", "partitioned", "tiered")

# Uniform per-chunk counter schema (docs/COUNTERS.md of the reference
# package): every map_chunk output carries exactly these counters.
COUNTER_SCHEMA: Tuple[str, ...] = (
    "n_events", "n_seeds", "n_bucket_probes", "n_hits_raw",
    "n_hits_postfreq", "n_hits_exact", "n_votes_cast",
    "n_anchors_postvote", "n_sorted", "n_dp_pairs",
)
CHUNK_COUNTER_SCHEMA: Tuple[str, ...] = COUNTER_SCHEMA + (
    "n_reads", "n_samples")

# Per-stage DEBUG counters a stage may emit beside the schema; the chunk
# program drops them so CHUNK_COUNTER_SCHEMA stays exact.
DEBUG_COUNTER_SCHEMA: Tuple[str, ...] = (
    "n_votes_clipped",
    # the tiered index's tile cache (core/tiered.py), per chunk: tile hits,
    # misses, host->device paged bytes (int32, clamped), page-in re-reads
    # and checksum mismatches caught (exact totals live on HotTileCache)
    "n_tile_hits", "n_tile_misses", "n_tile_paged_bytes",
    "n_tile_retries", "n_tile_corruptions",
)


@dataclasses.dataclass(frozen=True)
class Backend:
    """One implementation of one stage.

    ``fn(state, cfg, index) -> state`` is the stage body over the state
    dict.  ``supports`` gates configs the implementation cannot serve (e.g.
    the fixed-point event-detect kernel under a float config); unsupported
    backends resolve to the reference implementation instead.

    ``primitive`` is the stage's underlying batch-level kernel, exposed so
    the chunk program's fast paths can call it outside the state-dict
    protocol (``cheap_primitives``, ``chain_primitives``):

        detect: primitive(signals (R, S) f32, cfg) -> (means (R, E) f32,
                n_events (R,) int32)
        query:  primitive(table (N,) or (W, N), idx) -> the clipped gather
        sort:   primitive(keys (N, L) int32) -> rows sorted ascending
        dp:     primitive(q, t, valid (N, A), cfg) -> (f (N, A) f32,
                diag0 (N, A) int32)

    ``index_kind`` (one of INDEX_KINDS) declares the index layout the
    backend consumes; ``plan_index_kind`` reads it off the query stage.
    """
    stage: str
    name: str
    fn: Callable[[State, MarsConfig, Dict[str, torch.Tensor]], State]
    supports: Optional[Callable[[MarsConfig], bool]] = None
    primitive: Optional[Callable] = None
    index_kind: str = "replicated"


_REGISTRY: Dict[Tuple[str, str], Backend] = {}


def register_backend(stage: str, name: str, fn,
                     supports=None, replace: bool = False,
                     primitive=None, index_kind: str = "replicated") -> None:
    """Register ``fn`` as backend ``name`` for ``stage``.

    ``fn(state, cfg, index) -> state`` must be bit-exact to the stage's
    reference backend — same state keys, same values, and the exact
    COUNTER_SCHEMA counter increments (extra diagnostics are allowed only
    as DEBUG_COUNTER_SCHEMA keys, which the chunk program drops) — and
    row-independent.  ``supports(cfg)`` gates eligibility (unsupported
    configs fall back to reference in resolve_plan); ``primitive``
    optionally exposes a batch-level entry point; ``index_kind`` declares
    the index layout the backend consumes.  ``replace`` allows
    re-registering an existing (stage, name).
    """
    if stage not in STAGE_ORDER:
        raise ValueError(f"unknown stage {stage!r}; stages: {STAGE_ORDER}")
    if index_kind not in INDEX_KINDS:
        raise ValueError(f"unknown index_kind {index_kind!r}")
    key = (stage, name)
    if key in _REGISTRY and not replace:
        raise ValueError(f"backend {key} already registered")
    _REGISTRY[key] = Backend(stage=stage, name=name, fn=fn, supports=supports,
                             primitive=primitive, index_kind=index_kind)


def get_backend(stage: str, name: str) -> Backend:
    return _REGISTRY[(stage, name)]


def registered_backends(stage: str) -> Tuple[str, ...]:
    return tuple(sorted(n for (s, n) in _REGISTRY if s == stage))


def _ensure_backend_loaded(name: str) -> None:
    if name in _loaded_backend_modules:
        return
    for mod in _BACKEND_MODULES.get(name, ()):
        importlib.import_module(mod)
    _loaded_backend_modules.add(name)


Plan = Tuple[Tuple[str, str], ...]


def resolve_plan(cfg: MarsConfig, backend: str = REFERENCE) -> Plan:
    """Resolve the per-stage backend choice for one config.

    Returns a hashable ((stage, backend_name), ...) tuple in STAGE_ORDER.
    Stages without the requested backend (or whose backend does not
    support ``cfg``) fall back to reference.
    """
    _ensure_backend_loaded(backend)
    known = ({REFERENCE} | set(_BACKEND_MODULES)
             | {n for _, n in _REGISTRY})
    if backend not in known:
        raise ValueError(f"unknown backend {backend!r}; known: "
                         f"{sorted(known)}")
    plan = []
    for stage in STAGE_ORDER:
        b = _REGISTRY.get((stage, backend))
        if b is None or (b.supports is not None and not b.supports(cfg)):
            b = _REGISTRY[(stage, REFERENCE)]
        plan.append((stage, b.name))
    return tuple(plan)


def plan_index_kind(plan: Plan) -> str:
    """The index layout ``plan`` consumes (INDEX_KINDS): only the query
    stage touches the index, so its backend decides."""
    return _REGISTRY[("query", dict(plan)["query"])].index_kind


# --------------------------------------------------------------------------- #
# The float detection's segment sum, by backend
# --------------------------------------------------------------------------- #
# The in-order f32 segment sum of the float detection's event means
# (``events.segment_means_reference``).  It serves the detect stage's
# reference math, so it is no stage of the plan (plans stay equal to the
# reference package's); a plan binds the one its backends registered (the
# kernels plan: the segment_sum kernel, since torch's own scatters on the
# card add in no fixed order), the reference plan the plain loop.
_SEGMENT_SUM: Dict[str, Callable] = {REFERENCE: events.segment_sum_in_order}


def register_segment_sum(name: str, fn) -> None:
    """Register ``fn`` (``events.segment_sum_in_order``'s contract, bit-exact
    to it) as backend ``name``'s segment sum of the float detection."""
    if name in _SEGMENT_SUM:
        raise ValueError(f"segment sum {name!r} already registered")
    _SEGMENT_SUM[name] = fn


def _segment_sum(plan: Plan) -> Callable:
    """The segment sum registered by a backend ``plan``'s stages name, else
    the reference's: a backend without one (the tiered index's) keeps the
    reference detection whole."""
    names = sorted({b for _, b in plan} & set(_SEGMENT_SUM) - {REFERENCE})
    return _SEGMENT_SUM[names[0] if names else REFERENCE]


def stage_body(plan: Plan, stage: str) -> Callable:
    """The body ``plan`` runs for ``stage``: the registered backend's
    ``fn``, with the reference detection bound to the plan's segment sum."""
    name = dict(plan)[stage]
    fn = _REGISTRY[(stage, name)].fn
    if stage == "detect" and name == REFERENCE:
        fn = functools.partial(fn, segment_sum=_segment_sum(plan))
    return fn


# --------------------------------------------------------------------------- #
# The engine
# --------------------------------------------------------------------------- #
def execute_stages(state: State, index: Dict[str, torch.Tensor],
                   cfg: MarsConfig, plan: Plan,
                   subset: Tuple[str, ...]) -> State:
    """Run the stages of ``plan`` named in ``subset`` (in plan order) over an
    existing state dict.  The chunk program uses this to split the per-read
    graph into the cheap phase (CHEAP_STAGES) and the chaining phase
    (CHAIN_STAGES)."""
    for stage, _ in plan:
        if stage in subset:
            state = stage_body(plan, stage)(state, cfg, index)
    return state


def execute_reads(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                  cfg: MarsConfig, plan: Plan):
    """Run the whole per-read stage graph over a chunk: signals (R, S) f32.

    Returns (ChainResult of (R,) tensors, counters of (R,) tensors, exactly
    COUNTER_SCHEMA plus any DEBUG_COUNTER_SCHEMA keys).  Under the kernels
    plan each stage is one launch for the chunk.
    """
    state: State = {"signal": signals, "counters": {}}
    state = execute_stages(state, index, cfg, plan, STAGE_ORDER)
    counters = state["counters"]
    missing = missing_counters(counters)
    if missing:
        raise RuntimeError(f"plan {plan} produced incomplete counters; "
                           f"missing {missing}")
    return state["result"], counters


def execute_read(signal: torch.Tensor, index: Dict[str, torch.Tensor],
                 cfg: MarsConfig, plan: Plan):
    """Run the per-read stage graph.  signal: (S,) f32.

    Returns (ChainResult of 0-d tensors, counters of 0-d tensors, exactly
    COUNTER_SCHEMA): ``execute_reads`` over a unit read axis, stripped.
    """
    res, counters = execute_reads(signal.unsqueeze(0), index, cfg, plan)
    return (chaining.ChainResult(*(x[0] for x in res)),
            {k: v[0] for k, v in counters.items()})


def chain_primitives(plan: Plan, cfg: MarsConfig):
    """Resolve the (sorter, dp) batch-level primitives of ``plan``'s chain
    stages for the compacted chaining phase, or None when the plan's chain
    stages cannot be expressed through primitives (a registered backend
    without a ``primitive``, or a non-reference finalize, must go through
    the stage bodies instead: the chunk program's whole-graph route).

    Returns (sorter(keys (N, L)) -> sorted rows, dp(q, t, valid) -> (f,
    diag0)).
    """
    p = dict(plan)
    if p["finalize"] != REFERENCE:
        return None
    prims = []
    for stage in ("sort", "dp"):
        b = _REGISTRY[(stage, p[stage])]
        if b.name != REFERENCE and b.primitive is None:
            return None
        prims.append(b.primitive)
    sorter = prims[0] if prims[0] is not None else chaining._sort_rows
    dp_prim = prims[1] if prims[1] is not None else chaining.chain_dp
    return sorter, (lambda q, t, v: dp_prim(q, t, v, cfg))


@dataclasses.dataclass(frozen=True)
class FusedCheapBackend:
    """A whole-phase fused implementation of CHEAP_STAGES:
    fn(signals (R, S), index, cfg) -> (q_pos, t_pos, hit_valid, counters),
    the exact ``pipeline.cheap_phase`` contract from ONE kernel launch."""
    name: str
    fn: Callable
    supports: Optional[Callable[[MarsConfig], bool]] = None


_FUSED_CHEAP: Dict[str, FusedCheapBackend] = {}


def register_fused_cheap(name: str, fn, supports=None,
                         replace: bool = False) -> None:
    """Register a whole-phase fused cheap kernel under backend ``name``.

    The fused kernel engages only for plans whose detect AND query stages
    resolved to ``name`` with quantize/seed/vote at reference — the
    per-stage programs it replaces are exactly the ones it fuses."""
    if name in _FUSED_CHEAP and not replace:
        raise ValueError(f"fused cheap backend {name!r} already registered")
    _FUSED_CHEAP[name] = FusedCheapBackend(name=name, fn=fn,
                                           supports=supports)


def fused_cheap_backend(plan: Plan,
                        cfg: MarsConfig) -> Optional[FusedCheapBackend]:
    """Resolve ``plan``'s whole-phase fused kernel, or None when the plan's
    cheap stages are not the exact per-stage shape the fusion covers (or the
    kernel's ``supports`` gate rejects ``cfg``)."""
    p = dict(plan)
    b = _FUSED_CHEAP.get(p["detect"])
    if b is None or p["query"] != b.name:
        return None
    if any(p[s] != REFERENCE for s in ("quantize", "seed", "vote")):
        return None
    if b.supports is not None and not b.supports(cfg):
        return None
    return b


class CheapPrimitives(NamedTuple):
    """``plan``'s cheap-phase callables, bound to the config: ``fused``
    (signals, index) -> the whole cheap-phase contract, or None; the
    per-stage level's ``detector`` (signals -> (means, n_events)) and
    either ``gather`` (table, idx -> values, for ``seeding.query_index``;
    None for its default clipping gather) or ``query_fn`` (the query
    backend's stage body, when it is not gather-expressible)."""
    fused: Optional[Callable]
    detector: Callable
    gather: Optional[Callable]
    query_fn: Optional[Callable] = None


def cheap_primitives(plan: Plan, cfg: MarsConfig) -> Optional[CheapPrimitives]:
    """Bind ``plan``'s batch-level cheap phase to ``cfg``, or None when the
    plan's cheap stages cannot be expressed at batch level (a registered
    non-reference quantize/seed/vote backend, or a non-reference detect
    backend without a batch primitive): those plans run the stage bodies
    (``pipeline.cheap_phase_vmap``)."""
    p = dict(plan)
    for stage in ("quantize", "seed", "vote"):
        if p[stage] != REFERENCE:
            return None
    det = _REGISTRY[("detect", p["detect"])]
    if det.name != REFERENCE and det.primitive is None:
        return None
    if det.name == REFERENCE:
        detector = functools.partial(_detect_reference, cfg=cfg,
                                     segment_sum=_segment_sum(plan))
    else:
        detector = functools.partial(det.primitive, cfg=cfg)
    b = fused_cheap_backend(plan, cfg)
    fused = None if b is None else functools.partial(b.fn, cfg=cfg)
    q = _REGISTRY[("query", p["query"])]
    if q.name == REFERENCE:
        return CheapPrimitives(fused, detector, None)
    if q.primitive is not None:
        return CheapPrimitives(fused, detector, q.primitive)
    return CheapPrimitives(fused, detector, None, query_fn=q.fn)


def missing_counters(counters) -> Tuple[str, ...]:
    return tuple(k for k in COUNTER_SCHEMA if k not in counters)


def _detect_reference(signals, cfg: MarsConfig, segment_sum):
    means, n_ev, _ = events.detect_events(signals, cfg, segment_sum)
    return means, n_ev


# --------------------------------------------------------------------------- #
# Parametrized stage bodies.  Reference backends call these with the torch
# default; kernel ops.py modules call them with their kernel (detector /
# gather / sorter / dp) — keeping the math in ONE place.
# --------------------------------------------------------------------------- #
def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def detect_with(state: State, cfg: MarsConfig, index, detector=None,
                segment_sum=events.segment_sum_in_order) -> State:
    """Event detection: ``detector(signals) -> (means, n_events)``, or the
    reference math (``events.detect_events``) with ``segment_sum``."""
    if detector is None:
        ev, n_ev, _ = events.detect_events(state["signal"], cfg, segment_sum)
    else:
        ev, n_ev = detector(state["signal"])
    return {**state, "events": ev, "n_events": n_ev,
            "counters": {**state["counters"], "n_events": _i32(n_ev)}}


def quantize_ref(state: State, cfg: MarsConfig, index) -> State:
    ev = state["events"]
    ev_valid = (torch.arange(cfg.max_events, device=ev.device)
                < state["n_events"].unsqueeze(-1))
    sym = quantization.quantize_events(ev, ev_valid, cfg)
    return {**state, "symbols": sym}


def seed_ref(state: State, cfg: MarsConfig, index) -> State:
    keys, valid = hashing.pack_seeds(state["symbols"], state["n_events"], cfg)
    valid = hashing.minimizer_mask(keys, valid, cfg.minimizer_radius)
    return {**state, "keys": keys, "seed_valid": valid}


def with_query(state: State, cfg: MarsConfig, t_pos: torch.Tensor,
               hit_valid: torch.Tensor, counters: Dict) -> State:
    """The query stage's state update from a query's (t_pos (R, E, H),
    hit_valid, per-read counters): the anchors' query positions are their
    event slots.  Shared by every query body."""
    q_pos = torch.arange(cfg.max_events, dtype=torch.int32,
                         device=t_pos.device)[None, :, None].expand(
                             t_pos.shape)
    return {**state, "q_pos": q_pos, "t_pos": t_pos, "hit_valid": hit_valid,
            "counters": {**state["counters"], **counters}}


def query_with(state: State, cfg: MarsConfig, index, gather=None) -> State:
    t_pos, hit_valid, c = seeding.query_index(
        state["keys"], state["seed_valid"], index, cfg, gather=gather)
    return with_query(state, cfg, t_pos, hit_valid, c)


def vote_ref(state: State, cfg: MarsConfig, index) -> State:
    hit_valid, c = vote.vote_filter(state["q_pos"], state["t_pos"],
                                    state["hit_valid"], cfg)
    return {**state, "hit_valid": hit_valid,
            "counters": {**state["counters"], **c}}


def sort_with(state: State, cfg: MarsConfig, index, sorter=None) -> State:
    """All E*H anchor keys of each read sorted (``sorter``), the first
    ``max_anchors`` kept: ``chaining.sort_anchors`` at full width."""
    sq, st, sv = chaining.sort_anchors(state["q_pos"], state["t_pos"],
                                       state["hit_valid"], cfg, sorter=sorter)
    n_sorted = torch.clamp(state["hit_valid"].sum((-2, -1)),
                           max=cfg.max_anchors)
    return {**state, "sq": sq, "st": st, "sv": sv,
            "counters": {**state["counters"], "n_sorted": _i32(n_sorted)}}


def dp_with(state: State, cfg: MarsConfig, index, dp=None) -> State:
    if dp is None:
        f, diag0 = chaining.chain_dp(state["sq"], state["st"], state["sv"],
                                     cfg)
    else:
        f, diag0 = dp(state["sq"], state["st"], state["sv"])
    n_dp_pairs = state["sv"].sum(-1) * cfg.chain_band
    return {**state, "f": f, "diag0": diag0,
            "counters": {**state["counters"], "n_dp_pairs": _i32(n_dp_pairs)}}


def finalize_ref(state: State, cfg: MarsConfig, index) -> State:
    res = chaining.best_chain(state["f"], state["diag0"], state["sv"], cfg)
    return {**state, "result": res}


def _detect_ref(state, cfg, index, segment_sum=events.segment_sum_in_order):
    return detect_with(state, cfg, index, segment_sum=segment_sum)


def _query_ref(state, cfg, index):
    return query_with(state, cfg, index, gather=None)


def _sort_ref(state, cfg, index):
    return sort_with(state, cfg, index, sorter=None)


def _dp_ref(state, cfg, index):
    return dp_with(state, cfg, index, dp=None)


register_backend("detect", REFERENCE, _detect_ref)
register_backend("quantize", REFERENCE, quantize_ref)
register_backend("seed", REFERENCE, seed_ref)
register_backend("query", REFERENCE, _query_ref)
register_backend("vote", REFERENCE, vote_ref)
register_backend("sort", REFERENCE, _sort_ref)
register_backend("dp", REFERENCE, _dp_ref)
register_backend("finalize", REFERENCE, finalize_ref)
