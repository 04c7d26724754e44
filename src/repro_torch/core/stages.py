"""Stage registry and backend plans for the MARS RSGA pipeline.

The per-read program runs the cheap stages (detect, quantize, seed, query,
vote) and then the chain stages (sort, dp, finalize): the fine-grained
tasks the MARS Control Unit sequences, paper Section 6.1.3.  A hand-written
kernel registers itself from its ``ops.py`` at import:

* four stages take batch-level primitives (``register_backend``), each
  with an optional ``supports`` gate: ``detect`` (signals -> event means
  and counts; the reference is ``events.detect_events``), ``query`` (the
  clipping gather of ``seeding.query_index``), ``sort`` (a row sort) and
  ``dp`` (``chaining.chain_dp``); quantize, seed, vote and finalize have no
  kernel and always run the reference math;
* the cheap stages also have ONE whole-phase kernel
  (``register_fused_cheap``, kernels/cheap_fused), which engages when the
  plan's detect and query resolved to its backend and its own ``supports``
  gate admits the config;
* the float detection's in-order segment sum is a helper of the detect
  stage's reference math (``register_segment_sum``), not a stage: a plan
  binds the one its backend registered.

``resolve_plan`` turns a config + requested backend into a static, hashable
plan, stage by stage as the reference package's ``resolve_plan`` does: a
stage without the requested backend, or whose gate rejects the config,
resolves to the reference.  ``cheap_primitives`` and ``chain_primitives``
hand the plan's callables to the two phases.

    from repro_torch.core import stages
    stages.register_backend("sort", stages.KERNELS, primitive=sorter)
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

from repro_torch.core import chaining, events, seeding
from repro_torch.core.config import MarsConfig

# The stages that take a batch-level primitive, in plan order.
PRIMITIVE_STAGES: Tuple[str, ...] = ("detect", "query", "sort", "dp")

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
        "repro_torch.kernels.cheap_fused.ops",
        "repro_torch.kernels.segment_sum.ops",
    ),
}
_loaded_backend_modules = set()

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
# program drops them so CHUNK_COUNTER_SCHEMA stays exact.  (The reference
# package's tiered-index counters join when that slice is ported.)
DEBUG_COUNTER_SCHEMA: Tuple[str, ...] = ("n_votes_clipped",)


class Backend(NamedTuple):
    primitive: Callable
    supports: Optional[Callable[[MarsConfig], bool]] = None


# (stage, backend name) -> batch-level primitive + gate:
#     detect: primitive(signals (R, S) f32, cfg) -> (means (R, E) f32,
#             n_events (R,) int32)
#     query:  primitive(table (N,) or (W, N), idx) -> clipped gather
#     sort:   primitive(keys (N, L) int32) -> rows sorted ascending
#     dp:     primitive(q, t, valid (N, A), cfg) -> (f (N, A) f32,
#             diag0 (N, A) int32)
_REGISTRY: Dict[Tuple[str, str], Backend] = {}


def register_backend(stage: str, name: str, primitive: Callable,
                     supports=None) -> None:
    """Register ``primitive`` as backend ``name`` of ``stage``; ``supports``
    (cfg -> bool) gates the configs it serves.  It must be bit-exact to the
    stage's reference."""
    if stage not in PRIMITIVE_STAGES:
        raise ValueError(f"stage {stage!r} takes no primitive; stages: "
                         f"{PRIMITIVE_STAGES}")
    key = (stage, name)
    if key in _REGISTRY:
        raise ValueError(f"backend {key} already registered")
    _REGISTRY[key] = Backend(primitive, supports)


def _ensure_backend_loaded(name: str) -> None:
    if name in _loaded_backend_modules:
        return
    for mod in _BACKEND_MODULES.get(name, ()):
        importlib.import_module(mod)
    _loaded_backend_modules.add(name)


Plan = Tuple[Tuple[str, str], ...]


def resolve_plan(cfg: MarsConfig, backend: str = REFERENCE) -> Plan:
    """Resolve the backend choice for one config: a hashable ((stage,
    backend_name), ...) tuple over PRIMITIVE_STAGES, each stage on
    ``backend`` when it has one whose gate admits ``cfg`` and on the
    reference otherwise, followed by ("fused", name): ``backend`` when its
    whole-phase cheap kernel serves this plan (detect and query resolved
    to it, and its gate admits ``cfg``), else the reference."""
    _ensure_backend_loaded(backend)
    known = ({REFERENCE} | set(_BACKEND_MODULES)
             | {n for _, n in _REGISTRY} | set(_FUSED_CHEAP))
    if backend not in known:
        raise ValueError(f"unknown backend {backend!r}; known: "
                         f"{sorted(known)}")
    plan = []
    for stage in PRIMITIVE_STAGES:
        b = _REGISTRY.get((stage, backend))
        ok = b is not None and (b.supports is None or b.supports(cfg))
        plan.append((stage, backend if ok else REFERENCE))
    p = dict(plan)
    fused = _FUSED_CHEAP.get(backend)
    ok = (fused is not None and p["detect"] == p["query"] == backend
          and (fused.supports is None or fused.supports(cfg)))
    plan.append(("fused", backend if ok else REFERENCE))
    return tuple(plan)


def chain_primitives(plan: Plan, cfg: MarsConfig):
    """The batch-level (sorter, dp) primitives of ``plan``'s chain stages:
    ``sorter(keys (N, L)) -> sorted rows`` and ``dp(q, t, valid) -> (f,
    diag0)``."""
    p = dict(plan)
    sorter = _REGISTRY[("sort", p["sort"])].primitive
    dp = _REGISTRY[("dp", p["dp"])].primitive
    return sorter, (lambda q, t, v: dp(q, t, v, cfg))


@dataclasses.dataclass(frozen=True)
class FusedCheapBackend:
    """A whole-phase fused implementation of the cheap stages:
    fn(signals (R, S), index, cfg) -> (q_pos, t_pos, hit_valid, counters),
    the exact ``pipeline.cheap_phase`` contract from ONE kernel launch."""
    name: str
    fn: Callable
    supports: Optional[Callable[[MarsConfig], bool]] = None


_FUSED_CHEAP: Dict[str, FusedCheapBackend] = {}


def register_fused_cheap(name: str, fn, supports=None) -> None:
    """Register a whole-phase fused cheap kernel under backend ``name``."""
    if name in _FUSED_CHEAP:
        raise ValueError(f"fused cheap backend {name!r} already registered")
    _FUSED_CHEAP[name] = FusedCheapBackend(name=name, fn=fn,
                                           supports=supports)


def fused_cheap_backend(plan: Plan,
                        cfg: MarsConfig) -> Optional[FusedCheapBackend]:
    """``plan``'s whole-phase fused kernel, or None when the plan resolved
    none or the kernel's ``supports`` gate rejects ``cfg``."""
    b = _FUSED_CHEAP.get(dict(plan)["fused"])
    if b is None or (b.supports is not None and not b.supports(cfg)):
        return None
    return b


# The in-order f32 segment sum of the float detection's event means
# (``events.segment_means_reference``), by backend.  It serves the detect
# stage's reference math, so it is no stage of the plan (plans stay equal
# to the reference package's); a plan binds the one its backend registered
# (the kernels plan: the segment_sum kernel, since torch's own scatters on
# the card add in no fixed order), the reference plan the plain loop.
_SEGMENT_SUM: Dict[str, Callable] = {REFERENCE: events.segment_sum_in_order}


def register_segment_sum(name: str, fn) -> None:
    """Register ``fn`` (``events.segment_sum_in_order``'s contract, bit-exact
    to it) as backend ``name``'s segment sum of the float detection."""
    if name in _SEGMENT_SUM:
        raise ValueError(f"segment sum {name!r} already registered")
    _SEGMENT_SUM[name] = fn


def _plan_backend(plan: Plan) -> str:
    """The backend ``plan`` was resolved for: the one its stages name
    beside the reference, or the reference."""
    names = {b for _, b in plan} - {REFERENCE}
    return names.pop() if names else REFERENCE


class CheapPrimitives(NamedTuple):
    """``plan``'s cheap-phase callables, bound to the config: ``fused``
    (signals, index) -> the whole cheap-phase contract, or None; the
    per-stage level's ``detector`` (signals -> (means, n_events)) and
    ``gather`` (table, idx -> values)."""
    fused: Optional[Callable]
    detector: Callable
    gather: Callable


def cheap_primitives(plan: Plan, cfg: MarsConfig) -> CheapPrimitives:
    """Bind ``plan``'s cheap-phase backends to ``cfg``."""
    p = dict(plan)
    b = fused_cheap_backend(plan, cfg)
    det = functools.partial(_REGISTRY[("detect", p["detect"])].primitive,
                            cfg=cfg)
    if p["detect"] == REFERENCE:
        det = functools.partial(
            det, segment_sum=_SEGMENT_SUM[_plan_backend(plan)])
    return CheapPrimitives(
        fused=None if b is None else functools.partial(b.fn, cfg=cfg),
        detector=det,
        gather=_REGISTRY[("query", p["query"])].primitive)


def missing_counters(counters) -> Tuple[str, ...]:
    return tuple(k for k in COUNTER_SCHEMA if k not in counters)


def _detect_reference(signals, cfg: MarsConfig, segment_sum):
    means, n_ev, _ = events.detect_events(signals, cfg, segment_sum)
    return means, n_ev


register_backend("detect", REFERENCE, _detect_reference)
register_backend("query", REFERENCE, seeding._take_clip)
register_backend("sort", REFERENCE, chaining._sort_rows)
register_backend("dp", REFERENCE, chaining.chain_dp)
