"""Stage registry and backend plans for the MARS RSGA pipeline.

The per-read program runs the cheap stages (detect, quantize, seed, query,
vote) and then the chain stages (sort, dp, finalize): the fine-grained
tasks the MARS Control Unit sequences, paper Section 6.1.3.  A hand-written
kernel registers itself from its ``ops.py`` at import:

* the chain stages ``sort`` and ``dp`` take batch-level primitives
  (``register_backend``; the reference primitives are a torch row sort and
  ``chaining.chain_dp``), which ``chain_primitives`` hands to the chaining
  phase;
* the cheap stages have ONE whole-phase kernel (``register_fused_cheap``,
  kernels/cheap_fused) whose ``supports`` gate says which configs it
  serves; ``cheap_primitives`` binds it.

``resolve_plan`` turns a config + requested backend into a static, hashable
plan; a stage without the requested backend resolves to the reference.

    from repro_torch.core import stages
    stages.register_backend("sort", stages.KERNELS, primitive=sorter)
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import chaining
from repro_torch.core.config import MarsConfig

# The stages that take a batch-level primitive.
PRIMITIVE_STAGES: Tuple[str, ...] = ("sort", "dp")

# Canonical backend names ("kernels" plays the reference package's
# "pallas" role: the hand-written CUDA kernels).
REFERENCE = "reference"
KERNELS = "kernels"

# Modules that register kernel backends, imported the first time a plan
# asks for them (importing core never loads a kernel module).
_BACKEND_MODULES: Dict[str, Tuple[str, ...]] = {
    KERNELS: (
        "repro_torch.kernels.bitonic_sort.ops",
        "repro_torch.kernels.chain_dp.ops",
        "repro_torch.kernels.cheap_fused.ops",
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


# (stage, backend name) -> batch-level primitive:
#     sort:  primitive(keys (N, L) int32) -> rows sorted ascending
#     dp:    primitive(q, t, valid (N, A), cfg) -> (f (N, A) f32,
#            diag0 (N, A) int32)
_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register_backend(stage: str, name: str, primitive: Callable) -> None:
    """Register ``primitive`` as backend ``name`` of ``stage``.  It must be
    bit-exact to the stage's reference."""
    if stage not in PRIMITIVE_STAGES:
        raise ValueError(f"stage {stage!r} takes no primitive; stages: "
                         f"{PRIMITIVE_STAGES}")
    key = (stage, name)
    if key in _REGISTRY:
        raise ValueError(f"backend {key} already registered")
    _REGISTRY[key] = primitive


def _ensure_backend_loaded(name: str) -> None:
    if name in _loaded_backend_modules:
        return
    for mod in _BACKEND_MODULES.get(name, ()):
        importlib.import_module(mod)
    _loaded_backend_modules.add(name)


Plan = Tuple[Tuple[str, str], ...]


def resolve_plan(cfg: MarsConfig, backend: str = REFERENCE) -> Plan:
    """Resolve the backend choice for one config: a hashable ((stage,
    backend_name), ...) tuple over PRIMITIVE_STAGES (a stage without the
    requested backend resolves to the reference), followed by ("cheap",
    backend) — the backend whose whole-phase cheap kernel runs the cheap
    stages when its ``supports`` gate admits ``cfg``."""
    _ensure_backend_loaded(backend)
    known = ({REFERENCE} | set(_BACKEND_MODULES)
             | {n for _, n in _REGISTRY} | set(_FUSED_CHEAP))
    if backend not in known:
        raise ValueError(f"unknown backend {backend!r}; known: "
                         f"{sorted(known)}")
    plan = [(stage, backend if (stage, backend) in _REGISTRY else REFERENCE)
            for stage in PRIMITIVE_STAGES]
    plan.append(("cheap", backend))
    return tuple(plan)


def chain_primitives(plan: Plan, cfg: MarsConfig):
    """The batch-level (sorter, dp) primitives of ``plan``'s chain stages:
    ``sorter(keys (N, L)) -> sorted rows`` and ``dp(q, t, valid) -> (f,
    diag0)``."""
    p = dict(plan)
    sorter = _REGISTRY[("sort", p["sort"])]
    dp = _REGISTRY[("dp", p["dp"])]
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
    """``plan``'s whole-phase fused kernel, or None when the plan did not ask
    for one or the kernel's ``supports`` gate rejects ``cfg``."""
    b = _FUSED_CHEAP.get(dict(plan).get("cheap"))
    if b is None:
        return None
    if b.supports is not None and not b.supports(cfg):
        return None
    return b


def cheap_primitives(plan: Plan, cfg: MarsConfig) -> Optional[Callable]:
    """``plan``'s whole-phase cheap kernel bound to ``cfg`` — (signals,
    index) -> (q_pos, t_pos, hit_valid, counters) — or None when
    ``fused_cheap_backend`` finds none."""
    b = fused_cheap_backend(plan, cfg)
    return None if b is None else functools.partial(b.fn, cfg=cfg)


def missing_counters(counters) -> Tuple[str, ...]:
    return tuple(k for k in COUNTER_SCHEMA if k not in counters)


register_backend("sort", REFERENCE, chaining._sort_rows)
register_backend("dp", REFERENCE, chaining.chain_dp)
