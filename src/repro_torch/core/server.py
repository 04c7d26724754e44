"""Continuous-batching serving driver: many concurrent read streams, one
chunk pipeline.

MARS's headline claim is throughput at sequencer line rate: the
orchestrator overlaps flash loads with compute so the storage system
serves many concurrent read streams, not one batch job (Sections
6.3-6.4).  ``ServeDriver`` is the host-side serving analogue over the
existing stage engine:

  * **Admission** — clients ``submit`` reads tagged with a stream id,
    priority and (virtual-time) deadline into ONE bounded ready queue.
    When the queue is full, admission is priority-aware: a new read
    evicts the worst-ranked queued read only if it outranks it,
    otherwise it is rejected — bounded memory and graceful degradation
    under overload instead of unbounded growth.
  * **Packing** — each scheduling round takes the best-ranked ready
    reads (priority desc, deadline asc, arrival order) that share a
    ladder stage and packs them into the fixed-size padded chunks
    ``map_chunk`` already consumes: ``driver.pad_rows`` + the traced
    ``n_valid`` mask keep the counters exact, so chunk composition is
    invisible to per-read results AND to counter totals.
  * **One loop** — chunks are driven through the unified double-buffered
    ``driver.stream_map`` loop (the same loop Mapper / realtime / the
    launcher use), so host packing overlaps device compute exactly as in
    batch mapping.  The chunk source is a generator over the live ready
    queue: results routed from chunk i re-enter the queue in time to be
    packed while chunk i+1 is still on the device.
  * **Routing** — every chunk remembers which (stream, read) occupies
    each row; results are trimmed to ``n_valid`` and scattered back to
    their owning stream in submission order.
  * **Early termination** — with ``early_term=True`` reads climb the
    realtime.py prefix ladder (``realtime.stage_cfg``): a read that maps
    confidently at a short prefix frees its slot immediately (the Read
    Until path), unresolved reads re-enter the queue at the next prefix
    length.  Decision thresholds are bit-identical to
    ``realtime.map_realtime``, so per-read serving results equal the
    batch realtime results for ANY interleaving.

Bit-parity is structural: each read's program depends only on its own
signal (chunk-mates only pick between branches that are bit-identical
per read — compaction gate, width ladder), so ServeDriver output equals
``Mapper.map_signals`` on the same reads (early_term off) or
``realtime.map_realtime`` (early_term on), for every admission order and
either backend plan (the JAX package's tests/test_server.py pins that
contract; tests/test_torch_serving.py holds this port to the JAX package's
driver on it).

Time: the driver keeps a *virtual clock* (arbitrary units) used for
arrival traces, deadlines and per-read latency accounting — every
dispatched chunk advances it by ``chunk_cost`` scaled by the prefix
fraction, and virtual time the tiered storage path loses to page-in
retry/backoff (``HotTileCache.vtime_penalty``) is folded in as it
accrues.  Wall-clock throughput is measured separately by the caller
(launch/serve_rsga.py).  On the card a chunk's device work is enqueued
when the driver dispatches it; its results are pulled one chunk later, so
the wall clock never decides a report.

Overload (the closed loop): with ``shed=True`` the driver feeds its
overload evidence into the configured ``CostModel``
(``core/costmodel.py``, ``cost_model="analytic"`` by default) through
``shed_signal``: the trailing offered load (the queueing model's
no-steady-state check) AND the *measured* per-read queue delays at
dispatch — the second term trips on effective-capacity loss the offered
load cannot see, e.g. storage-path retry/backoff stretching the virtual
clock.  While the signal holds, the driver sheds the least-worthy
sheddable read (lowest priority, then latest deadline, then newest) per
admission and — with ``early_term`` — packs the SHORTEST prefix stage
first so slots free as early as possible.  ``SLOClass`` tags reads with
per-class priority / relative-deadline defaults and a shed exemption;
``class_report()`` aggregates latency percentiles per class.

Fairness (multi-tenant): streams are bound to *tenants*
(``submit(..., tenant=...)``) and ``TenantBudget`` gives each tenant a
fair-share token bucket over the virtual clock.  Budgets never
hard-reject — every read is admitted if a slot exists — but the shed
loop and the full-queue eviction pick OUT-OF-BUDGET reads first, so a
flooding tenant's overflow is charged to the flooder (its own newest
reads shed at their own admission) and a within-budget tenant's
admitted set, results and latency trace are untouched by a co-tenant's
flood (tests/test_tenants.py asserts the isolation exactly).
``tenant_report()`` is the audit trail: per-tenant sheds, over-budget
admissions and latency percentiles.  With no budgets configured the
driver is bit-identical to the tenant-free one.

Trace: the driver records a replayable chunk-event trace on its virtual
clock (``self.events``): ``("arrival", t, stream, n)`` at submission,
``("dispatch", t, ci, stage, n_valid, stage_frac)`` when a chunk is
packed, ``("complete", t, ci, n_valid)`` when it routes.  The trace is
the input format of the serving simulator
(``core/sim/serve_sim.replay_chunk_trace``); recording is pure
observation — outputs are byte-identical with or without consumers.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel, driver


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One serving class.  ``priority`` / ``deadline`` are admission
    defaults (``deadline`` is RELATIVE: virtual-time budget from arrival);
    ``sheddable=False`` exempts the class from closed-loop load shedding
    (it can still be rejected by the hard ``max_queue`` bound)."""
    name: str
    priority: int = 0
    deadline: float = math.inf
    sheddable: bool = True

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLO class needs a non-empty name")
        if self.deadline <= 0:
            raise ValueError(f"SLO deadline must be a positive relative "
                             f"budget; got {self.deadline}")


@dataclasses.dataclass(frozen=True)
class TenantBudget:
    """Per-tenant fair-share admission budget: a token bucket over the
    serving driver's VIRTUAL clock.  ``rate`` is the tenant's fair share
    (reads per virtual-time unit refilled into the bucket); ``burst`` is
    the bucket capacity (defaults to ``rate * shed_window`` at driver
    construction, floored at 1 token).  Every admitted read charges one
    token; a read arriving on an empty bucket is still ADMITTED but
    stamped out-of-budget — the budget never hard-rejects on its own, it
    only steers who the closed-loop shed / full-queue eviction picks
    first.  That makes budgets observation-only until overload: with
    ``shed=False`` and a non-full queue, tenant accounting changes no
    behavior at all."""
    name: str
    rate: float
    burst: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant budget needs a non-empty tenant name")
        if self.rate < 0:
            raise ValueError(f"tenant budget rate must be >= 0 reads per "
                             f"virtual-time unit; got {self.rate}")
        if self.burst is not None and self.burst <= 0:
            raise ValueError(f"tenant budget burst must be > 0 tokens; "
                             f"got {self.burst}")


@dataclasses.dataclass
class _Slot:
    """One admitted read waiting for (or climbing) the stage ladder."""
    stream: str
    idx: int                  # read index within its stream
    signal: np.ndarray        # full-length (S,) f32
    t_arrive: float           # virtual admission time
    priority: int
    deadline: float
    seq: int                  # global admission order (fairness tie-break)
    stage: int = 0            # current prefix-ladder stage
    slo: Optional[str] = None # SLO class name (None = untagged)
    sheddable: bool = True
    tenant: Optional[str] = None  # owning tenant (None = untenanted)
    in_budget: bool = True    # bucket had a token at admission

    def rank(self) -> Tuple:
        """Scheduling rank: smaller is served first."""
        return (-self.priority, self.deadline, self.seq)

    def shed_rank(self) -> Tuple:
        """Shedding rank: SMALLER is shed first — lowest priority, then
        latest deadline, then newest admission."""
        return (self.priority, -self.deadline, -self.seq)


@dataclasses.dataclass
class StreamState:
    """Per-stream result buffers, filled in submission order."""
    t_start: List[int] = dataclasses.field(default_factory=list)
    score: List[float] = dataclasses.field(default_factory=list)
    mapped: List[bool] = dataclasses.field(default_factory=list)
    n_events: List[int] = dataclasses.field(default_factory=list)
    samples_used: List[int] = dataclasses.field(default_factory=list)
    stage_of: List[int] = dataclasses.field(default_factory=list)
    latency: List[float] = dataclasses.field(default_factory=list)
    admitted: List[bool] = dataclasses.field(default_factory=list)
    slo_of: List[Optional[str]] = dataclasses.field(default_factory=list)
    n_rejected: int = 0
    n_done: int = 0
    n_shed: int = 0           # closed-loop shed (subset of n_rejected)
    n_nonfinite: int = 0      # NaN/Inf rows refused at admission (ditto)
    tenant: Optional[str] = None  # owning tenant (bound at first submit)

    def _new_read(self) -> int:
        self.t_start.append(0)
        self.score.append(0.0)
        self.mapped.append(False)
        self.n_events.append(0)
        self.samples_used.append(0)
        self.stage_of.append(-1)
        self.latency.append(math.inf)
        self.admitted.append(True)
        self.slo_of.append(None)
        return len(self.t_start) - 1


@dataclasses.dataclass
class StreamReport:
    """Per-stream serving summary (virtual-time latencies)."""
    n_reads: int
    n_mapped: int
    n_rejected: int
    p50_latency: float
    p99_latency: float
    mean_latency: float
    n_shed: int = 0
    n_nonfinite: int = 0


@dataclasses.dataclass
class ClassReport:
    """Per-SLO-class serving summary, aggregated across streams
    (``name=None`` collects untagged reads)."""
    name: Optional[str]
    n_reads: int
    n_mapped: int
    n_rejected: int
    n_shed: int
    p50_latency: float
    p99_latency: float
    mean_latency: float


@dataclasses.dataclass
class TenantReport:
    """Per-tenant serving summary, aggregated across the tenant's streams
    (``name=None`` collects untenanted streams).  ``n_shed`` counts
    closed-loop sheds charged to the tenant; ``n_over_budget`` counts
    admissions that found the tenant's token bucket empty (a leading
    indicator of who is flooding, whether or not shedding is on)."""
    name: Optional[str]
    n_reads: int
    n_mapped: int
    n_rejected: int
    n_shed: int
    n_over_budget: int
    p50_latency: float
    p99_latency: float
    mean_latency: float


class ServeDriver:
    """Continuous-batching serving front-end over one chunk pipeline.

    ``mapper`` is any object exposing ``cfg`` and ``chunk_fn()`` — a
    ``pipeline.Mapper`` (any registry backend, on the card or on the CPU,
    optionally over a mesh: sharded and partitioned-index plans serve
    identically, every rank driving the same trace) or a lightweight
    stand-in.  With ``early_term=True`` it must
    also expose ``with_cfg`` (Mapper does) so the prefix-ladder
    specializations share the resident index.

    Parameters
    ----------
    chunk:        static rows per device chunk (with a mesh: must divide
                  over its ranks, as in Mapper.map_signals).
    max_queue:    bound on outstanding reads (queued + in flight).
                  Admission beyond it is priority-aware (evict a
                  strictly-worse queued read, else reject) — the
                  backpressure contract.  Ladder re-entry (early_term)
                  never grows past the bound: an unresolved read moves
                  from in-flight back to queued.
    early_term:   run the realtime.py prefix ladder; reads resolving at a
                  short prefix free their slot early.
    prefix_stages: ladder of prefix lengths (last must equal
                  cfg.signal_len). Defaults to realtime's quarters.
    min_score:    early-decision score threshold (non-final stages).
    chunk_cost:   virtual-time cost of a full-length chunk dispatch;
                  stage chunks cost chunk_cost * L / signal_len.
    drop_expired: drop queued reads whose deadline passed at packing
                  time (recorded as rejected; off by default so parity
                  holds for any deadline assignment).
    slo_classes:  ``SLOClass`` definitions reads can be submitted under
                  (per-class priority/deadline defaults + shed exemption
                  + ``class_report()`` accounting).
    shed:         close the loop: while the configured cost model's
                  ``shed_signal`` (trailing offered load + measured
                  queue delays) reports overload, shed the least-worthy
                  sheddable read per admission and (with early_term)
                  pack shortest-prefix chunks first.  Off by default —
                  a shed-free driver is bit-identical to the pre-shed
                  ServeDriver.
    shed_window:  trailing virtual-time window the offered load is
                  measured over.
    cost_model:   the ``core/costmodel.py`` backend the shed controller
                  consults ("analytic" / "sim", or a CostModel
                  instance).
    shed_delay_limit: measured-delay trip point, in chunk services: the
                  signal also fires when the recent mean per-read queue
                  delay at dispatch exceeds this many ``chunk_cost``
                  units (catching capacity loss offered load misses).
    tenant_budgets: ``TenantBudget`` fair-share definitions.  Streams are
                  bound to a tenant at ``submit(..., tenant=...)``; every
                  admitted read charges one token from its tenant's
                  bucket (refilled at ``rate`` over the virtual clock, up
                  to ``burst``).  Budgets never hard-reject: they steer
                  victim selection — the closed-loop shed and the
                  full-queue eviction pick OUT-OF-BUDGET reads first, so
                  a flooding tenant's overflow is charged to the flooder
                  and a within-budget tenant's traffic is isolated.  With
                  no budgets configured (the default) tenant tags are
                  observation-only and the driver is bit-identical to the
                  tenant-free one.
    """

    def __init__(self, mapper, chunk: int = 64, max_queue: int = 4096,
                 early_term: bool = False,
                 prefix_stages: Optional[Sequence[int]] = None,
                 min_score: float = 8.0, chunk_cost: float = 1.0,
                 drop_expired: bool = False,
                 slo_classes: Optional[Sequence[SLOClass]] = None,
                 shed: bool = False, shed_window: float = 8.0,
                 cost_model="analytic",
                 shed_delay_limit: float = costmodel.SHED_DELAY_LIMIT,
                 tenant_budgets: Optional[Sequence[TenantBudget]] = None):
        self.mapper = mapper
        self.cfg = mapper.cfg
        self.chunk = int(chunk)
        self.max_queue = int(max_queue)
        self.early_term = bool(early_term)
        self.min_score = float(min_score)
        self.chunk_cost = float(chunk_cost)
        self.drop_expired = bool(drop_expired)
        self.slo_classes: Dict[str, SLOClass] = {
            c.name: c for c in (slo_classes or ())}
        self.shed = bool(shed)
        if shed_window <= 0:
            raise ValueError(f"shed_window must be > 0 virtual time units; "
                             f"got {shed_window}")
        self.shed_window = float(shed_window)
        self.cost_model = costmodel.get_model(cost_model)
        if shed_delay_limit <= 0:
            raise ValueError(f"shed_delay_limit must be > 0 chunk services; "
                             f"got {shed_delay_limit}")
        self.shed_delay_limit = float(shed_delay_limit)
        self.tenant_budgets: Dict[str, TenantBudget] = {
            b.name: b for b in (tenant_budgets or ())}
        # bucket capacity: explicit burst, else one shed_window's worth of
        # the tenant's fair-share rate (>= 1 token so a within-rate tenant
        # can always admit)
        self._tenant_burst: Dict[str, float] = {
            name: (b.burst if b.burst is not None
                   else max(1.0, b.rate * self.shed_window))
            for name, b in self.tenant_budgets.items()}
        # name -> [tokens, last refill virtual time]; buckets start full
        self._tenant_tokens: Dict[str, List[float]] = {
            name: [self._tenant_burst[name], 0.0]
            for name in self.tenant_budgets}
        self._shed_by_tenant: Dict[Optional[str], int] = {}
        self._over_budget: Dict[Optional[str], int] = {}
        # virtual time the tiered storage path loses to page-in
        # retry/backoff is folded into the serving clock as it accrues
        # (zero on the happy path -> parity intact)
        self._cache = getattr(mapper, "cache", None)
        self._vtime_seen = float(getattr(self._cache, "vtime_penalty", 0.0)
                                 or 0.0)

        S = self.cfg.signal_len
        if early_term:
            if prefix_stages is None:
                prefix_stages = tuple(S * k // 4 for k in range(1, 5))
            self.stages = tuple(int(L) for L in prefix_stages)
            if self.stages[-1] != S:
                raise ValueError(f"prefix_stages must end at signal_len="
                                 f"{S}; got {self.stages}")
            from repro_torch.core.realtime import stage_cfg
            self._stage_fns = [mapper.with_cfg(stage_cfg(self.cfg, L)
                                               ).chunk_fn()
                               for L in self.stages]
            self._stage_thresh = [
                (stage_cfg(self.cfg, L).min_chain_score
                 if si == len(self.stages) - 1 else self.min_score)
                for si, L in enumerate(self.stages)]
        else:
            self.stages = (S,)
            self._stage_fns = [mapper.chunk_fn()]
            self._stage_thresh = [self.cfg.min_chain_score]

        self.clock = 0.0
        self.counters: Dict[str, int] = {}
        self.n_chunks = 0
        self.n_pad_rows = 0
        self.n_shed = 0
        self._queue: List[_Slot] = []
        self._streams: Dict[str, StreamState] = {}
        self._arrivals: collections.deque = collections.deque()
        # ci -> (ladder stage, row slots, virtual completion time)
        self._inflight: Dict[int, Tuple[int, List[_Slot], float]] = {}
        self._stage_fifo: collections.deque = collections.deque()
        self._seq = 0
        self._admit_times: collections.deque = collections.deque()
        self._shed_by_class: Dict[Optional[str], int] = {}
        # the replayable chunk-event trace (arrival/dispatch/complete in
        # virtual time) — the serving simulator's input format
        self.events: List[Tuple] = []
        # measured per-read queue delays at dispatch, trailing window —
        # the shed controller's second (capacity-loss) overload signal
        self._queue_delays: collections.deque = collections.deque(maxlen=64)

    # ------------------------------------------------------------------ #
    # Admission (bounded queue, priority-aware backpressure)
    # ------------------------------------------------------------------ #
    def stream(self, stream_id: str) -> StreamState:
        return self._streams.setdefault(stream_id, StreamState())

    def _bucket_refill(self, tenant: str, t: float) -> List[float]:
        """Refill a tenant's token bucket up to virtual time ``t``."""
        b = self.tenant_budgets[tenant]
        s = self._tenant_tokens[tenant]
        s[0] = min(self._tenant_burst[tenant],
                   s[0] + b.rate * max(0.0, t - s[1]))
        s[1] = max(s[1], t)
        return s

    def _charge_tenant(self, tenant: Optional[str], t: float) -> bool:
        """Charge one admission token.  True = the read is in budget.
        Tenants without a configured budget (and untenanted reads) are
        always in budget — the legacy behavior."""
        if tenant is None or tenant not in self.tenant_budgets:
            return True
        s = self._bucket_refill(tenant, t)
        if s[0] >= 1.0:
            s[0] -= 1.0
            return True
        self._over_budget[tenant] = self._over_budget.get(tenant, 0) + 1
        return False

    def _tenant_over(self, tenant: Optional[str]) -> bool:
        """Live (no-charge) check: is the tenant's bucket empty NOW?"""
        if tenant is None or tenant not in self.tenant_budgets:
            return False
        return self._bucket_refill(tenant, self.clock)[0] < 1.0

    def tenant_tokens(self, tenant: str) -> float:
        """The tenant's remaining budget tokens at the current clock."""
        return self._bucket_refill(tenant, self.clock)[0]

    def submit(self, stream_id: str, signals: np.ndarray,
               priority: Optional[int] = None,
               deadline: Optional[float] = None,
               t: Optional[float] = None,
               slo: Optional[str] = None,
               tenant: Optional[str] = None) -> int:
        """Admit a batch of reads for ``stream_id``.  Returns the number
        admitted; the rest were rejected (or evicted a worse read whose
        stream records the rejection).  ``t`` stamps the virtual arrival
        time (defaults to the current clock; never rewinds it).

        ``slo`` names a registered ``SLOClass`` supplying priority /
        deadline defaults (its deadline is a RELATIVE budget from ``t``)
        and the shed exemption; explicit ``priority`` / ``deadline``
        override the class.  ``tenant`` binds the stream to a tenant (a
        stream keeps its first-bound tenant; re-binding to a different
        one is an error) and, when a ``TenantBudget`` is configured for
        it, charges one token per read from the tenant's bucket —
        out-of-budget reads are still admitted but are first in line for
        the closed-loop shed and the full-queue eviction (fair-share
        isolation; see ``tenant_budgets`` in the class docstring).  Rows
        containing NaN/Inf are refused at admission (counted per stream
        as ``n_nonfinite``, recorded as rejected) — they would otherwise
        poison every chunk-mate's counters inside ``map_chunk``."""
        signals = np.asarray(signals, np.float32)
        if signals.ndim == 1:
            signals = signals[None]
        if signals.shape[1] != self.cfg.signal_len:
            raise ValueError(f"signals must be (n, {self.cfg.signal_len}); "
                             f"got {signals.shape}")
        cls = None
        if slo is not None:
            cls = self.slo_classes.get(slo)
            if cls is None:
                raise ValueError(f"unknown SLO class {slo!r}; registered: "
                                 f"{sorted(self.slo_classes)}")
        t = self.clock if t is None else float(t)
        self.clock = max(self.clock, t)
        self.events.append(("arrival", t, stream_id, int(signals.shape[0])))
        prio = int(priority) if priority is not None else (
            cls.priority if cls else 0)
        dl = float(deadline) if deadline is not None else (
            t + cls.deadline if cls else math.inf)
        st = self.stream(stream_id)
        if tenant is not None:
            if st.tenant is not None and st.tenant != tenant:
                raise ValueError(
                    f"stream {stream_id!r} already belongs to tenant "
                    f"{st.tenant!r}; cannot re-bind it to {tenant!r}")
            st.tenant = tenant
        tenant = st.tenant
        finite = np.isfinite(signals).all(axis=1)
        admitted = 0
        for row, ok in zip(signals, finite):
            idx = st._new_read()
            st.slo_of[idx] = slo
            if not ok:
                st.n_nonfinite += 1
                st.admitted[idx] = False
                st.n_rejected += 1
                st.n_done += 1
                continue
            self._admit_times.append(t)
            slot = _Slot(stream=stream_id, idx=idx, signal=row, t_arrive=t,
                         priority=prio, deadline=dl, seq=self._seq, slo=slo,
                         sheddable=cls.sheddable if cls else True,
                         tenant=tenant,
                         in_budget=self._charge_tenant(tenant, self.clock))
            self._seq += 1
            if self._admit(slot):
                admitted += 1
        return admitted

    def _outstanding(self) -> int:
        """Reads holding a slot: queued + in flight.  The max_queue bound
        applies to this total, so ladder re-entry of an in-flight read
        (early_term) moves it back to the queue without ever growing past
        the bound."""
        return len(self._queue) + sum(len(slots) for _, slots, _t
                                      in self._inflight.values())

    def _saturated(self) -> bool:
        """The closed loop's overload signal, via the cost model's
        ``shed_signal``: trailing offered load (reads per virtual time
        over ``shed_window``, the queueing model's no-steady-state check)
        OR the measured recent per-read queue delays at dispatch tripping
        ``shed_delay_limit`` chunk services — the latter catches
        effective-capacity loss (storage retry/backoff stretching the
        clock) that offered load alone cannot see."""
        horizon = self.clock - self.shed_window
        while self._admit_times and self._admit_times[0] < horizon:
            self._admit_times.popleft()
        if not self._admit_times and not self._queue_delays:
            return False
        load = len(self._admit_times) / self.shed_window
        return bool(self.cost_model.shed_signal(
            self.chunk, self.chunk_cost, load,
            tuple(self._queue_delays),
            delay_limit=self.shed_delay_limit))

    def _admit(self, slot: _Slot) -> bool:
        if self.shed and self._saturated():
            # shed the least-worthy sheddable read: OUT-OF-BUDGET tenants
            # first (the fair-share rule — with no budgets configured
            # every read is in budget and the key degenerates to the
            # legacy shed_rank), then lowest priority, then latest
            # deadline, then newest — the new read itself when it is the
            # least worthy.  SLO shed exemption always wins: an
            # unsheddable read is never a candidate, budget or not.
            cands = [s for s in self._queue if s.sheddable]
            if slot.sheddable:
                cands.append(slot)
            if not slot.in_budget:
                # an over-budget arrival may only displace its own
                # tenant's traffic: the overload it causes is charged to
                # it, never to a within-budget co-tenant (if the tenant
                # has nothing sheddable queued, nothing is shed)
                cands = [s for s in cands if s.tenant == slot.tenant]
            if cands:
                victim = min(cands, key=lambda s: (s.in_budget,
                                                   s.shed_rank()))
                if victim is slot:
                    self._shed(slot)
                    return False
                self._queue.remove(victim)
                self._shed(victim)
        if self._outstanding() < self.max_queue:
            self._queue.append(slot)
            return True
        if self.tenant_budgets and slot.in_budget:
            # full queue, in-budget arrival: a tenant over its fair share
            # RIGHT NOW cannot hold slots against a within-budget tenant
            # — evict the least-worthy such read (charged as a shed to
            # its own tenant), never an unsheddable one
            over = [s for s in self._queue if s.sheddable
                    and (not s.in_budget or self._tenant_over(s.tenant))]
            if over:
                victim = min(over, key=lambda s: (s.in_budget,
                                                  s.shed_rank()))
                self._queue.remove(victim)
                self._shed(victim)
                self._queue.append(slot)
                return True
        if self._queue:
            worst = max(self._queue, key=lambda s: s.rank())
            if slot.rank() < worst.rank():
                self._queue.remove(worst)
                self._reject(worst)
                self._queue.append(slot)
                return True
        self._reject(slot)
        return False

    def _shed(self, slot: _Slot) -> None:
        self.n_shed += 1
        self._streams[slot.stream].n_shed += 1
        self._shed_by_class[slot.slo] = \
            self._shed_by_class.get(slot.slo, 0) + 1
        self._shed_by_tenant[slot.tenant] = \
            self._shed_by_tenant.get(slot.tenant, 0) + 1
        self._reject(slot)

    def _reject(self, slot: _Slot) -> None:
        st = self._streams[slot.stream]
        st.admitted[slot.idx] = False
        st.n_rejected += 1
        st.n_done += 1

    # ------------------------------------------------------------------ #
    # Packing + the ONE double-buffered loop
    # ------------------------------------------------------------------ #
    def _admit_due(self) -> None:
        while self._arrivals and self._arrivals[0][0] <= self.clock:
            t, stream_id, signals, priority, deadline, slo, tenant = \
                self._arrivals.popleft()
            self.submit(stream_id, signals, priority=priority,
                        deadline=deadline, t=t, slo=slo, tenant=tenant)

    def _next_chunk(self) -> Optional[driver.Chunk]:
        self._admit_due()
        if self.drop_expired:
            expired = [s for s in self._queue if s.deadline < self.clock]
            for s in expired:
                self._queue.remove(s)
                self._reject(s)
        if not self._queue:
            return None
        self._queue.sort(key=_Slot.rank)
        stage = self._queue[0].stage
        if (self.shed and self.early_term and len(self.stages) > 1
                and self._saturated()):
            # early-term-first degradation: under overload pack the
            # SHORTEST prefix stage present — the cheapest chunk, with the
            # best odds of resolving reads early and freeing slots
            stage = min(s.stage for s in self._queue)
        take, rest = [], []
        for s in self._queue:
            (take if (s.stage == stage and len(take) < self.chunk)
             else rest).append(s)
        self._queue = rest
        L = self.stages[stage]
        part = np.stack([s.signal[:L] for s in take])
        ci = self.n_chunks
        self.n_chunks += 1
        self.n_pad_rows += self.chunk - len(take)
        # measured queue delay: how long each packed read waited between
        # admission and this dispatch (pre-advance clock) — the shed
        # controller's capacity-loss evidence
        for s in take:
            self._queue_delays.append(self.clock - s.t_arrive)
        self.events.append(("dispatch", self.clock, ci, stage, len(take),
                            L / self.stages[-1]))
        self.clock += self.chunk_cost * L / self.stages[-1]
        # completion time is fixed at dispatch: stream_map's double buffer
        # routes chunk i only after pulling chunk i+1, so reading the live
        # clock at routing time would overcharge every chunk but the last
        self._inflight[ci] = (stage, take, self.clock)
        self._stage_fifo.append(stage)
        return ci, len(take), driver.pad_rows(part, self.chunk)

    def _chunk_source(self) -> Iterable[driver.Chunk]:
        while True:
            c = self._next_chunk()
            if c is None:
                return
            yield c

    def _map_fn(self, signals, n_valid):
        # stream_map dispatches each chunk right after pulling it from the
        # source, so the FIFO of stage ids pushed by _next_chunk is in
        # dispatch order.
        out = self._stage_fns[self._stage_fifo.popleft()](signals, n_valid)
        if self._cache is not None:
            # charge storage-path retry/backoff virtual time (accrued
            # paging this chunk's tiles) to the serving clock; zero on the
            # happy path
            pen = float(self._cache.vtime_penalty)
            if pen > self._vtime_seen:
                self.clock += pen - self._vtime_seen
                self._vtime_seen = pen
        return out

    def _route(self, ci: int, n_valid: int, out) -> None:
        stage, slots, done_t = self._inflight.pop(ci)
        assert n_valid == len(slots), (ci, n_valid, len(slots))
        self.events.append(("complete", done_t, ci, n_valid))
        for k, v in out.counters.items():
            self.counters[k] = self.counters.get(k, 0) + int(v)
        last = stage == len(self.stages) - 1
        thresh = self._stage_thresh[stage]
        L = self.stages[stage]
        t = np.asarray(out.t_start)
        s = np.asarray(out.score)
        m = np.asarray(out.mapped)
        ne = np.asarray(out.n_events)
        for i, slot in enumerate(slots):
            st = self._streams[slot.stream]
            if not self.early_term:
                # batch semantics: record the full chunk outputs verbatim
                # (bit-parity with Mapper.map_signals, mapped or not)
                st.t_start[slot.idx] = int(t[i])
                st.score[slot.idx] = float(s[i])
                st.mapped[slot.idx] = bool(m[i])
                st.n_events[slot.idx] = int(ne[i])
                st.samples_used[slot.idx] = L
                st.stage_of[slot.idx] = stage
                st.latency[slot.idx] = done_t - slot.t_arrive
                st.n_done += 1
                continue
            # realtime.map_realtime decision rule, bit for bit
            decide = (bool(m[i]) and float(s[i]) >= thresh) if not last \
                else bool(m[i])
            if decide:
                st.t_start[slot.idx] = int(t[i])
                st.score[slot.idx] = float(s[i])
                st.mapped[slot.idx] = True
                st.n_events[slot.idx] = int(ne[i])
                st.samples_used[slot.idx] = L
                st.stage_of[slot.idx] = stage
                st.latency[slot.idx] = done_t - slot.t_arrive
                st.n_done += 1
            elif last:
                # unresolved at full length: zeros, like map_realtime
                st.samples_used[slot.idx] = L
                st.stage_of[slot.idx] = -1
                st.latency[slot.idx] = done_t - slot.t_arrive
                st.n_done += 1
            else:
                slot.stage = stage + 1
                self._queue.append(slot)   # keeps seq -> no starvation

    # ------------------------------------------------------------------ #
    # Draining
    # ------------------------------------------------------------------ #
    def _pending(self) -> bool:
        return bool(self._queue or self._inflight or self._arrivals)

    def drain(self) -> None:
        """Serve until every admitted read (and queued arrival) resolves.

        One ``driver.stream_map`` invocation runs as long as the ready
        queue can keep the double buffer full; reads advancing the ladder
        out of an in-flight chunk re-enter in time for the next pull.
        The loop restarts only when the queue momentarily drains with
        work still in flight (a wave boundary)."""
        while self._pending():
            if not self._queue and not self._inflight and self._arrivals:
                self.clock = max(self.clock, self._arrivals[0][0])
                self._admit_due()
                continue
            for ci, n_valid, out in driver.stream_map(self._map_fn,
                                                      self._chunk_source()):
                self._route(ci, n_valid, out)

    def serve_trace(self, trace: Iterable[Tuple]) -> Dict[str, StreamReport]:
        """Run an arrival trace to completion.

        ``trace`` rows are ``(t, stream_id, signals[, priority[,
        deadline[, slo[, tenant]]]])`` in virtual-time units; rows need
        not be sorted.  ``priority`` / ``deadline`` may be None to take
        the SLO class defaults; ``tenant`` binds the stream's tenant
        (see ``submit``).  Returns the per-stream reports
        (``report()``)."""
        rows = []
        for row in trace:
            t, stream_id, signals = row[0], row[1], row[2]
            priority = row[3] if len(row) > 3 else None
            deadline = row[4] if len(row) > 4 else None
            slo = row[5] if len(row) > 5 else None
            tenant = row[6] if len(row) > 6 else None
            rows.append((float(t), str(stream_id),
                         np.asarray(signals, np.float32),
                         None if priority is None else int(priority),
                         None if deadline is None else float(deadline),
                         None if slo is None else str(slo),
                         None if tenant is None else str(tenant)))
        rows.sort(key=lambda r: r[0])
        self._arrivals.extend(rows)
        self.drain()
        return self.report()

    # ------------------------------------------------------------------ #
    # Results
    # ------------------------------------------------------------------ #
    def results(self, stream_id: str):
        """Per-read results for one stream, in submission order, as a
        ``pipeline.MapOutput`` (plus the serving extras on the stream
        state).  Rejected reads read as unmapped zeros with
        ``admitted[i] == False``.  ``counters`` is empty: chunks mix
        streams, so exact per-stream counter splits do not exist — the
        serving-wide totals live on ``self.counters``."""
        from repro_torch.core.pipeline import MapOutput
        st = self._streams[stream_id]
        return MapOutput(
            t_start=np.asarray(st.t_start, np.int64),
            score=np.asarray(st.score, np.float32),
            mapped=np.asarray(st.mapped, bool),
            n_events=np.asarray(st.n_events, np.int32),
            counters={})

    def stream_ids(self) -> Tuple[str, ...]:
        return tuple(self._streams)

    def report(self) -> Dict[str, StreamReport]:
        out = {}
        for sid, st in self._streams.items():
            lat = np.asarray([l for l, a in zip(st.latency, st.admitted)
                              if a and math.isfinite(l)], np.float64)
            out[sid] = StreamReport(
                n_reads=len(st.latency), n_mapped=int(sum(st.mapped)),
                n_rejected=st.n_rejected,
                p50_latency=float(np.percentile(lat, 50)) if lat.size else math.nan,
                p99_latency=float(np.percentile(lat, 99)) if lat.size else math.nan,
                mean_latency=float(lat.mean()) if lat.size else math.nan,
                n_shed=st.n_shed, n_nonfinite=st.n_nonfinite)
        return out

    def class_report(self) -> Dict[Optional[str], ClassReport]:
        """Per-SLO-class latency accounting aggregated across streams.
        Keyed by class name (None = reads submitted without a class)."""
        acc: Dict[Optional[str], Dict] = {}

        def bucket(name):
            return acc.setdefault(name, dict(n_reads=0, n_mapped=0,
                                             n_rejected=0, lat=[]))
        for st in self._streams.values():
            for i, name in enumerate(st.slo_of):
                b = bucket(name)
                b["n_reads"] += 1
                b["n_mapped"] += bool(st.mapped[i])
                if not st.admitted[i]:
                    b["n_rejected"] += 1
                elif math.isfinite(st.latency[i]):
                    b["lat"].append(st.latency[i])
        for name in self._shed_by_class:
            bucket(name)
        out = {}
        for name, b in acc.items():
            lat = np.asarray(b["lat"], np.float64)
            out[name] = ClassReport(
                name=name, n_reads=b["n_reads"], n_mapped=b["n_mapped"],
                n_rejected=b["n_rejected"],
                n_shed=self._shed_by_class.get(name, 0),
                p50_latency=float(np.percentile(lat, 50)) if lat.size else math.nan,
                p99_latency=float(np.percentile(lat, 99)) if lat.size else math.nan,
                mean_latency=float(lat.mean()) if lat.size else math.nan)
        return out

    def tenant_report(self) -> Dict[Optional[str], TenantReport]:
        """Per-tenant fair-share accounting aggregated across each
        tenant's streams.  Keyed by tenant name (None = streams submitted
        without a tenant).  The shed and over-budget columns are the
        fairness audit trail: under a one-tenant flood with budgets
        configured, every shed lands in the flooder's row."""
        acc: Dict[Optional[str], Dict] = {}

        def bucket(name):
            return acc.setdefault(name, dict(n_reads=0, n_mapped=0,
                                             n_rejected=0, lat=[]))
        for st in self._streams.values():
            b = bucket(st.tenant)
            b["n_reads"] += len(st.latency)
            b["n_mapped"] += int(sum(st.mapped))
            b["n_rejected"] += st.n_rejected
            b["lat"].extend(l for l, a in zip(st.latency, st.admitted)
                            if a and math.isfinite(l))
        for name in self._shed_by_tenant:
            bucket(name)
        for name in self._over_budget:
            bucket(name)
        out = {}
        for name, b in acc.items():
            lat = np.asarray(b["lat"], np.float64)
            out[name] = TenantReport(
                name=name, n_reads=b["n_reads"], n_mapped=b["n_mapped"],
                n_rejected=b["n_rejected"],
                n_shed=self._shed_by_tenant.get(name, 0),
                n_over_budget=self._over_budget.get(name, 0),
                p50_latency=float(np.percentile(lat, 50)) if lat.size else math.nan,
                p99_latency=float(np.percentile(lat, 99)) if lat.size else math.nan,
                mean_latency=float(lat.mean()) if lat.size else math.nan)
        return out
