"""Virtual-time serving simulators: ServeDriver trace replay + queues.

``core/server.ServeDriver`` records a replayable chunk-event trace on
its virtual clock (``ServeDriver.events``):

    ("arrival",  t, stream_id, n_reads)
    ("dispatch", t, chunk_idx, stage, n_valid, stage_frac)
    ("complete", t, chunk_idx, n_valid)

``replay_chunk_trace`` re-runs the dispatch/complete timeline of such a
trace through the virtual-clock dispatch law (every dispatched chunk
advances the clock by ``chunk_cost * stage_frac``; its completion time
is fixed at dispatch) and checks the recorded completions reproduce
exactly — the trace IS sufficient input for the simulator, which is what
lets recorded serving runs be re-analyzed offline.

``simulate_serving_virtual`` / ``simulate_serving`` are the event-driven
twins of the two analytic queueing wrappers in ``ssd_model``: instead of
the Erlang-C closed form they run seeded Poisson arrivals through the
actual service discipline (a greedy batch server of ``chunk`` reads per
``chunk_cost``, or c = n_serving drive servers) and report measured
sojourn percentiles.  Deterministic given the seed.

The JAX package's ``repro.core.sim.serve_sim``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.core import ssd_model
from repro_torch.core.workload import Workload


# --------------------------------------------------------------------------- #
# ServeDriver chunk-event trace replay
# --------------------------------------------------------------------------- #
def replay_chunk_trace(events: Iterable[Tuple], chunk_cost: float = 1.0
                       ) -> Dict[str, object]:
    """Replay a ``ServeDriver.events`` trace in virtual time.

    Recomputes every chunk's completion time from its dispatch record
    (``complete = dispatch_t + chunk_cost * stage_frac``) and compares it
    against the recorded completion.  Returns per-chunk rows, the
    dispatcher's busy fraction over the trace makespan, and
    ``max_drift`` — the largest |replayed - recorded| completion gap
    (0.0 exactly for traces recorded on the clean virtual-clock path;
    storage-path retry/backoff penalties shift later DISPATCHES, never a
    chunk's own dispatch->complete span, so replay stays exact there
    too).
    """
    dispatches: Dict[int, Tuple[float, float]] = {}
    recorded: Dict[int, float] = {}
    arrivals: List[Tuple[float, str, int]] = []
    for ev in events:
        kind = ev[0]
        if kind == "dispatch":
            _, t, ci, _stage, _n_valid, frac = ev
            dispatches[ci] = (float(t), float(frac))
        elif kind == "complete":
            _, t, ci = ev[0], ev[1], ev[2]
            recorded[ci] = float(t)
        elif kind == "arrival":
            arrivals.append((float(ev[1]), ev[2], int(ev[3])))
    rows = []
    max_drift = 0.0
    busy = 0.0
    makespan = 0.0
    for ci in sorted(dispatches):
        t_disp, frac = dispatches[ci]
        replayed = t_disp + chunk_cost * frac
        rec = recorded.get(ci)
        drift = abs(replayed - rec) if rec is not None else math.inf
        max_drift = max(max_drift, drift)
        busy += chunk_cost * frac
        makespan = max(makespan, replayed,
                       rec if rec is not None else 0.0)
        rows.append(dict(chunk=ci, dispatch=t_disp, frac=frac,
                         replayed_complete=replayed, recorded_complete=rec,
                         drift=drift))
    return dict(chunks=rows, n_chunks=len(rows), n_arrival_events=len(arrivals),
                n_reads_arrived=sum(n for _, _, n in arrivals),
                makespan=makespan, max_drift=max_drift,
                dispatch_busy=(busy / makespan) if makespan > 0 else 0.0)


# --------------------------------------------------------------------------- #
# Event-driven queueing twins
# --------------------------------------------------------------------------- #
def _percentile_out(sojourns: np.ndarray, service: float, c: int,
                    offered_load: float,
                    percentiles: Sequence[float]) -> Dict[str, float]:
    out = dict(service=service, n_servers=int(c),
               offered_load=float(offered_load),
               utilization=offered_load * service / c, saturated=False,
               mean=float(sojourns.mean()),
               wait_prob=float(np.mean(sojourns > service + 1e-12)))
    for q in percentiles:
        out[f"p{q:g}"] = float(np.percentile(sojourns, q))
    return out


def _saturated_out(service: float, c: int, offered_load: float,
                   percentiles: Sequence[float]) -> Dict[str, float]:
    out = dict(service=service, n_servers=int(c),
               offered_load=float(offered_load),
               utilization=offered_load * service / c, saturated=True,
               mean=math.inf, wait_prob=1.0)
    out.update({f"p{q:g}": math.inf for q in percentiles})
    return out


def simulate_serving_virtual(chunk: int, offered_load: float,
                             chunk_cost: float = 1.0,
                             percentiles: Sequence[float] = (50.0, 99.0),
                             n_reads: int = 20_000, seed: int = 0
                             ) -> Dict[str, float]:
    """Event-driven twin of ``ssd_model.serving_latency_virtual``: the
    greedy virtual-clock batch server (one chunk of up to ``chunk`` queued
    reads per ``chunk_cost``) under seeded Poisson arrivals.  Matches the
    analytic contract: ValueError on non-positive load, inf percentiles
    at/beyond saturation (rho = load * chunk_cost / chunk >= 1)."""
    if offered_load <= 0:
        raise ValueError(f"offered_load must be > 0; got {offered_load}")
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")
    rho = offered_load * chunk_cost / chunk
    if rho >= 1.0:
        out = _saturated_out(chunk_cost, chunk, offered_load, percentiles)
        out.update(chunk=chunk, chunk_cost=chunk_cost)
        return out
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / offered_load, int(n_reads)))
    sojourns = np.empty(int(n_reads))
    free_at = 0.0
    i = 0
    n = int(n_reads)
    while i < n:
        start = max(free_at, arr[i])
        j = i + 1                          # greedy: everyone queued rides
        while j < n and j - i < chunk and arr[j] <= start:
            j += 1
        done = start + chunk_cost
        sojourns[i:j] = done - arr[i:j]
        free_at = done
        i = j
    out = _percentile_out(sojourns, chunk_cost, chunk, offered_load,
                          percentiles)
    out.update(chunk=chunk, chunk_cost=chunk_cost, n_reads=n, seed=seed)
    return out


def simulate_serving(w: Workload, offered_load: float,
                     arr: ssd_model.SSDArrayConfig = ssd_model.SSDArrayConfig(),
                     percentiles: Sequence[float] = (50.0, 99.0),
                     n_reads: int = 20_000, seed: int = 0
                     ) -> Dict[str, float]:
    """Event-driven twin of ``ssd_model.serving_latency``: c = serving
    drives, each a deterministic server at the per-read amortized batch
    service of its index share, under seeded Poisson arrivals."""
    if offered_load <= 0:
        raise ValueError(f"offered_load must be > 0; got {offered_load}")
    batch = ssd_model.mars_array_latency(w, arr)
    service = batch["total"] / max(w.n_reads, 1) * arr.n_serving
    c = arr.n_serving
    rho = offered_load * service / c
    if rho >= 1.0:
        out = _saturated_out(service, c, offered_load, percentiles)
        out["n_ssds"] = c
        return out
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / offered_load, int(n_reads)))
    free_at = np.zeros(c)
    sojourns = np.empty(int(n_reads))
    for k, t in enumerate(arrivals):
        s = int(np.argmin(free_at))        # first server to free up
        start = max(free_at[s], t)
        free_at[s] = start + service
        sojourns[k] = free_at[s] - t
    out = _percentile_out(sojourns, service, c, offered_load, percentiles)
    out.update(n_ssds=c, n_reads=int(n_reads), seed=seed)
    return out
