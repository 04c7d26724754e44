"""Deterministic discrete-event core: event heap + stat-keeping components.

The heap orders events by (time, schedule sequence), so simultaneous
events fire in schedule order and a run is a pure function of its inputs
— the determinism contract tests/test_sim.py pins (same trace + seed ->
identical event log).

``Component`` is the one resource abstraction: ``n_servers`` identical
servers over a FIFO queue.  Every component keeps the same stats dict
(busy_time / queue_delay / n_tasks / work), the per-component
decomposition idiom of accelerator simulators — idle time and
utilization derive from the makespan at report time (``stats_table``),
so "where did the time go" is answerable per flash channel, per die, per
PNM unit and for the DRAM/host links from one table.

The JAX package's ``repro.core.sim.engine``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple


class Simulator:
    """Event heap with a deterministic total order and an event log."""

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = 0
        self.event_log: List[Tuple[float, str, str, object]] = []
        self.n_events = 0

    def schedule(self, t: float, fn: Callable, *args) -> None:
        if t < self.now:
            raise ValueError(f"cannot schedule into the past: {t} < {self.now}")
        heapq.heappush(self._heap, (float(t), self._seq, fn, args))
        self._seq += 1

    def log(self, component: str, kind: str, tag=None) -> None:
        self.event_log.append((self.now, component, kind, tag))

    def run(self) -> float:
        """Drain the heap; returns the final clock (the makespan)."""
        while self._heap:
            t, _, fn, args = heapq.heappop(self._heap)
            self.now = t
            self.n_events += 1
            fn(*args)
        return self.now


@dataclasses.dataclass
class _Task:
    duration: float
    done: Optional[Callable]
    tag: object
    t_enqueue: float
    work: float


class Component:
    """``n_servers`` identical servers over one FIFO queue.

    ``submit(duration=..)`` (or ``work=..`` against a ``rate``) enqueues a
    task; it starts as soon as a server frees, in FIFO order, and ``done``
    fires at completion.  Stats accumulate on the component:

        busy_time    total server-seconds spent serving
        queue_delay  total time tasks waited between enqueue and start
        n_tasks      tasks served
        work         total work units (bytes / ops) pushed through

    ``t_last`` is the component's last completion (its local makespan).
    """

    def __init__(self, sim: Simulator, name: str, n_servers: int = 1,
                 rate: Optional[float] = None) -> None:
        if n_servers < 1:
            raise ValueError(f"{name}: n_servers must be >= 1; got {n_servers}")
        self.sim = sim
        self.name = name
        self.n_servers = int(n_servers)
        self.rate = rate
        self._busy = 0
        self._fifo: List[_Task] = []
        self.t_last = 0.0
        self.stats: Dict[str, float] = dict(
            busy_time=0.0, queue_delay=0.0, n_tasks=0, work=0.0)

    def submit(self, duration: Optional[float] = None,
               work: Optional[float] = None,
               done: Optional[Callable] = None, tag=None) -> None:
        if duration is None:
            if work is None or self.rate is None:
                raise ValueError(f"{self.name}: submit needs duration, or "
                                 f"work with a configured rate")
            duration = work / self.rate
        if duration < 0:
            raise ValueError(f"{self.name}: negative duration {duration}")
        t = _Task(float(duration), done, tag, self.sim.now,
                  float(work if work is not None else 0.0))
        self._fifo.append(t)
        self.sim.log(self.name, "enqueue", tag)
        self._try_start()

    def _try_start(self) -> None:
        while self._fifo and self._busy < self.n_servers:
            task = self._fifo.pop(0)
            self._busy += 1
            self.stats["queue_delay"] += self.sim.now - task.t_enqueue
            self.stats["n_tasks"] += 1
            self.stats["work"] += task.work
            self.sim.log(self.name, "start", task.tag)
            self.sim.schedule(self.sim.now + task.duration,
                              self._finish, task)

    def _finish(self, task: _Task) -> None:
        self._busy -= 1
        self.stats["busy_time"] += task.duration
        self.t_last = max(self.t_last, self.sim.now)
        self.sim.log(self.name, "done", task.tag)
        if task.done is not None:
            task.done()
        self._try_start()


def stats_table(components: List[Component],
                makespan: float) -> Dict[str, Dict[str, float]]:
    """Per-component busy/idle/queue-delay/utilization decomposition over
    the run's makespan (server-seconds; utilization is busy fraction of
    the component's aggregate server capacity)."""
    out = {}
    for c in components:
        cap = c.n_servers * makespan
        busy = c.stats["busy_time"]
        out[c.name] = dict(
            busy_time=busy,
            idle_time=max(0.0, cap - busy),
            queue_delay=c.stats["queue_delay"],
            n_tasks=int(c.stats["n_tasks"]),
            work=c.stats["work"],
            utilization=(busy / cap) if cap > 0 else 0.0)
    return out
