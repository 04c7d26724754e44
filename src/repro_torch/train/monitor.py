"""Step-time monitoring: straggler detection + throughput accounting.

At 1000+ node scale, slow hosts (failing NICs, thermal throttling,
preemption warnings) surface as step-time outliers long before they surface
as errors.  The monitor keeps an EMA of step time; a step slower than
`threshold` x EMA raises a straggler event, which the launcher logs and —
on real deployments — feeds the scheduler (drain + replace the host; with
our elastic checkpoints a replacement joins at the next restore).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ema: float
    ratio: float


class StepMonitor:
    def __init__(self, ema_alpha: float = 0.2, threshold: float = 2.0,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable] = None):
        self.ema_alpha = ema_alpha
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self.ema: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self.history: List[float] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self._step += 1
        self.history.append(dt)
        if self._step <= self.warmup_steps:
            return dt                         # ignore compile steps
        if self.ema is None:
            self.ema = dt
            return dt
        if dt > self.threshold * self.ema:
            ev = StragglerEvent(step=self._step, step_time=dt, ema=self.ema,
                                ratio=dt / self.ema)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
        self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
        return dt

    def tokens_per_sec(self, tokens_per_step: int) -> float:
        if self.ema is None:
            return 0.0
        return tokens_per_step / self.ema
