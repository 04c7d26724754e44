"""The traced run's profiler trace, reduced to what the per-layer metrics
and the breakdown read.

From ``torch.profiler`` (CPU and CUDA activities) over the window:

* device operations: every event on the card (kernels, copies, memsets),
  their count, and seconds by name;
* busy seconds: the union of the device operations' intervals (a sum of
  every op's time would count overlapping ops twice);
* idle gaps: the stretches of the window with nothing on the card, each
  labelled by what the host was doing at its middle: the innermost of the
  harness's own spans (``traffic.Spans``) and the innermost CPU op or CUDA
  runtime call (the harness drives the card from one thread).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")   # kineto's categories
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def _kind(e, span_names) -> str:
    """The event's kineto category; torch builds without
    ``activity_type`` tell the card's operations by their device (less
    the card-side copies of the harness's spans and synchronisation
    records)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    if str(e.device_type()).split(".")[-1] == "CUDA":
        if name in span_names or "Sync" in name:
            return "other"
        return "kernel"
    return "user_annotation" if name in span_names else "cpu_op"


def reduce(events, span_names) -> Optional[Dict]:
    """``events``: the profiler's kineto events.  Returns None where the
    trace holds no device operation."""
    dev: List[tuple] = []
    spans: List[tuple] = []
    cpu: List[tuple] = []
    by_name: Dict[str, List[float]] = {}
    for e in events:
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        name = e.name()
        kind = _kind(e, span_names)
        if kind in DEVICE_OPS:
            dev.append((t0, t1))
            row = by_name.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += (t1 - t0) / 1e9
        elif kind == "user_annotation" and name in span_names:
            spans.append((t0, t1, name))
        elif kind in HOST_OPS:
            cpu.append((t0, t1, name))
    if not dev:
        return None
    window = next((s for s in spans if s[2] == "window"), None)
    lo, hi = ((window[0], window[1]) if window is not None
              else (min(d[0] for d in dev), max(d[1] for d in dev)))
    dev.sort()
    busy, gaps = 0, []
    cur0, cur1 = None, None
    for t0, t1 in dev:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= t0:
            continue
        if cur1 is None:
            gaps.append((lo, t0))
            cur0, cur1 = t0, t1
        elif t0 > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
        gaps.append((cur1, hi))
    else:
        gaps.append((lo, hi))
    gaps = [g for g in gaps if g[1] > g[0]]
    inner = [s for s in spans if s[2] != "window"]
    labels: Dict[str, float] = {}
    span_at = _stabber(inner)
    op_at = _stabber(cpu)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        s, o = span_at(mid), op_at(mid)
        label = "/".join(x for x in (s or "outside spans", o) if x)
        labels[label] = labels.get(label, 0.0) + (g1 - g0) / 1e9
    device_ops = sorted(([n[:160], v[1]] for n, v in by_name.items()),
                        key=lambda r: -r[1])
    return dict(
        busy_s=busy / 1e9, window_s=(hi - lo) / 1e9,
        n_device_ops=len(dev),
        by_name={n: (v[0], v[1]) for n, v in by_name.items()},
        breakdown=dict(
            device_ops=device_ops[:TOP],
            idle_gaps=sorted(([k, v] for k, v in labels.items()),
                             key=lambda r: -r[1])[:TOP]))


def _stabber(intervals: List[tuple]):
    """A function giving the name of the innermost interval covering a
    point, for queries in ascending order (intervals of one thread nest)."""
    items = sorted(intervals, key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in items]
    state = dict(i=0, stack=[])

    def at(t: int) -> Optional[str]:
        stack = state["stack"]
        j = bisect.bisect_right(starts, t)
        while state["i"] < j:
            stack.append(items[state["i"]])
            state["i"] += 1
        # drop intervals ended before t, innermost first
        live = [r for r in stack if r[1] >= t]
        state["stack"] = live
        return live[-1][2] if live else None
    return at


def kernel_seconds(red: Dict, fragment: str) -> float:
    """Device seconds of every operation whose name holds ``fragment``."""
    return sum(s for n, (c, s) in red["by_name"].items() if fragment in n)
