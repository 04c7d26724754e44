"""The one traffic generator: it reads a mix's parameters (``traffic/<name>
.json``, with the cell's own file over it) and drives the program's chunk
function through the program's driver (``core.driver.stream_map``).

Reads come from a seeded host pool, taken in pool order and cycled; a chunk
is the next ``chunk`` reads of that cycle (a view of the pool unless it
wraps or is the short end of a burst, which is padded as the driver pads).

Loops (``"loop"`` in the mix):

* ``closed``: offline mapping.  The next chunk is dispatched as soon as the
  double-buffered driver asks for it, until ``seconds`` have passed; the
  chunks in flight then finish.  Parameters: ``chunk``.
* ``bursts``: Read Until.  Every ``interval_s`` each of ``channels``
  channels offers a new read's chunk of signal at once, as a Read Until
  client that polls every channel in one call; a burst is mapped in chunks
  of up to ``chunk`` reads, bursts one after another.  A burst due while
  the previous one runs waits (the backlog), and every read is timed from
  its burst's due time.  Bursts stop being started a minute after the
  window closes.  Parameters: ``chunk``, ``interval_s``, ``channels``.

A loop these two cannot express is a file of its own, ``loops/<loop>.py``
(``manifest.loop``).  Common parameters: ``pool_reads`` (the pool's size).  Every span the loop
records names what the host was doing: ``source`` (taking the chunk from
the pool), ``map_fn`` (the program's dispatch of a chunk), ``collect``
(waiting for a chunk's outputs: the driver's next step), ``sleep`` (an open
loop waiting for its next burst).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List

import numpy as np

LATE_GRACE_S = 60.0        # how long past the window a due burst may start


class Spans:
    """Host spans (name, start, end) on ``time.perf_counter``;
    ``annotate(name)`` (the profiler's ``record_function``) marks them in a
    traced run's trace too."""

    def __init__(self, annotate=None):
        self.rows: List[tuple] = []
        self.annotate = annotate

    @contextlib.contextmanager
    def __call__(self, name: str):
        cm = (self.annotate(name) if self.annotate is not None
              else contextlib.nullcontext())
        with cm:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.rows.append((name, t0, time.perf_counter()))


def pool_slice(signals: np.ndarray, g: int, n: int) -> np.ndarray:
    """Reads [g, g + n) of the cycled pool."""
    P = signals.shape[0]
    a = g % P
    if a + n <= P:
        return signals[a:a + n]
    return np.concatenate([signals[a:], signals[:a + n - P]])


def _chunk(signals, g, n, chunk):
    part = pool_slice(signals, g, n)
    if n < chunk:
        part = np.concatenate(
            [part, np.zeros((chunk - n, part.shape[1]), part.dtype)])
    return part


def _timed(map_fn, spans):
    def fn(sig, nv):
        with spans("map_fn"):
            return map_fn(sig, nv)
    return fn


def _drain(stream, spans, chunks, extra):
    """Pull a driver stream to its end, recording each chunk as its
    outputs reach the host."""
    while True:
        with spans("collect"):
            item = next(stream, None)
        if item is None:
            return
        g, n, out = item
        chunks.append(dict(g=g, n=n, out=out, t_done=time.perf_counter(),
                           **extra))


def warm(map_fn, stream_map, signals, p: Dict) -> None:
    """One pass over the pool in the mix's chunks, through the same driver,
    and a burst's short last chunk where its channels leave one: every
    chunk the window sends."""
    C, P = p["chunk"], signals.shape[0]
    src = [(g, min(C, P - g), _chunk(signals, g, min(C, P - g), C))
           for g in range(0, P, C)]
    tail = int(p.get("channels") or 0) % C
    if tail:
        src.append((0, tail, _chunk(signals, 0, tail, C)))
    for _ in stream_map(map_fn, iter(src)):
        pass


def closed(map_fn, stream_map, signals, p: Dict, seconds: float,
           spans: Spans) -> Dict:
    C = p["chunk"]
    chunks: List[Dict] = []
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def source():
        g = 0
        while time.perf_counter() < t_end:
            with spans("source"):
                part = _chunk(signals, g, C, C)
            yield g, C, part
            g += C

    _drain(stream_map(_timed(map_fn, spans), source()), spans, chunks, {})
    return dict(loop="closed", t0=t0, t_end=t_end, t1=time.perf_counter(),
                chunks=chunks, due_reads=sum(c["n"] for c in chunks))


def bursts(map_fn, stream_map, signals, p: Dict, seconds: float,
           spans: Spans) -> Dict:
    C, N, I = p["chunk"], int(p["channels"]), float(p["interval_s"])
    chunks: List[Dict] = []
    late: List[float] = []
    t0 = time.perf_counter()
    t_end = t0 + seconds
    n_due = int(np.ceil(seconds / I))          # bursts due in the window
    fn = _timed(map_fn, spans)
    k = 0
    while k < n_due:
        due = t0 + k * I
        now = time.perf_counter()
        if now > t_end + LATE_GRACE_S:
            break
        if now < due:
            with spans("sleep"):
                time.sleep(due - now)
        late.append(time.perf_counter() - due)
        g0 = k * N

        def source(g0=g0):
            for off in range(0, N, C):
                n = min(C, N - off)
                with spans("source"):
                    part = _chunk(signals, g0 + off, n, C)
                yield g0 + off, n, part

        _drain(stream_map(fn, source()), spans, chunks, dict(due=due))
        k += 1
    return dict(loop="bursts", t0=t0, t_end=t_end, t1=time.perf_counter(),
                chunks=chunks, due_reads=n_due * N, late_s=late,
                interval_s=I, channels=N, bursts_due=n_due)


def latencies_s(record: Dict) -> np.ndarray:
    """Every due read's decision time in an open loop: from its burst's due
    time to its chunk's outputs on the host.  A read undecided when the
    window closed (its chunk came later, or never) enters with its wait so
    far."""
    t_end, I, N = record["t_end"], record["interval_s"], record["channels"]
    parts = [np.full(c["n"], min(c["t_done"], t_end) - c["due"])
             for c in record["chunks"] if c["due"] < t_end]
    answered = sum(p.size for p in parts)
    dues = record["t0"] + I * np.arange(record["bursts_due"])
    waits = np.repeat(t_end - dues, N)
    # the reads left are the last ones due (bursts run in order)
    parts.append(waits[answered:])
    return np.concatenate(parts)


LOOPS: Dict[str, Callable] = {"closed": closed, "bursts": bursts}


def run(map_fn, stream_map, signals, p: Dict, seconds: float,
        spans: Spans, root=None) -> Dict:
    """The mix's loop: one of ``LOOPS``, or ``loops/<loop>.py`` (found by
    ``manifest.loop``) for a loop that needs code of its own."""
    fn = LOOPS.get(p["loop"])
    if fn is None:
        from rsga_bench import manifest
        fn = manifest.loop(p["loop"], root or manifest.ROOT)
        if fn is None:
            raise KeyError(f"no loop {p['loop']!r}: neither built in nor a "
                           "file under loops/")
    return fn(map_fn, stream_map, signals, p, seconds, spans)
