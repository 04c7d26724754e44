"""Streaming host driver: ONE copy of the chunk/pad/concat logic.

  * ``array_chunks`` produces fixed-size, zero-padded
    (chunk_idx, n_valid, signals) triples from an in-memory array; a
    streaming ``SignalReader`` (signal/reader.py) yields the same triples;
  * ``stream_map`` is the double-buffered device loop: chunk i+1 is
    dispatched to the device *before* chunk i's results are pulled to the
    host, so host-side reading/padding/serialization overlaps device work;
  * ``collect`` folds the streamed per-chunk outputs into one MapOutput;
  * ``ProgressLog`` is the append-only JSONL checkpoint (with periodic
    compaction) used for resume-after-restart mapping jobs.

Pad rows are masked inside ``map_chunk`` via ``n_valid`` (counters never
see them) and trimmed from the per-read outputs here.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

# (chunk_idx, n_valid, padded signals (chunk, S) f32)
Chunk = Tuple[int, int, np.ndarray]


def pad_rows(part: np.ndarray, chunk: int) -> np.ndarray:
    """Zero-pad the leading axis to the static chunk size."""
    if part.shape[0] == chunk:
        return part
    pad = np.zeros((chunk - part.shape[0],) + part.shape[1:], part.dtype)
    return np.concatenate([part, pad])


def array_chunks(signals: np.ndarray, chunk: int,
                 start_chunk: int = 0) -> Iterator[Chunk]:
    """Fixed-size chunks over an in-memory (R, S) array."""
    signals = np.asarray(signals, np.float32)
    n = signals.shape[0]
    n_chunks = (n + chunk - 1) // chunk
    for ci in range(start_chunk, n_chunks):
        part = signals[ci * chunk:(ci + 1) * chunk]
        yield ci, part.shape[0], pad_rows(part, chunk)


def stream_map(map_fn: Callable[[np.ndarray, int], "MapOutput"],
               chunks: Iterable[Chunk],
               prefetch: Optional[Callable[[np.ndarray, int], None]] = None,
               trace: Optional[list] = None,
               clock: Optional[Callable[[], float]] = None,
               ) -> Iterator[Tuple[int, int, "MapOutput"]]:
    """Double-buffered device loop.

    ``map_fn(signals, n_valid)`` enqueues one chunk's device work
    (``Mapper.chunk_fn``).  The next chunk is dispatched before the previous
    chunk's results are copied to the host.  Yields (chunk_idx, n_valid,
    MapOutput) with per-read numpy fields trimmed to ``n_valid`` rows and
    int counters.  Without ``prefetch`` a chunk source is pulled only after
    the previous chunk was dispatched, never ahead: live sources (the
    serving driver's ready queue, core/server.py) depend on that pull
    order.

    With ``prefetch`` the loop reads ONE chunk ahead: right after chunk i
    is dispatched, ``prefetch(signals, n_valid)`` runs on chunk i+1, so its
    host-to-device staging (the tiered index's tile cache, core/tiered.py)
    overlaps chunk i's device work.  A ``prefetch`` exception does not
    abandon the chunks already dispatched: the loop stops reading ahead,
    yields every dispatched chunk, and raises the failure once at the end
    of the stream.

    With ``trace`` (a list) the loop appends the replayable chunk-event
    records ``("dispatch", t, ci, n_valid)`` after each dispatch and
    ``("complete", t, ci, n_valid)`` when the chunk's results reach the
    host (the batch-side half of ``sim.serve_sim``'s trace format).  ``t``
    comes from ``clock()`` when given (e.g. a virtual clock), else it
    counts dispatches.  Recording changes neither pull order nor outputs.
    """
    n_seen = 0

    def _note(kind: str, ci: int, n_valid: int) -> None:
        if trace is not None:
            trace.append((kind, clock() if clock is not None
                          else float(n_seen), ci, n_valid))

    def _emit(p):
        _note("complete", p[0], p[1])
        return _to_host(*p)

    pending = None
    exc = None
    if prefetch is None:
        for ci, n_valid, sig in chunks:
            out = map_fn(sig, n_valid)
            n_seen += 1
            _note("dispatch", ci, n_valid)
            if pending is not None:
                yield _emit(pending)
            pending = (ci, n_valid, out)
    else:
        it = iter(chunks)
        nxt = next(it, None)
        if nxt is not None:
            try:
                prefetch(nxt[2], nxt[1])
            except Exception as e:          # nothing in flight yet
                exc, nxt = e, None
        while nxt is not None:
            ci, n_valid, sig = nxt
            out = map_fn(sig, n_valid)
            n_seen += 1
            _note("dispatch", ci, n_valid)
            nxt = next(it, None)
            if nxt is not None:
                try:
                    prefetch(nxt[2], nxt[1])  # stage the next chunk
                except Exception as e:
                    # chunk ci is in flight: let it finish and yield, and
                    # raise the prefetch failure at the end of the stream
                    exc, nxt = e, None
            if pending is not None:
                yield _emit(pending)
            pending = (ci, n_valid, out)
    if pending is not None:
        yield _emit(pending)
    if exc is not None:
        raise exc


def _to_host(ci: int, n_valid: int, out) -> Tuple[int, int, "MapOutput"]:
    """Copy one chunk's outputs to the host in ONE device->host transfer:
    the per-read fields and the counters packed into a single int32 plane
    (score travels as its f32 bits)."""
    from repro_torch.core.pipeline import MapOutput
    i32 = torch.int32
    names = list(out.counters)
    per_read = torch.stack([out.t_start.to(i32), out.score.view(i32),
                            out.mapped.to(i32), out.n_events.to(i32)])
    counters = torch.stack([out.counters[k].to(i32).reshape(())
                            for k in names])
    flat = torch.cat([per_read[:, :n_valid].reshape(-1), counters])
    host = flat.cpu().numpy()
    fields = host[:4 * n_valid].reshape(4, n_valid)
    return ci, n_valid, MapOutput(
        t_start=fields[0].copy(), score=fields[1].view(np.float32).copy(),
        mapped=fields[2].astype(bool), n_events=fields[3].copy(),
        counters={k: int(v) for k, v in zip(names, host[4 * n_valid:])})


def collect(stream: Iterable[Tuple[int, int, "MapOutput"]]) -> "MapOutput":
    """Fold a stream_map stream into one host MapOutput (concat per-read
    fields, sum counters).  An empty stream still carries the full
    zero-valued ``stages.CHUNK_COUNTER_SCHEMA``."""
    from repro_torch.core.pipeline import MapOutput
    parts: List = []
    counters: Dict[str, int] = {}
    for _, _, out in stream:
        parts.append(out)
        for k, v in out.counters.items():
            counters[k] = counters.get(k, 0) + int(v)
    if not parts:
        from repro_torch.core.stages import CHUNK_COUNTER_SCHEMA
        z = np.zeros(0)
        return MapOutput(t_start=z.astype(np.int32),
                         score=z.astype(np.float32),
                         mapped=z.astype(bool), n_events=z.astype(np.int32),
                         counters={k: 0 for k in CHUNK_COUNTER_SCHEMA})
    return MapOutput(
        t_start=np.concatenate([p.t_start for p in parts]),
        score=np.concatenate([p.score for p in parts]),
        mapped=np.concatenate([p.mapped for p in parts]),
        n_events=np.concatenate([p.n_events for p in parts]),
        counters=counters)


# --------------------------------------------------------------------------- #
# Resumable progress checkpointing
# --------------------------------------------------------------------------- #
class ProgressLog:
    """Append-only JSONL progress log with periodic compaction.

    Each mapped chunk appends ONE line ``{"next": ci+1, "rows": [...]}``.
    Every ``compact_every`` lines the log is rewritten as a single
    consolidated base line (atomic tmp+rename), bounding file size and
    resume parse time.
    """

    def __init__(self, path, compact_every: int = 64):
        self.path = pathlib.Path(path)
        self.compact_every = compact_every
        self.rows: List = []
        self.next_chunk = 0
        self._lines = 0

    def load(self) -> Tuple[int, List]:
        """Replay the log.  Returns (next_chunk, rows).  A torn or malformed
        final line stops the replay there and is truncated away; its chunk is
        simply remapped."""
        self.rows, self.next_chunk, self._lines = [], 0, 0
        if self.path.exists():
            good = 0                       # bytes of consistent prefix
            with open(self.path, "rb") as f:
                for raw in f:
                    if not raw.endswith(b"\n"):
                        break              # torn tail (no terminator)
                    line = raw.decode("utf-8", "replace").strip()
                    if line:
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            break
                        if rec.get("base"):
                            self.rows = [tuple(r) for r in rec["rows"]]
                        else:
                            self.rows.extend(tuple(r) for r in rec["rows"])
                        self.next_chunk = rec["next"]
                        self._lines += 1
                    good += len(raw)
            if good < self.path.stat().st_size:
                with open(self.path, "r+b") as f:
                    f.truncate(good)
        return self.next_chunk, self.rows

    def append(self, next_chunk: int, rows: List) -> None:
        rows = [tuple(r) for r in rows]
        with open(self.path, "a") as f:
            f.write(json.dumps({"next": next_chunk, "rows": rows}) + "\n")
        self.rows.extend(rows)
        self.next_chunk = next_chunk
        self._lines += 1
        if self._lines >= self.compact_every:
            self.compact()

    def compact(self) -> None:
        tmp = self.path.with_name(self.path.name + ".tmp")
        tmp.write_text(json.dumps(
            {"next": self.next_chunk, "rows": self.rows, "base": True}) + "\n")
        os.replace(tmp, self.path)
        self._lines = 1

    def clear(self) -> None:
        self.path.unlink(missing_ok=True)
        self.rows, self.next_chunk, self._lines = [], 0, 0
