"""Chunked streaming raw-signal reader (fast5-like container, simplified).

Binary layout:  header [magic u32 | n_reads u32 | signal_len u32 | dtype u8]
followed by n_reads contiguous int16 signal records.  The reader streams
fixed-size chunks with a one-chunk prefetch thread — the host-side analogue
of MARS's flash-to-DRAM load/compute overlap (Section 6.3).
"""
from __future__ import annotations

import pathlib
import queue
import struct
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

MAGIC = 0x4D415253  # "MARS"
_HDR = struct.Struct("<IIIB")


def write_signals(path, signals: np.ndarray, scale: float = 64.0) -> None:
    """signals: (R, S) float32 — stored as int16 DAC-like counts."""
    path = pathlib.Path(path)
    q = np.clip(np.round(signals * scale), -32768, 32767).astype(np.int16)
    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, signals.shape[0], signals.shape[1], 1))
        f.write(q.tobytes())


def read_header(path) -> Tuple[int, int]:
    with open(path, "rb") as f:
        magic, n_reads, signal_len, _ = _HDR.unpack(f.read(_HDR.size))
    if magic != MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x}")
    return n_reads, signal_len


class SignalReader:
    """Iterate (chunk_idx, signals f32 (chunk, S)) with background prefetch.

    `start_chunk` supports resume-after-restart (checkpointed mapping jobs).
    """

    def __init__(self, path, chunk: int = 64, scale: float = 64.0,
                 start_chunk: int = 0, prefetch: int = 2):
        self.path = pathlib.Path(path)
        self.chunk = chunk
        self.scale = scale
        self.n_reads, self.signal_len = read_header(self.path)
        self.n_chunks = (self.n_reads + chunk - 1) // chunk
        self.start_chunk = start_chunk
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None

    def _producer(self):
        rec_bytes = self.signal_len * 2
        with open(self.path, "rb") as f:
            for ci in range(self.start_chunk, self.n_chunks):
                lo = ci * self.chunk
                n = min(self.chunk, self.n_reads - lo)
                f.seek(_HDR.size + lo * rec_bytes)
                buf = f.read(n * rec_bytes)
                arr = np.frombuffer(buf, np.int16).reshape(n, self.signal_len)
                sig = arr.astype(np.float32) / self.scale
                if n < self.chunk:  # pad tail chunk to static shape
                    pad = np.zeros((self.chunk - n, self.signal_len), np.float32)
                    sig = np.concatenate([sig, pad])
                self._q.put((ci, n, sig))
        self._q.put(None)

    def __iter__(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item
