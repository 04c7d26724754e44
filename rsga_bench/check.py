"""The comparison that decides ``correct``, and the work the inputs need.

After the window the plain reference (``reference/mars.py``) rebuilds the
index from the same reference events and maps every read of the pool, in
blocks of the cell's chunk size, on the card the program ran on.  Every
chunk the window answered is then compared with it:

* ``wrong_reads``: reads whose ``t_start``, ``score`` (its bits),
  ``mapped`` or ``n_events`` differ from the reference's;
* ``wrong_counters``: chunks whose counters (the ten pipeline counters,
  ``n_reads``, ``n_samples``) differ from the sums of the reference's;
* ``missing_reads``: reads due in the window whose answer never came.

Each limit is 0: the port is exact.  The same pass counts, per block of the
pool, the work its reads need (``work``), which the roofline counts read.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from rsga_bench.reference import mars

LIMITS = {"wrong_reads": 0, "wrong_counters": 0, "missing_reads": 0}


class Answers(NamedTuple):
    t_start: np.ndarray      # (P,) int32
    score_bits: np.ndarray   # (P,) int32
    mapped: np.ndarray       # (P,) bool
    n_events: np.ndarray     # (P,) int32
    counters: np.ndarray     # (P, len(mars.COUNTERS)) int64
    work: List[Dict]         # per block of ``block`` reads


def _dp_pairs(n: torch.Tensor, band: int) -> torch.Tensor:
    """Predecessors the DP weighs over n sorted anchors: anchor i looks
    back at min(i, band) of them."""
    n = n.to(torch.int64)
    full = band * (band + 1) // 2 + (n - 1 - band) * band
    return torch.where(n - 1 <= band, n * (n - 1) // 2, full)


def _work(r: mars.Mapped, signal: torch.Tensor, p: mars.Params) -> Dict:
    c = {k: int(v.to(torch.int64).sum()) for k, v in r.counters.items()}
    b = r.probes["bucket"][r.probes["valid"]].to(torch.int64)
    ent = r.probes["entry"]
    return dict(
        reads=int(signal.shape[0]), samples=int(signal.numel()),
        events=c["n_events"], valid_seeds=c["n_seeds"],
        probes=c["n_bucket_probes"],
        bucket_words=int(torch.unique(torch.cat([b, b + 1])).numel()),
        entries=int(torch.unique(ent[ent >= 0]).numel()),
        anchors=c["n_anchors_postvote"], dp_anchors=c["n_sorted"],
        dp_pairs=int(_dp_pairs(r.counters["n_sorted"],
                               p.chain_band).sum()))


def reference_answers(signals: np.ndarray, events_concat: np.ndarray,
                      n_ref_events: int, mars_config: Dict, device,
                      block: int, signal_dtype=None) -> Answers:
    p = mars.Params.from_config(mars_config)
    index = mars.index_tensors(
        mars.build_index(events_concat, n_ref_events, p), device)
    P = signals.shape[0]
    t = np.empty(P, np.int32)
    s = np.empty(P, np.int32)
    m = np.empty(P, bool)
    ne = np.empty(P, np.int32)
    cnt = np.empty((P, len(mars.COUNTERS)), np.int64)
    work = []
    for b in range(0, P, block):
        sig = torch.from_numpy(signals[b:b + block]).to(device)
        r = mars.map_reads(sig, index, p, signal_dtype=signal_dtype)
        n = sig.shape[0]
        t[b:b + n] = r.t_start.cpu().numpy()
        s[b:b + n] = r.score.contiguous().view(torch.int32).cpu().numpy()
        m[b:b + n] = r.mapped.cpu().numpy()
        ne[b:b + n] = r.n_events.cpu().numpy()
        cnt[b:b + n] = torch.stack([r.counters[k] for k in mars.COUNTERS],
                                   1).cpu().numpy()
        work.append(_work(r, sig, p))
        del r, sig
    return Answers(t, s, m, ne, cnt, work)


def compare(record: Dict, ans: Answers, signal_len: int) -> Dict[str, int]:
    """The numbers compared, each to be held to its limit in ``LIMITS``."""
    P = ans.t_start.shape[0]
    wrong_reads = wrong_counters = answered = 0
    for c in record["chunks"]:
        out, n = c["out"], c["n"]
        idx = (c["g"] + np.arange(n)) % P
        bad = ((np.asarray(out.t_start) != ans.t_start[idx])
               | (np.asarray(out.score, np.float32).view(np.int32)
                  != ans.score_bits[idx])
               | (np.asarray(out.mapped, bool) != ans.mapped[idx])
               | (np.asarray(out.n_events) != ans.n_events[idx]))
        wrong_reads += int(bad.sum())
        want = dict(zip(mars.COUNTERS, ans.counters[idx].sum(0).tolist()),
                    n_reads=n, n_samples=n * signal_len)
        got = {k: int(v) for k, v in out.counters.items()}
        wrong_counters += int(got != want)
        answered += n
    return dict(wrong_reads=wrong_reads, wrong_counters=wrong_counters,
                missing_reads=max(0, record["due_reads"] - answered))


def chunk_work(record: Dict, ans: Answers, chunk: int) -> Optional[Dict]:
    """The summed work of the window's chunks, where each chunk is a whole
    block of the pool (the blocks the reference counted); else None."""
    P = ans.t_start.shape[0]
    total: Dict[str, int] = {}
    for c in record["chunks"]:
        a = c["g"] % P
        if c["n"] != chunk or a % chunk or P % chunk:
            return None
        for k, v in ans.work[a // chunk].items():
            total[k] = total.get(k, 0) + v
    return total or None
