"""Chaining (paper Fig. 1, mapping step 3): anchor sort + banded DP.

Anchors are sorted by (t_pos, q_pos), packed into one int32 key so the sort
is a single-key sort (what MARS's in-controller bitonic Sorter consumes).
The DP is minimap2-style with a fixed look-back band B:

    f[i] = w + max(0, max_{j in band, colinear} f[j] - beta*|dt - dq|
                                              - alpha*min(dt, dq))

The best chain's projected start (t_start - q_start) is the mapping
position.  Every function works on a batch of reads (leading axis N).

Fast path (core/pipeline.py): ``select_smallest_count`` /
``select_smallest_topk`` pull the W smallest keys out of the (E*H,) key
array so the sorter runs on W keys instead of E*H; ``chain_dp`` carries
only the B-slot band as a ring buffer; zero-anchor reads take the closed
form ``empty_chain_result``.

Float exactness: every config float enters as an f32 scalar.  The
reference package's compiled DP (XLA on the CPU) contracts
``cand = bf - gap_cost*gap - skip_cost*skip`` into two fused multiply-adds,
fma(-skip_cost, skip, fma(-gap_cost, gap, bf)), so ``chain_dp`` evaluates
exactly that with ``fma_f32`` (one rounding each), and the CUDA kernel with
``__fmaf_rn``; every other float operation rounds on its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.config import MarsConfig
from repro_torch.core.index import T_BITS, _Q_BITS  # noqa: F401 (T_BITS re-export)

NEG = -1e9
_SENT = -(1 << 30)
_INVALID_KEY = 0x7FFFFFFF


class ChainResult(NamedTuple):
    t_start: torch.Tensor     # (N,) int32 — double-genome coords
    score: torch.Tensor       # (N,) f32
    score2: torch.Tensor      # (N,) f32 second-best (distinct location)
    mapped: torch.Tensor      # (N,) bool
    n_anchors: torch.Tensor   # (N,) int32 anchors entering the DP


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """IEEE fused multiply-add on f32 tensors: round_f32(a + b*c) with ONE
    rounding (C ``fmaf``; ``__fmaf_rn`` in the CUDA kernel).

    The product of two f32 values is exact in f64; the f64 sum is taken
    with round-to-odd (Knuth's TwoSum gives the exact error, and an inexact
    sum with an even last bit steps one ulp toward it), which makes the
    final rounding to f32 the correctly rounded fused result.
    """
    a64 = a.to(torch.float64)
    p = b.to(torch.float64) * c.to(torch.float64)
    s = a64 + p
    bb = s - a64
    err = (a64 - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    s = torch.where((err != 0) & even, toward, s)
    return s.to(torch.float32)


# --------------------------------------------------------------------------- #
# Key packing / selection
# --------------------------------------------------------------------------- #
def pack_anchor_keys(q_pos: torch.Tensor, t_pos: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Flatten (N, E, H) anchors into (N, E*H) packed int32 sort keys
    [t:23 | q:8]; invalid anchors become ``_INVALID_KEY`` (sorts last)."""
    n = q_pos.shape[0]
    t = t_pos.reshape(n, -1).to(torch.int32)
    q = torch.clamp(q_pos.reshape(n, -1), max=(1 << _Q_BITS) - 1).to(
        torch.int32)
    key = (t << _Q_BITS) | q
    return torch.where(valid.reshape(n, -1), key,
                       torch.full_like(key, _INVALID_KEY))


def decode_anchor_keys(skey: torch.Tensor):
    """Inverse of ``pack_anchor_keys`` on sorted keys: (sq, st, sv)."""
    sv = skey != _INVALID_KEY
    st = (skey >> _Q_BITS).to(torch.int32)
    sq = (skey & ((1 << _Q_BITS) - 1)).to(torch.int32)
    return sq, st, sv


def select_smallest_count(key: torch.Tensor, width: int) -> torch.Tensor:
    """The valid entries of each row of ``key`` (N, L), in order, compacted
    to (N, width) and padded with ``_INVALID_KEY``.

    The EXACT equivalent of ``sort(key)[:, :width]`` as a multiset iff each
    row holds at most ``width`` valid keys — callers guarantee that with a
    batch-level ``n_anchors_postvote`` bound before taking this path.
    """
    valid = key != _INVALID_KEY
    cum = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32)
    want = torch.arange(1, width + 1, dtype=torch.int32, device=key.device)
    idx = torch.searchsorted(cum.contiguous(),
                             want.expand(key.shape[0], width).contiguous(),
                             side="left")
    got = torch.gather(key, 1, torch.clamp(idx, max=key.shape[1] - 1))
    keep = torch.arange(width, device=key.device) < cum[:, -1:]
    return torch.where(keep, got, torch.full_like(got, _INVALID_KEY))


def select_smallest_topk(key: torch.Tensor, width: int) -> torch.Tensor:
    """The ``width`` smallest keys of each row, ascending.  Exact for ANY
    valid count (true smallest-k selection)."""
    return torch.topk(key, width, dim=1, largest=False, sorted=True).values


_SELECTORS = {
    "count": select_smallest_count,
    "topk": select_smallest_topk,
}


def _sort_rows(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, dim=-1).values


def sort_anchors(q_pos: torch.Tensor, t_pos: torch.Tensor,
                 valid: torch.Tensor, cfg: MarsConfig, sorter=None,
                 width: int = None):
    """Sort (N, E, H) anchors by (t_pos, q_pos) with invalids last and keep
    the first ``max_anchors`` per read.  ``sorter(keys (N, L)) -> sorted``
    is injectable (the bitonic kernel); default ``torch.sort``.

    ``width=W`` is the select-then-sort fast path: the W smallest keys are
    selected first (strategy ``cfg.anchor_select``) and only those sorted.
    """
    if sorter is None:
        sorter = _sort_rows
    key = pack_anchor_keys(q_pos, t_pos, valid)
    if width is None:
        skey = sorter(key)[:, : cfg.max_anchors]
    else:
        skey = sorter(_SELECTORS[cfg.anchor_select](key, width))
    return decode_anchor_keys(skey)


# --------------------------------------------------------------------------- #
# Banded DP
# --------------------------------------------------------------------------- #
def chain_dp(q: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
             cfg: MarsConfig):
    """Banded DP over sorted anchors, ring-buffer band window.

    q, t: (N, A) int32 sorted by (t, q); valid: (N, A) bool.  Returns
    (f (N, A) f32 chain scores, diag0 (N, A) int32 start diag of the best
    chain ending at each anchor).  Anchor i lives in band slot i % B; argmax
    ties resolve to the OLDEST slot through the age rank k = (slot - i) mod B.
    """
    N, A = q.shape
    B = cfg.chain_band
    dev = q.device
    lane = torch.arange(B, device=dev)
    neg_gap_cost = -_f32(cfg.gap_cost, q)
    neg_skip_cost = -_f32(cfg.skip_cost, q)
    anchor_score = _f32(cfg.anchor_score, q)
    neg = _f32(NEG, q)
    half_neg = _f32(NEG / 2, q)
    zero = _f32(0.0, q)
    bf = torch.full((N, B), NEG, dtype=torch.float32, device=dev)
    bd = torch.zeros((N, B), dtype=torch.int32, device=dev)
    bt = torch.full((N, B), _SENT, dtype=torch.int32, device=dev)
    bq = torch.full((N, B), _SENT, dtype=torch.int32, device=dev)
    f_out = torch.empty((N, A), dtype=torch.float32, device=dev)
    d_out = torch.empty((N, A), dtype=torch.int32, device=dev)
    for i in range(A):
        ti, qi, vi = t[:, i:i + 1], q[:, i:i + 1], valid[:, i:i + 1]
        dt = ti - bt
        dq = qi - bq
        ok = (dt > 0) & (dq > 0) & (dt <= cfg.max_gap) & (dq <= cfg.max_gap)
        gap = torch.abs(dt - dq).to(torch.float32)
        skip = torch.minimum(dt, dq).to(torch.float32)
        cand = fma_f32(fma_f32(bf, neg_gap_cost, gap), neg_skip_cost, skip)
        cand = torch.where(ok & (bf > half_neg), cand, neg)
        best = cand.max(dim=1, keepdim=True).values
        # oldest-first tie-break: age rank k=0 is the oldest band slot
        k = (lane - i) % B
        kbest = torch.where(cand == best, k, B).min(dim=1,
                                                    keepdim=True).values
        dbest = torch.where((cand == best) & (k == kbest), bd,
                            torch.zeros_like(bd)).sum(1, keepdim=True)
        ext = best > zero
        fi = anchor_score + torch.maximum(best, zero)
        fi = torch.where(vi, fi, neg)
        di = torch.where(ext, dbest.to(torch.int32), ti - qi)
        f_out[:, i:i + 1] = fi
        d_out[:, i:i + 1] = di
        s = i % B
        bf[:, s:s + 1] = fi
        bd[:, s:s + 1] = di
        bt[:, s:s + 1] = ti
        bq[:, s:s + 1] = qi
    return f_out, d_out


# --------------------------------------------------------------------------- #
# Finalize
# --------------------------------------------------------------------------- #
def best_chain(f: torch.Tensor, diag0: torch.Tensor, valid: torch.Tensor,
               cfg: MarsConfig) -> ChainResult:
    """Best + second-best (distinct window) chain -> mapping decision."""
    neg = _f32(NEG, f)
    fv = torch.where(valid, f, neg)
    i1 = torch.argmax(fv, dim=1, keepdim=True)              # first max
    s1 = torch.gather(fv, 1, i1)
    d1 = torch.gather(diag0, 1, i1)
    far = torch.abs(diag0 - d1) > cfg.voting_window
    fv2 = torch.where(valid & far, f, neg)
    s2 = torch.clamp(fv2.max(dim=1, keepdim=True).values, min=0.0)
    mapped = ((s1 >= _f32(cfg.min_chain_score, f))
              & (s1 >= _f32(cfg.map_ratio, f) * s2))
    t_start = torch.clamp(d1, min=0).to(torch.int32)
    return ChainResult(t_start=t_start[:, 0], score=s1[:, 0],
                       score2=s2[:, 0], mapped=mapped[:, 0],
                       n_anchors=valid.sum(1).to(torch.int32))


def empty_chain_result(cfg: MarsConfig) -> ChainResult:
    """The EXACT per-read ChainResult the full sort+dp+finalize pipeline
    produces for a read with zero valid anchors, in closed form (python
    scalars).

    Every sorted slot holds ``_INVALID_KEY``; the DP gives every slot
    f = NEG and diag = t - q of the decoded sentinel (its huge t fails the
    ``dt <= max_gap`` test, so no extension fires); best_chain's argmax
    lands on slot 0 and the second-best window is empty.
    """
    st = _INVALID_KEY >> _Q_BITS
    sq = (1 << _Q_BITS) - 1
    return ChainResult(t_start=max(st - sq, 0), score=NEG, score2=0.0,
                       mapped=False, n_anchors=0)
