"""The plain reference the benchmark holds the port to: MARS read mapping in
plain PyTorch and NumPy, one read per row, no kernel, no compaction gate,
no width ladder.

A frozen copy of the port's plain path as it stood when the benchmark was
defined, in its pre-fast-path forms: the two-sort median/MAD
normalization, the in-order scatter segment sums, the four-plane index
query, the two-scatter vote, the full sort of every anchor key and the
window-slicing chaining DP.  It imports nothing of the program.  The
float path evaluates the JAX package's compiled f32 order (``f32order``),
which is what the program is held to bit for bit.

``build_index`` rebuilds the index from the reference events the benchmark
made; ``map_reads`` maps a block of reads over it and returns every read's
decision and counters.  ``signal_dtype`` carries the raw signal in a lower
precision: the control that a correct run has to tell apart.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from . import f32order

_EPS = 1e-6
SIGNAL_CLIP = 8.0
MASK32 = 0xFFFFFFFF
_MIX_C1 = 0x85EBCA6B
_MIX_C2 = 0xC2B2AE35
Q_BITS = 8
T_BITS = 31 - Q_BITS
NEG = -1e9
SENT = -(1 << 30)
INVALID_KEY = 0x7FFFFFFF
DIAG_SHIFT = 1 << 20

COUNTERS = ("n_events", "n_seeds", "n_bucket_probes", "n_hits_raw",
            "n_hits_postfreq", "n_hits_exact", "n_votes_cast",
            "n_anchors_postvote", "n_sorted", "n_dp_pairs")


class Params(NamedTuple):
    """The configuration's mapping parameters (the config file's
    ``mars_config``; the names of the port's ``MarsConfig``)."""
    signal_len: int
    max_events: int
    tstat_window: int
    tstat_threshold: float
    peak_window: int
    min_dwell: int
    quant_bits: int
    quant_clip_sigma: float
    frac_bits: int
    early_quantization: bool
    fixed_point: bool
    seed_width: int
    hash_bits: int
    max_hits_per_seed: int
    minimizer_radius: int
    use_freq_filter: bool
    thresh_freq: int
    use_vote_filter: bool
    thresh_voting: int
    voting_window_log2: int
    vote_bins: int
    max_anchors: int
    chain_band: int
    max_gap: int
    gap_cost: float
    skip_cost: float
    anchor_score: float
    min_chain_score: float
    map_ratio: float

    @classmethod
    def from_config(cls, cfg: Dict) -> "Params":
        return cls(**{k: cfg[k] for k in cls._fields})

    @property
    def n_buckets(self) -> int:
        return 1 << self.hash_bits


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------- #
# Index (numpy, offline)
# --------------------------------------------------------------------------- #
def _mix32_np(x: np.ndarray) -> np.ndarray:
    m = np.uint64(MASK32)
    x = x.astype(np.uint64) & m
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(_MIX_C1)) & m
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(_MIX_C2)) & m
    return x ^ (x >> np.uint64(16))


def _minimizer_np(keys: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return np.ones(keys.shape[0], bool)
    big = np.uint32(MASK32)
    kv = keys.astype(np.uint32)
    wmin = kv.copy()
    for d in range(1, radius + 1):
        left = np.concatenate([np.full(d, big, np.uint32), kv[:-d]])
        right = np.concatenate([kv[d:], np.full(d, big, np.uint32)])
        wmin = np.minimum(wmin, np.minimum(left, right))
    return kv == wmin


def build_index(events_concat: np.ndarray, n_ref_events: int,
                p: Params) -> Dict[str, np.ndarray]:
    """The direct-address bucket table over the double genome's events:
    ``bucket_start`` (2^h + 1,), and per entry its full key, position and
    exact key count, sorted by (bucket, key)."""
    if events_concat.shape[0] >= (1 << T_BITS):
        raise ValueError(f"double genome over 2^{T_BITS} events")
    ev = events_concat.astype(np.float64)
    mean, std = float(ev.mean()), float(ev.std()) + 1e-6
    clip = p.quant_clip_sigma
    step = (2.0 * clip) / (1 << p.quant_bits)
    sym = np.floor((np.clip((ev - mean) / std, -clip, clip - 1e-4) + clip)
                   / step)
    sym = np.clip(sym.astype(np.int64), 0, (1 << p.quant_bits) - 1)
    n = sym.shape[0] - p.seed_width + 1
    key = np.zeros(n, np.uint64)
    for j in range(p.seed_width):
        key = (key << np.uint64(p.quant_bits)) | sym[j:j + n].astype(
            np.uint64)
    keys = _mix32_np(key).astype(np.uint32)
    pos = np.arange(n, dtype=np.int64)
    Le, w = n_ref_events, p.seed_width
    keep = ~((pos > Le - w) & (pos < Le))     # seeds across the junction
    keep &= _minimizer_np(keys, p.minimizer_radius)
    keys, pos = keys[keep], pos[keep]
    order_k = np.argsort(keys, kind="stable")
    _, counts = np.unique(keys[order_k], return_counts=True)
    cnt = np.empty(keys.shape[0], np.int64)
    cnt[order_k] = np.repeat(counts, counts)
    bucket = (keys & np.uint32(p.n_buckets - 1)).astype(np.int64)
    order = np.lexsort((keys, bucket))
    bucket_start = np.zeros(p.n_buckets + 1, np.int64)
    np.add.at(bucket_start, bucket[order] + 1, 1)
    return dict(
        bucket_start=np.cumsum(bucket_start).astype(np.int32),
        entries_key=keys[order].view(np.int32),
        entries_pos=pos[order].astype(np.int32),
        entries_cnt=np.minimum(cnt[order], np.iinfo(np.int32).max).astype(
            np.int32))


def index_tensors(index: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in index.items()}


# --------------------------------------------------------------------------- #
# Event detection
# --------------------------------------------------------------------------- #
def robust_normalize(signal: torch.Tensor) -> torch.Tensor:
    """Per-read median/MAD normalization, two full sorts; each median is
    the midpoint (lo + hi) * 0.5 of the sorted row."""
    S = signal.shape[-1]
    m1, m2 = (S - 1) // 2, S // 2
    half = _f32(0.5, signal)

    def median(x):
        xs = torch.sort(x, dim=-1).values
        return (xs[:, m1:m1 + 1] + xs[:, m2:m2 + 1]) * half

    med = median(signal)
    mad = median(torch.abs(signal - med))
    scale = f32order.fma_f32(_f32(_EPS, signal), mad, _f32(1.4826, signal))
    return (signal - med) / scale


def quantize_signal_fixed(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    scaled = torch.clamp(x, -SIGNAL_CLIP, SIGNAL_CLIP) * _f32(
        float(1 << frac_bits), x)
    return torch.round(scaled).to(torch.int16)


def dequantize_fixed(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    return x.to(torch.float32) * _f32(1.0 / (1 << frac_bits), x)


def _window_index(S: int, w: int, device):
    idx = torch.arange(S, device=device)
    return idx, torch.clamp(idx - w, min=0), torch.clamp(idx + w, max=S)


def _windowed_sums_int(x: torch.Tensor, w: int):
    R, S = x.shape
    x64 = x.to(torch.int64)
    zero = torch.zeros((R, 1), dtype=torch.int64, device=x.device)
    c = torch.cat([zero, torch.cumsum(x64, dim=1)], dim=1)
    c2 = torch.cat([zero, torch.cumsum(x64 * x64, dim=1)], dim=1)
    idx, lo, hi = _window_index(S, w, x.device)
    i32 = torch.int32
    return ((c[:, idx] - c[:, lo]).to(i32), (c[:, hi] - c[:, idx]).to(i32),
            (c2[:, idx] - c2[:, lo]).to(i32), (c2[:, hi] - c2[:, idx]).to(i32))


def _windowed_sums_float(x: torch.Tensor, w: int):
    R, S = x.shape
    zero = torch.zeros((R, 1), dtype=torch.float32, device=x.device)
    c = torch.cat([zero, f32order.prefix_sum(x)], dim=1)
    c2 = torch.cat([zero, f32order.prefix_sum(x * x)], dim=1)
    idx, lo, hi = _window_index(S, w, x.device)
    return (c[:, idx] - c[:, lo], c[:, hi] - c[:, idx],
            c2[:, idx] - c2[:, lo], c2[:, hi] - c2[:, idx])


def _peak_pick(score, above, p: Params):
    r = p.peak_window
    S = score.shape[-1]
    pad = torch.full_like(score[..., :r], float("-inf"))
    padded = torch.cat([pad, score, pad], dim=-1)
    wmax = score
    lmax = score
    for d in range(1, r + 1):
        left = padded[..., r - d:r - d + S]
        right = padded[..., r + d:r + d + S]
        wmax = torch.maximum(wmax, torch.maximum(left, right))
        lmax = torch.maximum(lmax, left)
    is_peak = (score >= wmax) & (score >= lmax) & above
    if p.min_dwell <= 1:
        return is_peak
    last = torch.full(is_peak.shape[:-1], -p.min_dwell, dtype=torch.int64,
                      device=is_peak.device)
    kept = torch.zeros_like(is_peak)
    for i in range(S):
        keep = is_peak[..., i] & (i - last >= p.min_dwell)
        kept[..., i] = keep
        last = torch.where(keep, i, last)
    return kept


def boundary_mask_fixed(xq: torch.Tensor, p: Params) -> torch.Tensor:
    """The sqrt-free integer boundary test on the Q-format signal, then the
    peak pick."""
    w = p.tstat_window
    sum_l, sum_r, sq_l, sq_r = _windowed_sums_int(xq, w)
    diff = (sum_r - sum_l) >> 2
    ssd_l = w * sq_l - sum_l * sum_l
    ssd_r = w * sq_r - sum_r * sum_r
    tau2 = int(round(p.tstat_threshold ** 2))
    eps = 1 << max(2 * p.frac_bits - 8, 0)
    lhs = diff * diff * w
    rhs = tau2 * (((ssd_l + ssd_r) >> 4) + eps)
    score = lhs.to(torch.float32) / (rhs.to(torch.float32) + _f32(1.0, xq))
    return _peak_pick(score, lhs > rhs, p)


def boundary_mask_float(x: torch.Tensor, p: Params) -> torch.Tensor:
    sum_l, sum_r, sq_l, sq_r = _windowed_sums_float(x, p.tstat_window)
    inv_w = _f32(1.0, x) / p.tstat_window
    mean_l, mean_r = sum_l * inv_w, sum_r * inv_w
    zero = _f32(0.0, x)
    var_l = torch.maximum(f32order.fma_f32(-(mean_l * mean_l), sq_l, inv_w),
                          zero)
    var_r = torch.maximum(f32order.fma_f32(-(mean_r * mean_r), sq_r, inv_w),
                          zero)
    denom = f32order.fma_f32(_f32(_EPS, x), var_l + var_r, inv_w)
    t = torch.abs(mean_r - mean_l) * f32order.rsqrt(denom)
    return _peak_pick(t, t > _f32(p.tstat_threshold, t), p)


def segment_means(x: torch.Tensor, boundaries: torch.Tensor, E: int):
    """Event means: each event's f32 sum adds its samples in sample order
    (one scatter a sample), divided by its sample count."""
    R, S = x.shape
    eid = torch.clamp(torch.cumsum(boundaries.to(torch.int32), dim=1,
                                   dtype=torch.int32), max=E - 1)
    xf = x.to(torch.float32).contiguous()
    idx = eid.to(torch.int64)
    sums = torch.zeros((R, E), dtype=torch.float32, device=x.device)
    for i in range(S):
        sums.scatter_add_(1, idx[:, i:i + 1], xf[:, i:i + 1])
    cnts = torch.zeros((R, E), dtype=torch.float32, device=x.device)
    cnts.scatter_add_(1, idx, torch.ones_like(xf))
    means = sums / torch.clamp(cnts, min=1.0)
    n_ev = torch.clamp(eid[:, S - 1] + 1, max=E).to(torch.int32)
    return means, n_ev


def detect_events(signal: torch.Tensor, p: Params):
    """(R, S) raw f32 -> (event means (R, E) f32 in normalized units,
    n_events (R,) int32) in the configuration's arithmetic."""
    x = robust_normalize(signal)
    E = p.max_events
    if p.early_quantization and p.fixed_point:
        xq = quantize_signal_fixed(x, p.frac_bits).to(torch.int32)
        means, n = segment_means(xq, boundary_mask_fixed(xq, p), E)
        return means / _f32(float(1 << p.frac_bits), means), n
    if p.early_quantization:
        x = dequantize_fixed(quantize_signal_fixed(x, p.frac_bits),
                             p.frac_bits)
    return segment_means(x, boundary_mask_float(x, p), E)


# --------------------------------------------------------------------------- #
# Quantization, seeds
# --------------------------------------------------------------------------- #
def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def quantize_events(events: torch.Tensor, valid: torch.Tensor,
                    p: Params) -> torch.Tensor:
    levels = 1 << p.quant_bits
    if not p.fixed_point:
        def f32(x):
            return _f32(x, events)
        zero = f32(0.0)
        n = torch.clamp(f32order.tree_sum(valid.to(torch.float32)), min=1.0)
        mean = f32order.tree_sum(torch.where(valid, events, zero)) / n
        d = events - mean.unsqueeze(-1)
        var = f32order.tree_sum(torch.where(valid, d * d, zero)) / n
        std = torch.sqrt(var) + f32(_EPS)
        z = d / std.unsqueeze(-1)
        clip = p.quant_clip_sigma
        inv_step = f32(1.0) / f32((2.0 * clip) / levels)
        zc = torch.clamp(z, f32(-clip), f32(clip - 1e-4))
        sym = torch.floor((zc + f32(clip)) * inv_step).to(torch.int32)
        return torch.clamp(sym, 0, levels - 1)
    f = p.frac_bits
    e = torch.round(events * _f32(float(1 << f), events)).to(
        torch.int32).to(torch.int64)
    v = valid.to(torch.int64)
    n = torch.clamp(v.sum(-1, keepdim=True), min=1)
    mean = _floordiv((e * v).sum(-1, keepdim=True), n)
    d = e - mean
    d2 = d >> 1
    var = _floordiv((d2 * d2 * v).sum(-1, keepdim=True), n) << 2
    s = torch.clamp(var, min=1)
    for _ in range(24):                       # integer Newton sqrt
        s = _floordiv(s + _floordiv(var, torch.clamp(s, min=1)), 2)
    std = torch.clamp(s, min=1)
    clip_q = int(round(p.quant_clip_sigma * (1 << f)))
    z_q = torch.clamp(_floordiv(d << f, std), -clip_q, clip_q - 1)
    step_q = (2 * clip_q) // levels
    sym = _floordiv(z_q + clip_q, max(step_q, 1))
    return torch.clamp(sym, 0, levels - 1).to(torch.int32)


def _mul32(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(x):
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX_C2)
    return x ^ (x >> 16)


def pack_seeds(symbols: torch.Tensor, n_events: torch.Tensor, p: Params):
    """(R, E) symbols -> (keys (R, E) uint32 values in int64, valid)."""
    E = symbols.shape[-1]
    s = symbols.to(torch.int64)
    key = torch.zeros_like(s)
    for j in range(p.seed_width):
        key = ((key << p.quant_bits) & MASK32) | torch.roll(s, -j, dims=-1)
    key = _mix32(key)
    valid = (torch.arange(E, device=symbols.device) + p.seed_width
             <= n_events.unsqueeze(-1))
    r = p.minimizer_radius
    if r > 0:
        kv = torch.where(valid, key, torch.full_like(key, MASK32))
        wmin = kv
        for d in range(1, r + 1):
            fill = torch.full_like(kv[..., :d], MASK32)
            wmin = torch.minimum(wmin, torch.minimum(
                torch.cat([fill, kv[..., :-d]], dim=-1),
                torch.cat([kv[..., d:], fill], dim=-1)))
        valid = valid & (kv == wmin)
    return key, valid


# --------------------------------------------------------------------------- #
# Query + frequency filter, vote filter
# --------------------------------------------------------------------------- #
def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = table.shape[0]
    flat = torch.clamp(idx, 0, n - 1).reshape(-1).to(torch.int64)
    return table.index_select(0, flat).reshape(idx.shape)


def query_index(keys, valid, index, p: Params):
    """Gather up to H entries of each seed's bucket, drop collisions and
    (with the frequency filter) keys counted more than ``thresh_freq``
    times.  Returns (t_pos (R, E, H), hit_valid, counters, probe planes)."""
    H = p.max_hits_per_seed
    bucket = (keys & (p.n_buckets - 1)).to(torch.int32)
    start = _take(index["bucket_start"], bucket)
    cnt_bucket = _take(index["bucket_start"], bucket + 1) - start
    j = torch.arange(H, dtype=torch.int32, device=keys.device)
    n_entries = index["entries_key"].shape[0]
    idx_c = torch.clamp(start.unsqueeze(-1) + j, max=n_entries - 1)
    got_key = _take(index["entries_key"], idx_c).to(torch.int64) & MASK32
    t_pos = _take(index["entries_pos"], idx_c)
    key_cnt = _take(index["entries_cnt"], idx_c)
    in_bucket = j < cnt_bucket.unsqueeze(-1)
    key_match = got_key == keys.unsqueeze(-1)
    raw_hit = in_bucket & key_match & valid.unsqueeze(-1)
    hit_valid = (raw_hit & (key_cnt <= p.thresh_freq) if p.use_freq_filter
                 else raw_hit)
    fm = key_match & in_bucket
    first = fm & (torch.cumsum(fm.to(torch.int32), dim=-1) == 1)
    red = (-2, -1)
    i32 = torch.int32
    counters = dict(
        n_seeds=valid.sum(-1).to(i32),
        n_bucket_probes=(torch.clamp(cnt_bucket, max=H) * valid).sum(-1).to(
            i32),
        n_hits_raw=raw_hit.sum(red).to(i32),
        n_hits_postfreq=hit_valid.sum(red).to(i32),
        n_hits_exact=torch.where(first & valid.unsqueeze(-1), key_cnt,
                                 torch.zeros_like(key_cnt)).sum(red).to(i32))
    probes = dict(bucket=bucket, valid=valid,
                  entry=torch.where(in_bucket & valid.unsqueeze(-1), idx_c,
                                    torch.full_like(idx_c, -1)))
    return t_pos, hit_valid, counters, probes


def vote_filter(q_pos, t_pos, valid, p: Params):
    R = q_pos.shape[0]
    red = (-2, -1)
    i32 = torch.int32
    if not p.use_vote_filter:
        return valid, dict(n_anchors_postvote=valid.sum(red).to(i32),
                           n_votes_cast=torch.zeros((R,), dtype=i32,
                                                    device=valid.device))
    v, nbins = p.voting_window_log2, p.vote_bins
    diag = (t_pos - q_pos) + DIAG_SHIFT
    w1 = ((diag >> v) % nbins).reshape(R, -1).to(torch.int64)
    w2 = (((diag >> v) + 1) % nbins).reshape(R, -1).to(torch.int64)
    ones = valid.reshape(R, -1).to(i32)
    votes = torch.zeros((R, nbins), dtype=i32, device=valid.device)
    votes.scatter_add_(1, w1, ones)
    votes.scatter_add_(1, w2, ones)
    v1 = torch.gather(votes, 1, w1).reshape(valid.shape)
    v2 = torch.gather(votes, 1, w2).reshape(valid.shape)
    keep = valid & (torch.maximum(v1, v2) >= p.thresh_voting)
    return keep, dict(n_anchors_postvote=keep.sum(red).to(i32),
                      n_votes_cast=(2 * valid.sum(red)).to(i32))


# --------------------------------------------------------------------------- #
# Chaining
# --------------------------------------------------------------------------- #
def sort_anchors(q_pos, t_pos, valid, p: Params):
    """Every anchor key [t:23 | q:8] of a read sorted, the first
    ``max_anchors`` kept; invalid anchors sort last."""
    n = q_pos.shape[0]
    t = t_pos.reshape(n, -1).to(torch.int32)
    q = torch.clamp(q_pos.reshape(n, -1), max=(1 << Q_BITS) - 1).to(
        torch.int32)
    key = torch.where(valid.reshape(n, -1), (t << Q_BITS) | q,
                      torch.full_like(t, INVALID_KEY))
    skey = torch.sort(key, dim=-1).values[:, :p.max_anchors]
    return ((skey & ((1 << Q_BITS) - 1)).to(torch.int32),
            (skey >> Q_BITS).to(torch.int32), skey != INVALID_KEY)


def chain_dp(q, t, valid, p: Params):
    """Banded DP over the sorted anchors: the full (N, A+B) score and
    start-diagonal arrays, the band window sliced each step in age order;
    the first argmax is the oldest best predecessor.  The candidate
    score is contracted into two fused multiply-adds, as the JAX package's
    compiled DP does."""
    N, A = q.shape
    B = p.chain_band
    dev = q.device
    neg_gap = -_f32(p.gap_cost, q)
    neg_skip = -_f32(p.skip_cost, q)
    w = _f32(p.anchor_score, q)
    neg = _f32(NEG, q)
    half_neg = _f32(NEG / 2, q)
    zero = _f32(0.0, q)
    f = torch.full((N, A + B), NEG, dtype=torch.float32, device=dev)
    d = torch.zeros((N, A + B), dtype=torch.int32, device=dev)
    sent = torch.full((N, B), SENT, dtype=torch.int32, device=dev)
    tp = torch.cat([sent, t.to(torch.int32)], dim=1)
    qp = torch.cat([sent, q.to(torch.int32)], dim=1)
    for i in range(A):
        ti, qi, vi = t[:, i:i + 1], q[:, i:i + 1], valid[:, i:i + 1]
        fw, dw = f[:, i:i + B], d[:, i:i + B]
        dt = ti - tp[:, i:i + B]
        dq = qi - qp[:, i:i + B]
        ok = (dt > 0) & (dq > 0) & (dt <= p.max_gap) & (dq <= p.max_gap)
        gap = torch.abs(dt - dq).to(torch.float32)
        skip = torch.minimum(dt, dq).to(torch.float32)
        cand = f32order.fma_f32(f32order.fma_f32(fw, neg_gap, gap), neg_skip,
                                skip)
        cand = torch.where(ok & (fw > half_neg), cand, neg)
        bj = torch.argmax(cand, dim=1, keepdim=True)
        best = torch.gather(cand, 1, bj)
        fi = torch.where(vi, w + torch.maximum(best, zero), neg)
        di = torch.where(best > zero, torch.gather(dw, 1, bj), ti - qi)
        f[:, i + B:i + B + 1] = fi
        d[:, i + B:i + B + 1] = di
    return f[:, B:], d[:, B:]


def best_chain(f, diag0, valid, p: Params):
    """Best and second-best (distinct window) chain -> (t_start, score,
    mapped)."""
    neg = _f32(NEG, f)
    fv = torch.where(valid, f, neg)
    i1 = torch.argmax(fv, dim=1, keepdim=True)
    s1 = torch.gather(fv, 1, i1)
    d1 = torch.gather(diag0, 1, i1)
    far = torch.abs(diag0 - d1) > (1 << p.voting_window_log2)
    s2 = torch.clamp(torch.where(valid & far, f, neg).max(
        dim=1, keepdim=True).values, min=0.0)
    mapped = ((s1 >= _f32(p.min_chain_score, f))
              & (s1 >= _f32(p.map_ratio, f) * s2))
    return (torch.clamp(d1, min=0).to(torch.int32)[:, 0], s1[:, 0],
            mapped[:, 0])


# --------------------------------------------------------------------------- #
# One block of reads
# --------------------------------------------------------------------------- #
class Mapped(NamedTuple):
    t_start: torch.Tensor     # (R,) int32
    score: torch.Tensor       # (R,) f32
    mapped: torch.Tensor      # (R,) bool
    n_events: torch.Tensor    # (R,) int32
    counters: Dict[str, torch.Tensor]   # COUNTERS, each (R,) int32
    probes: Dict[str, torch.Tensor]     # the query's bucket and entry ids


def map_reads(signal: torch.Tensor, index: Dict[str, torch.Tensor],
              p: Params, signal_dtype=None) -> Mapped:
    """Map a block of reads (R, S) f32 over ``index`` (``index_tensors``):
    every stage over every read, in the configuration's arithmetic.
    ``signal_dtype`` (e.g. ``torch.bfloat16``) rounds the raw signal to
    that type first."""
    if signal_dtype is not None:
        signal = signal.to(signal_dtype).to(torch.float32)
    ev, n_ev = detect_events(signal, p)
    ev_valid = (torch.arange(p.max_events, device=ev.device)
                < n_ev.unsqueeze(-1))
    keys, seed_valid = pack_seeds(quantize_events(ev, ev_valid, p), n_ev, p)
    t_pos, hit_valid, counters, probes = query_index(keys, seed_valid,
                                                     index, p)
    q_pos = torch.arange(p.max_events, dtype=torch.int32,
                         device=t_pos.device)[None, :, None].expand(
                             t_pos.shape)
    hit_valid, vc = vote_filter(q_pos, t_pos, hit_valid, p)
    sq, st, sv = sort_anchors(q_pos, t_pos, hit_valid, p)
    f, d0 = chain_dp(sq, st, sv, p)
    t_start, score, mapped = best_chain(f, d0, sv, p)
    i32 = torch.int32
    n_sorted = sv.sum(-1).to(i32)
    counters = dict(counters, **vc, n_events=n_ev.to(i32),
                    n_sorted=n_sorted, n_dp_pairs=n_sorted * p.chain_band)
    return Mapped(t_start, score, mapped, n_ev.to(i32),
                  {k: counters[k] for k in COUNTERS}, probes)
