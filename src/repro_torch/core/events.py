"""Signal-to-event conversion (event detection).

The two-sample t-statistic segmentation of RawHash2, with the reference
package's three arithmetic paths, one per mode:

* ``ms_fixed`` (MARS, paper Section 5.2): the raw signal is robust-
  normalized, quantized EARLY to a Q-format integer signal, and segmented
  with a sqrt-free integer boundary test, a local-max peak pick and integer
  segment sums;
* ``ms_float``: the same early quantization, dequantized back to f32, then
  the float boundary test;
* ``rh2`` (the RawHash2 baseline): the float boundary test on the
  normalized signal.

Every function works on a batch of reads (R, S).

Exactness notes (the results equal the reference package bit for bit):
``robust_normalize`` interpolates the median as ``lo*0.5 + hi*0.5``; the
rounding of ``quantize_signal_fixed`` is half-to-even (``torch.round``);
integer prefix sums run in int64 so no window sum wraps; the integer
segment sums are exact and converted to f32 once.  The float path follows
the reference's compiled CPU arithmetic operation for operation
(core/f32order.py): XLA's order for the f32 prefix sums, its rsqrt and its
fused multiply-adds, and segment sums added in sample order.
"""
from __future__ import annotations

import torch

from repro_torch.core import f32order
from repro_torch.core.config import MarsConfig

_EPS = 1e-6

# Early-quantization clip: normalized signals are clipped to +-SIGNAL_CLIP
# sigmas before the Q-format conversion, so |xq| <= SIGNAL_CLIP * 2^frac_bits
# — the static amplitude bound the integer boundary test's overflow check
# (fixed_tstat_bounds) is derived from.
SIGNAL_CLIP = 8.0


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A config float as an f32 scalar tensor on ``like``'s device (never
    promoted to f64).  ``torch.full`` fills it on the device: no host copy,
    so no stream synchronisation."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------------------- #
# Normalization + early quantization (paper Section 5.2)
# --------------------------------------------------------------------------- #
def robust_normalize(signal: torch.Tensor) -> torch.Tensor:
    """Per-read median/MAD normalization (f32).  signal: (R, S).

    One sort per read.  |x - med| over the sorted signal is two sorted runs
    (descending left of the median, ascending right of it), so the MAD is
    rank-selected from their stable merge instead of sorting again.
    """
    R, S = signal.shape
    m1, m2 = (S - 1) // 2, S // 2
    half = _f32(0.5, signal)
    xs = torch.sort(signal, dim=-1).values
    med = xs[:, m1:m1 + 1] * half + xs[:, m2:m2 + 1] * half      # (R, 1)
    h = S // 2
    dev_lo = torch.flip(med - xs[:, :h], dims=(1,)).contiguous()  # ascending
    dev_hi = (xs[:, h:] - med).contiguous()                       # ascending
    # rank of each element in the stable merge: a-elements count the
    # b-elements strictly smaller, b-elements the a-elements <= them
    ar_lo = torch.arange(h, device=signal.device)
    ar_hi = torch.arange(S - h, device=signal.device)
    ra = ar_lo + torch.searchsorted(dev_hi, dev_lo, side="left")
    rb = ar_hi + torch.searchsorted(dev_lo, dev_hi, side="right")

    def at(k):
        zero = torch.zeros((), dtype=torch.float32, device=signal.device)
        return (torch.where(ra == k, dev_lo, zero).sum(-1, keepdim=True)
                + torch.where(rb == k, dev_hi, zero).sum(-1, keepdim=True))

    mad = at(m1) * half + at(m2) * half
    # the reference's compiled chunk program contracts 1.4826*mad + eps
    # into one fused multiply-add
    scale = f32order.fma_f32(_f32(_EPS, signal), mad, _f32(1.4826, signal))
    return (signal - med) / scale


def quantize_signal_fixed(signal_norm: torch.Tensor, frac_bits: int,
                          clip: float = SIGNAL_CLIP) -> torch.Tensor:
    """Early quantization: normalized f32 -> Q(15-f).f int16 (half-to-even)."""
    scaled = torch.clamp(signal_norm, -clip, clip) * _f32(
        float(1 << frac_bits), signal_norm)
    return torch.round(scaled).to(torch.int16)


def dequantize_fixed(x: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """Q-format int -> f32 normalized units (a multiplication by 2^-f, as
    XLA compiles the reference's division by the constant 2^f)."""
    return x.to(torch.float32) * _f32(1.0 / (1 << frac_bits), x)


# --------------------------------------------------------------------------- #
# t-statistic boundary detection
# --------------------------------------------------------------------------- #
def _window_index(S: int, w: int, device):
    idx = torch.arange(S, device=device)
    return idx, torch.clamp(idx - w, min=0), torch.clamp(idx + w, max=S)


def _windowed_sums(x: torch.Tensor, w: int):
    """Left/right window sums of x and x^2 at each position.

    x: (R, S) integer.  Returns int32 (sum_l, sum_r, sq_l, sq_r), each
    (R, S), where sum_l[i] = sum(x[i-w:i]) and sum_r[i] = sum(x[i:i+w])
    (zero-padded at the borders).  The prefix sums run in int64; the window
    sums themselves fit int32 (``fixed_tstat_bounds``), so they equal the
    reference's wrapping int32 differences.
    """
    R, S = x.shape
    x64 = x.to(torch.int64)
    zero = torch.zeros((R, 1), dtype=torch.int64, device=x.device)
    c = torch.cat([zero, torch.cumsum(x64, dim=1)], dim=1)        # (R, S+1)
    c2 = torch.cat([zero, torch.cumsum(x64 * x64, dim=1)], dim=1)
    idx, lo, hi = _window_index(S, w, x.device)
    i32 = torch.int32
    sum_l = (c[:, idx] - c[:, lo]).to(i32)
    sum_r = (c[:, hi] - c[:, idx]).to(i32)
    sq_l = (c2[:, idx] - c2[:, lo]).to(i32)
    sq_r = (c2[:, hi] - c2[:, idx]).to(i32)
    return sum_l, sum_r, sq_l, sq_r


def _windowed_sums_float(x: torch.Tensor, w: int):
    """``_windowed_sums`` of an f32 signal: differences of the f32 prefix
    sums of x and x*x, each taken in the reference's order
    (``f32order.prefix_sum``)."""
    R, S = x.shape
    zero = torch.zeros((R, 1), dtype=torch.float32, device=x.device)
    c = torch.cat([zero, f32order.prefix_sum(x)], dim=1)          # (R, S+1)
    c2 = torch.cat([zero, f32order.prefix_sum(x * x)], dim=1)
    idx, lo, hi = _window_index(S, w, x.device)
    return (c[:, idx] - c[:, lo], c[:, hi] - c[:, idx],
            c2[:, idx] - c2[:, lo], c2[:, hi] - c2[:, idx])


def tstat_float(x: torch.Tensor, w: int) -> torch.Tensor:
    """|mean_r - mean_l| / sqrt(var_l/w + var_r/w + eps) over (R, S) f32,
    as the reference's compiled code evaluates it: the divisions by w are
    multiplications by f32(1/w), ``sq/w - mean^2`` and ``v/w + eps`` are
    fused multiply-adds, and the division by the square root is a
    multiplication by ``f32order.rsqrt``."""
    sum_l, sum_r, sq_l, sq_r = _windowed_sums_float(x, w)
    inv_w = _f32(1.0, x) / w
    mean_l, mean_r = sum_l * inv_w, sum_r * inv_w
    zero = _f32(0.0, x)
    var_l = torch.maximum(f32order.fma_f32(-(mean_l * mean_l), sq_l, inv_w),
                          zero)
    var_r = torch.maximum(f32order.fma_f32(-(mean_r * mean_r), sq_r, inv_w),
                          zero)
    denom = f32order.fma_f32(_f32(_EPS, x), var_l + var_r, inv_w)
    return torch.abs(mean_r - mean_l) * f32order.rsqrt(denom)


def boundary_mask_float(x: torch.Tensor, cfg: MarsConfig) -> torch.Tensor:
    """Peak-picked boundary mask (R, S) bool, float path."""
    t = tstat_float(x, cfg.tstat_window)
    return _peak_pick(t, t > _f32(cfg.tstat_threshold, t), cfg)


def fixed_tstat_bounds(cfg: MarsConfig):
    """Static worst-case int32 magnitudes of the integer boundary test,
    derived from the early-quantization amplitude bound
    M = SIGNAL_CLIP * 2^frac_bits.  Every one must stay below 2^31 for the
    int32 arithmetic of ``boundary_mask_fixed`` (and the fused CUDA kernel,
    which evaluates the identical expressions) to be exact."""
    w = cfg.tstat_window
    M = int(SIGNAL_CLIP * (1 << cfg.frac_bits))
    tau2 = int(round(cfg.tstat_threshold ** 2))
    eps = 1 << max(2 * cfg.frac_bits - 8, 0)
    diff = (2 * w * M) >> 2
    return dict(
        sq=w * M * M,
        ssd=2 * w * w * M * M,
        lhs=diff * diff * w,
        rhs=tau2 * (((2 * w * w * M * M) >> 4) + eps),
    )


def fixed_tstat_in_range(cfg: MarsConfig) -> bool:
    """True iff the integer boundary test cannot overflow int32 for cfg."""
    return max(fixed_tstat_bounds(cfg).values()) < (1 << 31)


def check_fixed_tstat_range(cfg: MarsConfig) -> None:
    """Static overflow guard for the fixed-point boundary test: fail fast
    instead of silently wrapping int32 and flipping boundary decisions."""
    if fixed_tstat_in_range(cfg):
        return
    w_max = 0
    while fixed_tstat_in_range(cfg.replace(tstat_window=w_max + 1)):
        w_max += 1
    bounds = fixed_tstat_bounds(cfg)
    worst = max(bounds, key=bounds.get)
    raise ValueError(
        f"fixed-point boundary test overflows int32 for tstat_window="
        f"{cfg.tstat_window} at frac_bits={cfg.frac_bits} ({worst} bound "
        f"{bounds[worst]:#x} >= 2^31); the largest safe tstat_window for "
        f"this config is {w_max} — lower tstat_window/frac_bits or use the "
        "float path (fixed_point=False)")


def boundary_scores_fixed(xq: torch.Tensor, cfg: MarsConfig):
    """The integer (sqrt-free) boundary test on the Q-format signal.

    Compares (sum_r - sum_l)^2 * w > tau^2 * (ssd_l + ssd_r) in int32 with a
    >>2 / >>4 prescale on the two sides (ssd = w*sq - sum^2).  Returns
    (score (R, S) f32, above (R, S) bool); the f32 score lhs / (rhs + 1)
    only orders peaks, the comparison itself is integer.
    """
    check_fixed_tstat_range(cfg)
    w = cfg.tstat_window
    sum_l, sum_r, sq_l, sq_r = _windowed_sums(xq, w)
    diff = (sum_r - sum_l) >> 2                            # prescale 1/4
    ssd_l = w * sq_l - sum_l * sum_l                       # w^2 * var_l
    ssd_r = w * sq_r - sum_r * sum_r
    tau2 = int(round(cfg.tstat_threshold ** 2))
    eps = 1 << (2 * cfg.frac_bits - 8)                     # small int epsilon
    lhs = diff * diff * w
    rhs = tau2 * (((ssd_l + ssd_r) >> 4) + eps)
    score = lhs.to(torch.float32) / (rhs.to(torch.float32)
                                     + _f32(1.0, xq))
    return score, lhs > rhs


def boundary_mask_fixed(xq: torch.Tensor, cfg: MarsConfig) -> torch.Tensor:
    """Peak-picked boundary mask (R, S) bool on the Q-format int signal."""
    score, above = boundary_scores_fixed(xq, cfg)
    return _peak_pick(score, above, cfg)


def _peak_pick(score: torch.Tensor, above: torch.Tensor,
               cfg: MarsConfig) -> torch.Tensor:
    """Local-max suppression: keep i if above[i] and score[i] is the max in
    a +-peak_window neighborhood (ties broken toward the left).  With
    ``min_dwell > 1`` a greedy left-to-right scan then drops every peak
    closer than ``min_dwell`` samples to the last one kept."""
    r = cfg.peak_window
    S = score.shape[-1]
    pad = torch.full_like(score[..., :r], float("-inf"))
    padded = torch.cat([pad, score, pad], dim=-1)           # (R, S + 2r)
    wmax = score
    lmax = score
    for d in range(1, r + 1):
        left = padded[..., r - d:r - d + S]                 # score[i-d]
        right = padded[..., r + d:r + d + S]                # score[i+d]
        wmax = torch.maximum(wmax, torch.maximum(left, right))
        lmax = torch.maximum(lmax, left)
    is_peak = (score >= wmax) & (score >= lmax) & above
    if cfg.min_dwell <= 1:
        # the peak window already enforces spacing
        return is_peak
    return _dwell_scan(is_peak, cfg.min_dwell)


def _dwell_scan(is_peak: torch.Tensor, min_dwell: int) -> torch.Tensor:
    """The reference's sequential dwell rule (a ``lax.scan`` over sample
    positions), every row at once: keep peak i when i - last >= min_dwell,
    where ``last`` is the position of the last peak kept (initially
    -min_dwell)."""
    last = torch.full(is_peak.shape[:-1], -min_dwell, dtype=torch.int64,
                      device=is_peak.device)
    kept = torch.zeros_like(is_peak)
    for i in range(is_peak.shape[-1]):
        keep = is_peak[..., i] & (i - last >= min_dwell)
        kept[..., i] = keep
        last = torch.where(keep, i, last)
    return kept


# --------------------------------------------------------------------------- #
# Segment means
# --------------------------------------------------------------------------- #
def segment_sum_in_order(x: torch.Tensor, eid: torch.Tensor, n_seg: int,
                         valid_len: int):
    """The segment sums of the float event means, as the reference's
    ``jax.ops.segment_sum`` (XLA's CPU scatter) adds them: one sample per
    row at a time, so each sum is ((0 + x[a]) + x[b]) + ... in sample order.
    x: (R, S) f32; eid: (R, S) int32 in [0, n_seg).  Returns (sums
    (R, n_seg) f32, counts (R, n_seg) f32) over the samples i < valid_len.
    The kernels plan swaps in the ``segment_sum`` kernel
    (``stages.register_segment_sum``)."""
    R = x.shape[0]
    idx = eid[:, :valid_len].to(torch.int64)
    sums = torch.zeros((R, n_seg), dtype=torch.float32, device=x.device)
    for i in range(valid_len):
        sums.scatter_add_(1, idx[:, i:i + 1], x[:, i:i + 1])
    cnts = torch.zeros((R, n_seg), dtype=torch.float32, device=x.device)
    cnts.scatter_add_(1, idx, torch.ones_like(x[:, :valid_len]))
    return sums, cnts


def segment_means(x: torch.Tensor, boundaries: torch.Tensor, valid_len: int,
                  max_events: int, max_abs: int = None,
                  segment_sum=segment_sum_in_order):
    """Per-event means of an integer signal.  x: (R, S) int, boundaries:
    (R, S) bool.  Returns (means (R, E) f32, n_events (R,) int32, counts
    (R, E) f32).

    Event id at sample i = cumsum(boundaries)[i] clipped to E-1; samples
    past ``valid_len`` are dropped.  The segment sums are exact integers;
    ``max_abs`` certifies the amplitude bound under which the reference's
    f32 prefix sums are exact too (S * max_abs < 2^24), so
    means = f32(sum) / max(f32(count), 1) is the reference's value bit for
    bit.  A float signal, or one without that bound, takes
    ``segment_means_reference`` (its sums from ``segment_sum``), as in the
    reference package.
    """
    if (x.dtype.is_floating_point or max_abs is None
            or x.shape[-1] * max_abs >= (1 << 24)):
        return segment_means_reference(x, boundaries, valid_len, max_events,
                                       segment_sum)
    R, S = x.shape
    E = max_events
    dev = x.device
    sample_valid = torch.arange(S, device=dev) < valid_len
    eid = _event_ids(boundaries, E)
    seg = torch.where(sample_valid, eid, torch.full_like(eid, E))
    xv = torch.where(sample_valid, x.to(torch.int64),
                     torch.zeros((), dtype=torch.int64, device=dev))
    sums = torch.zeros((R, E + 1), dtype=torch.int64, device=dev)
    sums.scatter_add_(1, seg.to(torch.int64), xv)
    cnts = torch.zeros((R, E + 1), dtype=torch.int64, device=dev)
    cnts.scatter_add_(1, seg.to(torch.int64),
                      sample_valid.to(torch.int64).expand(R, S).contiguous())
    sums_f = sums[:, :E].to(torch.float32)
    cnts_f = cnts[:, :E].to(torch.float32)
    means = sums_f / torch.clamp(cnts_f, min=1.0)
    return means, _n_events(eid, valid_len, E), cnts_f


def _event_ids(boundaries: torch.Tensor, E: int) -> torch.Tensor:
    """Event id of each sample: the inclusive count of boundaries, clipped
    to E-1.  (R, S) int32."""
    eid = torch.cumsum(boundaries.to(torch.int32), dim=1, dtype=torch.int32)
    return torch.clamp(eid, max=E - 1)


def _n_events(eid: torch.Tensor, valid_len: int, E: int) -> torch.Tensor:
    return torch.clamp(eid[:, valid_len - 1] + 1, max=E).to(torch.int32)


def segment_means_reference(x: torch.Tensor, boundaries: torch.Tensor,
                            valid_len: int, max_events: int,
                            segment_sum=segment_sum_in_order):
    """``segment_means`` of any signal as the reference's two
    ``segment_sum`` scatters compute it: each event's f32 sum adds its
    samples in sample order, starting from 0.  ``segment_sum`` has
    ``segment_sum_in_order``'s contract (torch's own scatters on the card
    add in no fixed order)."""
    E = max_events
    eid = _event_ids(boundaries, E)
    sums, cnts = segment_sum(x.to(torch.float32).contiguous(), eid, E,
                             valid_len)
    means = sums / torch.clamp(cnts, min=1.0)
    return means, _n_events(eid, valid_len, E), cnts


def early_quantize(signal: torch.Tensor, cfg: MarsConfig) -> torch.Tensor:
    """Robust-normalize raw (R, S) f32 signals and quantize them to the
    Q-format: (R, S) int32, the input of the fixed-point path (the
    ``cheap_fused`` and ``event_detect`` kernels)."""
    if not (cfg.early_quantization and cfg.fixed_point):
        raise ValueError(
            f"mode {cfg.mode!r}: the Q-format int32 signal feeds the "
            "fixed-point path (ms_fixed) only")
    x = robust_normalize(signal)
    return quantize_signal_fixed(x, cfg.frac_bits).to(torch.int32)


def detect_quantized(xq: torch.Tensor, cfg: MarsConfig):
    """Event detection on the Q-format signal (R, S) int: boundary test,
    peak pick and segment means.  Returns (event_means (R, E) f32 in
    normalized units, n_events (R,) i32, counts (R, E) f32)."""
    b = boundary_mask_fixed(xq, cfg)
    means, n, cnts = segment_means(
        xq, b, xq.shape[-1], cfg.max_events,
        max_abs=int(SIGNAL_CLIP * (1 << cfg.frac_bits)))
    means = means / _f32(float(1 << cfg.frac_bits), means)
    return means, n, cnts


def detect_events(signal: torch.Tensor, cfg: MarsConfig,
                  segment_sum=segment_sum_in_order):
    """Event detection over a batch.  signal: (R, S) f32 raw.

    Returns (event_means (R, E) f32 in normalized units, n_events (R,) i32,
    counts (R, E) f32).  Dispatches on cfg.early_quantization / fixed_point
    as the reference's ``detect_events`` does; the float paths take their
    event sums from ``segment_sum``.
    """
    if cfg.early_quantization and cfg.fixed_point:
        return detect_quantized(early_quantize(signal, cfg), cfg)
    x = robust_normalize(signal)
    if cfg.early_quantization:
        # early quantization, float compute: the quantize/dequantize round
        # trip models the precision loss
        x = dequantize_fixed(quantize_signal_fixed(x, cfg.frac_bits),
                             cfg.frac_bits)
    b = boundary_mask_float(x, cfg)
    return segment_means(x, b, signal.shape[-1], cfg.max_events,
                         segment_sum=segment_sum)
