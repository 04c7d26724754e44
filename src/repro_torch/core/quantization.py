"""Event quantization: normalized event means -> q-bit symbols.

RawHash2 quantizes events into a small alphabet so that nearby signal levels
share a symbol (noise tolerance).  MARS keeps the scheme but moves the
raw-signal quantization earlier (events.py) and runs this step in integer
arithmetic on the fixed-point path; the float modes (``ms_float``,
``rh2``) quantize in f32.

Fixed point: every division is a signed FLOOR division (``torch.div(...,
rounding_mode="floor")``), as the reference's ``//``; the arithmetic runs
in int64, which equals the reference's int32 results because no
intermediate exceeds int32 (the variance carries a >>1 prescale).

Float: the sums over the E events take the reference's compiled order
(``f32order.tree_sum``), and the division by the constant step is a
multiplication by its f32 reciprocal, as XLA compiles it.
"""
from __future__ import annotations

import torch

from repro_torch.core import f32order
from repro_torch.core.config import MarsConfig

_EPS = 1e-6


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def quantize_events_float(events: torch.Tensor, valid: torch.Tensor,
                          cfg: MarsConfig) -> torch.Tensor:
    """events: (R, E) f32 in normalized units; valid: (R, E) bool.  Returns
    (R, E) int32 symbols in [0, 2^q): each read's valid events are
    z-scored and binned into ``quant_levels`` steps over +-clip sigmas."""
    def f32(x):
        return torch.full((), x, dtype=torch.float32, device=events.device)
    zero = f32(0.0)
    n = torch.clamp(f32order.tree_sum(valid.to(torch.float32)), min=1.0)
    mean = f32order.tree_sum(torch.where(valid, events, zero)) / n
    d = events - mean.unsqueeze(-1)
    var = f32order.tree_sum(torch.where(valid, d * d, zero)) / n
    std = torch.sqrt(var) + f32(_EPS)
    z = d / std.unsqueeze(-1)
    clip = cfg.quant_clip_sigma
    inv_step = f32(1.0) / f32((2.0 * clip) / cfg.quant_levels)
    zc = torch.clamp(z, f32(-clip), f32(clip - 1e-4))
    sym = torch.floor((zc + f32(clip)) * inv_step).to(torch.int32)
    return torch.clamp(sym, 0, cfg.quant_levels - 1)


def quantize_events_fixed(events_q: torch.Tensor, valid: torch.Tensor,
                          cfg: MarsConfig) -> torch.Tensor:
    """Integer-arithmetic quantization.  events_q: (R, E) int event means in
    the Q-format of cfg.frac_bits; valid: (R, E) bool.  Returns (R, E) int32
    symbols in [0, 2^q)."""
    v = valid.to(torch.int64)
    e = events_q.to(torch.int64)
    n = torch.clamp(v.sum(-1, keepdim=True), min=1)
    mean = _floordiv((e * v).sum(-1, keepdim=True), n)
    d = e - mean
    d2 = d >> 1
    var = _floordiv((d2 * d2 * v).sum(-1, keepdim=True), n) << 2
    # integer sqrt via Newton iterations (fixed 24 steps covers int32 range)
    s = torch.clamp(var, min=1)
    for _ in range(24):
        s = _floordiv(s + _floordiv(var, torch.clamp(s, min=1)), 2)
    std = torch.clamp(s, min=1)
    # z in Q-format: z_q = d * 2^f / std ; symbol = floor((z+clip)/step)
    f = cfg.frac_bits
    clip_q = int(round(cfg.quant_clip_sigma * (1 << f)))
    z_q = _floordiv(d << f, std)
    z_q = torch.clamp(z_q, -clip_q, clip_q - 1)
    step_q = (2 * clip_q) // cfg.quant_levels
    sym = _floordiv(z_q + clip_q, max(step_q, 1))
    return torch.clamp(sym, 0, cfg.quant_levels - 1).to(torch.int32)


def quantize_events(events: torch.Tensor, valid: torch.Tensor,
                    cfg: MarsConfig) -> torch.Tensor:
    """Dispatch on the arithmetic path.  ``events`` is f32 in normalized
    units (events.py already folded the Q-format scale back)."""
    if not cfg.fixed_point:
        return quantize_events_float(events, valid, cfg)
    scale = torch.full((), float(1 << cfg.frac_bits), dtype=torch.float32,
                       device=events.device)
    eq = torch.round(events * scale).to(torch.int32)
    return quantize_events_fixed(eq, valid, cfg)
