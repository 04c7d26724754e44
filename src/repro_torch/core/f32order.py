"""The f32 evaluation order of the reference package's compiled CPU
arithmetic, for the float event-detection path (``ms_float``, ``rh2``).

The reference's float path is f32 throughout, and XLA's CPU compiler fixes
an order for each of its sums and an approximation for its reciprocal
square root.  A torch op that computes the same real number in another
order differs in the last bits, and a t-statistic near its threshold then
flips a boundary.  So the port evaluates exactly XLA's sequence of f32
operations, each one a separately rounded torch op, which gives the same
bits on the CPU and on a CUDA card:

* ``prefix_sum``: ``jnp.cumsum`` lowers to a ``reduce_window`` that XLA's
  ``ReduceWindowRewriter`` turns into a blocked scan of base 16: a
  sequential scan inside each block of 16, the block totals scanned the
  same way (recursively), and each block's exclusive prefix added to it.
* ``tree_sum``: a ``jnp.sum`` over more than 32 elements goes through
  XLA's ``TreeReductionRewriter``: windows of 32, padded with zeros
  evenly at both ends, each summed sequentially, then the partial sums
  reduced the same way.
* ``rsqrt``: ``a / jnp.sqrt(b)`` is rewritten to ``a * rsqrt(b)``, and the
  CPU emits rsqrt as the x86 ``RSQRTPS`` approximation followed by two
  Newton-Raphson steps, ``y + (-0.5*y) * ((x*y)*y - 1)``, whose two
  multiply-adds LLVM contracts into fused multiply-adds.  ``RSQRTPS`` returns a 12-bit mantissa that depends only on
  the exponent's parity and the top 10 mantissa bits of its input: the
  2048 codes in ``_RSQRTPS_STEPS`` were read from the instruction on an
  Intel core for x = 2^p * (1 + t/1024), p in {0, 1}, t in [0, 1024).
  ``tests/test_torch_float.py`` holds ``rsqrt`` equal to the reference's
  ``jax.lax.rsqrt`` for every f32 in [1, 4) and across the exponents.

XLA's CPU backend lets LLVM contract a multiply that feeds an add into one
fused multiply-add (``fma_f32`` here), and it turns a division by a
constant into a multiplication by the constant's f32 reciprocal;
``events.tstat_float`` and ``quantization.quantize_events_float`` follow
both where the reference's compiled code does.
"""
from __future__ import annotations

from typing import Dict

import torch

SCAN_BASE = 16          # ReduceWindowRewriter's block length on the CPU
SUM_WINDOW = 32         # TreeReductionRewriter's window on the CPU

# RSQRTPS codes: for each exponent parity p, the code at t = 0 and the
# decrements from each t to the next (one digit each, 1023 per parity).
# The result is the f32 with exponent 126 and mantissa bits code << 11.
_RSQRTPS_STEPS = (
    (4094, (
        "4444444444443444444444344444434444344443444344434443443443443443"
        "4434434344343443434344343434343434343434334343433434334343343343"
        "4334334333433433433343334333433334333343333343333343333333433333"
        "3333343333333333333333333333333333333333332333333333332333333323"
        "3333323333323333233332333323332333233323332332333233233233233233"
        "2332332332323323323233232323323232332323232323323232323232323232"
        "3232232323232322323232232322323223232232322322322323223223223223"
        "2232223223223222322232232223222322232222322232222322223222232222"
        "3222223222222322222232222222322222222322222222223222222222222222"
        "2322222222222222222222222222222222222222222222221222222222222222"
        "2122222222222122222222212222222212222221222222122222212222212222"
        "2122221222212222122221222212221222212221222122212221222122212221"
        "2212221221222122122212212212212221221221221221221221221212212212"
        "2121221221221212212122122121221212212121221212212121221212122121"
        "2121221212121212122121212121212121212212121212121212121212112121"
        "212121212121212112121212121211212121211212121121212112121211212")),
    (1695, (
        "3233332333323332333323323332332333233233233233233232332323323233"
        "2323233232323232332323232323223232323232322323232232322323223223"
        "2322322322322322322322322232232223222322232223222322223222232222"
        "3222223222223222222322222223222222222322222222222222322222222222"
        "2222222222222222222222222222222122222222222222122222222221222222"
        "2122222221222222122222122222122221222212222122221222212221222122"
        "2122212221222122122212212221221221222122122122122122122122122121"
        "2212212212122121221221212212122121212212121221212122121212121221"
        "2121212121212212121212121212121212121211212121212121212112121212"
        "1211212121121212112121211212112121121211212112121121121211211212"
        "1121121121211211211211211211211211211211211121121121121112112111"
        "2112111211211121121112111211121112111211121112111211121111211121"
        "1112111211112111121111211112111121111121111211111211111211111211"
        "1112111111211111121111112111111211111112111111112111111112111111"
        "1121111111111211111111111211111111111121111111111111112111111111"
        "111111111112111111111111111111111111111111111111111111111111111")),
)


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


def _seq_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, strictly left to right."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis, strictly left to right."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last axis of an f32 tensor, in XLA's CPU
    order (the blocked scan of base ``SCAN_BASE``)."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        return _seq_scan(x)
    nb = -(-n // SCAN_BASE)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BASE - n))
    inner = _seq_scan(xp.reshape(*x.shape[:-1], nb, SCAN_BASE))
    outer = prefix_sum(inner[..., -1])
    carry = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    out = inner + carry.unsqueeze(-1)
    return out.reshape(*x.shape[:-1], nb * SCAN_BASE)[..., :n]


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` along the last axis of an f32 tensor, in XLA's CPU order
    (windows of ``SUM_WINDOW``, then the partial sums)."""
    n = x.shape[-1]
    if n <= SUM_WINDOW:
        return _seq_sum(x)
    nb = -(-n // SUM_WINDOW)
    pad = nb * SUM_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return tree_sum(_seq_sum(xp.reshape(*x.shape[:-1], nb, SUM_WINDOW)))


_TABLES: Dict[torch.device, torch.Tensor] = {}


def _rsqrtps_table(device: torch.device) -> torch.Tensor:
    """The 2048 RSQRTPS results as int32 f32 bit patterns (exponent 126),
    indexed by parity * 1024 + the top 10 mantissa bits."""
    if device not in _TABLES:
        codes = []
        for first, steps in _RSQRTPS_STEPS:
            codes.append(first)
            for d in steps:
                codes.append(codes[-1] - int(d))
        bits = torch.tensor([(126 << 23) | (c << 11) for c in codes],
                            dtype=torch.int32)
        _TABLES[device] = bits.to(device)
    return _TABLES[device]


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.rsqrt`` of an f32 tensor as XLA's CPU computes it: the
    RSQRTPS approximation, then two Newton-Raphson steps for positive
    normal inputs (zero, subnormal, negative and infinite inputs keep the
    approximation: +-inf, +-inf, NaN and 0)."""
    x = x.contiguous()
    bits = x.view(torch.int32)
    e = (bits >> 23) & 0xFF
    p = (e - 127) & 1
    k = (e - 127 - p) >> 1
    code = _rsqrtps_table(x.device)[p * 1024 + ((bits >> 13) & 0x3FF)]
    y = (code - (k << 23)).view(torch.float32)
    half = torch.full((), -0.5, dtype=torch.float32, device=x.device)
    one = torch.full_like(x, -1.0)
    for _ in range(2):
        y = fma_f32(y, y * half, fma_f32(one, x * y, y))
    normal = (e > 0) & (e < 255) & (bits >= 0)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=x.device)
    special = torch.where(
        e == 0, torch.copysign(inf, x),
        torch.where(bits < 0, torch.full_like(x, float("nan")),
                    torch.where(torch.isnan(x), x, torch.zeros_like(x))))
    return torch.where(normal, y, special)
