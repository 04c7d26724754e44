"""Quantized collectives of the reference's ``collectives`` module: the
int8 block-scaled all-reduce, its error feedback, and the int8 KV-cache
quantizer.

Each block of 256 values is scaled to int8 before the all-reduce (4x fewer
bytes on the wire than f32), the int8 values summed in int32, and the sum
rescaled.  Stochastic rounding keeps the quantizer unbiased (its noise from
an explicit ``torch.Generator``); an error-feedback buffer makes the
compression asymptotically lossless across steps.  ``psum_int8`` runs on
one axis of a ``launch.mesh.Mesh`` (the reference's ``shard_map`` axis).

Every division by a constant is a product with its f32 reciprocal, as XLA
compiles the reference (``/ 127.0``); divisions by a runtime value stay
divisions.  Without noise the results equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

F32 = torch.float32
BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    flat = x.reshape(-1)
    r = (-n) % BLOCK
    if r:
        flat = torch.cat([flat, flat.new_zeros(r)])
    return flat, n


def quantize_int8(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """x: any shape f32/bf16 -> (q int8 (nb, BLOCK), scale f32 (nb, 1), n).
    With ``generator`` (on x's device) the rounding is stochastic."""
    flat, n = _pad_to_block(x.to(F32))
    blocks = flat.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    y = blocks / scale
    if generator is not None:                 # stochastic rounding
        noise = torch.rand(y.shape, generator=generator, dtype=F32,
                           device=y.device) - 0.5
        y = y + noise
    q = torch.clamp(torch.round(y), -127, 127)
    return q.to(torch.int8), scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int,
                    shape) -> torch.Tensor:
    blocks = q.to(F32) * scale
    return blocks.reshape(-1)[:n].reshape(shape)


def psum_int8(x: torch.Tensor, mesh, axis,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """All-reduce of ``x`` over ``axis`` of ``mesh`` with an int8 payload.

    Values are quantized to int8, rescaled to the per-block scale shared
    by the axis (the max of every rank's), summed in int32, and rescaled.
    Wire bytes: ~1/4 of an f32 all-reduce (and the scales, 1/256 of it).
    """
    q, scale, n = quantize_int8(x, generator)
    # shared scale across participants so the int32 sum is coherent
    scale_max = mesh.all_reduce(scale, axis, op="max")
    requant = torch.clamp(torch.round(q.to(F32) * (scale / scale_max)),
                          -127, 127).to(torch.int8)
    acc = mesh.all_reduce(requant.to(torch.int32), axis)
    out = acc.to(F32) * scale_max
    return out.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    return fn(*trees)


class ErrorFeedback:
    """Residual accumulator for error-feedback compression (a tree like the
    parameters'; the residual lives beside the optimizer state)."""

    @staticmethod
    def init(params: Dict) -> Dict:
        return _tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                               device=p.device), params)

    @staticmethod
    def apply(grads: Dict, residual: Dict):
        """returns (compress_input, new_residual_fn) — the caller quantizes
        compress_input, then calls new_residual_fn(dequantized)."""
        g_plus = _tree_map(lambda g, r: g.to(F32) + r, grads, residual)

        def new_residual(dequant):
            return _tree_map(lambda gp, dq: gp - dq.to(F32), g_plus, dequant)
        return g_plus, new_residual


def quantize_kv_int8(kv: torch.Tensor):
    """Per-(token, head) int8 KV-cache quantization: (..., Dh) blocks.
    Returns (int8 values, f32 scales of shape (..., 1)), equal to the
    reference's as ``jax.jit`` compiles it."""
    x = kv.to(F32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    # XLA compiles the division by the constant 127 as a product with its
    # f32 reciprocal (the model's path is compiled); a true division
    # differs in the last bit of some scales
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_int8(q: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(F32) * scale.to(F32)).to(dtype)
