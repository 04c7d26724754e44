"""The int8 KV-cache quantizer of the reference's ``collectives`` module.

Only ``quantize_kv_int8`` / ``dequantize_kv_int8`` are ported here: the int8
KV cache of the LM serving path needs them.  The int8 gradient collectives
(``quantize_int8``, ``psum_int8``, ``ErrorFeedback``) belong to the
distributed LM (ROADMAP queue 1 item 2c).
"""
from __future__ import annotations

import torch

F32 = torch.float32


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
