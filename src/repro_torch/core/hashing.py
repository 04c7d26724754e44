"""Seed hashing: pack w consecutive quantized event symbols into hash keys.

RawHash2-style: a seed is the concatenation of q-bit symbols from w
consecutive events, mixed through an avalanche hash so the direct-address
bucket table (index.py) spreads uniformly.

torch has no full uint32 arithmetic, so keys are carried as int64 tensors
holding the uint32 value (always in [0, 2^32)); every wrapping multiply is
split into 16-bit halves so no intermediate leaves the int64 range.  The
numpy twins (used offline by the index builder) work on uint64 with
explicit 32-bit masking.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import MarsConfig

_MIX_C1 = 0x85EBCA6B
_MIX_C2 = 0xC2B2AE35
MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) — the uint32 wrapping
    multiply, with both partial products below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX_C2)
    x = x ^ (x >> 16)
    return x


def mix32_np(x: np.ndarray) -> np.ndarray:
    """numpy twin on uint64 with explicit 32-bit masking."""
    m = np.uint64(0xFFFFFFFF)
    x = x.astype(np.uint64) & m
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(_MIX_C1)) & m
    x = x ^ (x >> np.uint64(13))
    x = (x * np.uint64(_MIX_C2)) & m
    x = x ^ (x >> np.uint64(16))
    return x


def pack_seeds(symbols: torch.Tensor, n_events: torch.Tensor,
               cfg: MarsConfig):
    """symbols: (..., E) int in [0, 2^q); n_events: (...,).  Returns (keys
    (..., E) int64 uint32 values, valid (..., E) bool) — seed i covers
    events [i, i+w).  The symbol window wraps around circularly, so the
    keys at invalid slots are the same garbage the reference computes."""
    E = symbols.shape[-1]
    w, q = cfg.seed_width, cfg.quant_bits
    s = symbols.to(torch.int64)
    key = torch.zeros_like(s)
    for j in range(w):
        key = ((key << q) & MASK32) | torch.roll(s, -j, dims=-1)
    key = mix32(key)
    idx = torch.arange(E, device=symbols.device)
    valid = idx + w <= n_events.unsqueeze(-1)
    return key, valid


def minimizer_mask(keys: torch.Tensor, valid: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Winnowing subsample: keep seed i iff its key is the minimum within
    +-radius positions (the same rule on read and reference keeps matches
    consistent).  radius=0 -> keep all valid seeds."""
    if radius <= 0:
        return valid
    big = MASK32
    kv = torch.where(valid, keys, torch.full_like(keys, big))
    wmin = kv
    for d in range(1, radius + 1):
        fill = torch.full_like(kv[..., :d], big)
        left = torch.cat([fill, kv[..., :-d]], dim=-1)
        right = torch.cat([kv[..., d:], fill], dim=-1)
        wmin = torch.minimum(wmin, torch.minimum(left, right))
    return valid & (kv == wmin)


def minimizer_mask_np(keys: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return np.ones(keys.shape[0], bool)
    big = np.uint32(0xFFFFFFFF)
    kv = keys.astype(np.uint32)
    wmin = kv.copy()
    for d in range(1, radius + 1):
        left = np.concatenate([np.full(d, big, np.uint32), kv[:-d]])
        right = np.concatenate([kv[d:], np.full(d, big, np.uint32)])
        wmin = np.minimum(wmin, np.minimum(left, right))
    return kv == wmin


def pack_seeds_np(symbols: np.ndarray, cfg: MarsConfig) -> np.ndarray:
    """Offline numpy twin used by the index builder.  symbols: (N,) int."""
    N = symbols.shape[0]
    w, q = cfg.seed_width, cfg.quant_bits
    n = N - w + 1
    key = np.zeros(n, np.uint64)
    for j in range(w):
        key = (key << np.uint64(q)) | symbols[j:j + n].astype(np.uint64)
    return mix32_np(key).astype(np.uint32)
