"""Wrapper of the banded chaining-DP kernel (csrc/chain_dp.cu) + its stage
backend.  The kernel runs one warp per read with one lane per band slot,
so it takes ``chain_band == 32`` (the default) only and raises otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.core import stages
from repro_torch.core.config import MarsConfig
from repro_torch.kernels.chain_dp.ref import chain_dp_ref

BAND = 32


def chain_dp(q: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
             cfg: MarsConfig):
    """q, t: (N, A) int32 sorted by (t, q); valid: (N, A) bool.
    Returns (f (N, A) f32, diag0 (N, A) int32)."""
    K.check_tensor("chain_dp q", q, torch.int32, (None, None))
    K.check_tensor("chain_dp t", t, torch.int32, q.shape)
    K.check_tensor("chain_dp valid", valid, torch.bool, q.shape)
    if q.device.type == "cpu":
        return chain_dp_ref(q, t, valid, cfg)
    if cfg.chain_band != BAND:
        raise ValueError(f"chain_dp kernel: chain_band={cfg.chain_band}; the "
                         f"kernel holds one band slot per lane of a warp "
                         f"and takes chain_band={BAND} only")
    return _chain_dp_kernel(q, t, valid, cfg)


def _chain_dp_kernel(q, t, valid, cfg: MarsConfig):
    q, t, valid = q.contiguous(), t.contiguous(), valid.contiguous()
    K.check_cuda("chain_dp", q, t, valid)
    n, A = q.shape
    f = torch.empty((n, A), dtype=torch.float32, device=q.device)
    d = torch.empty((n, A), dtype=torch.int32, device=q.device)
    if n and A:
        from repro_torch.kernels import build
        f32 = lambda x: float(np.float32(x))      # noqa: E731
        err = build.lib().chain_dp_rows(
            q.data_ptr(), t.data_ptr(), valid.data_ptr(), f.data_ptr(),
            d.data_ptr(), n, A, cfg.max_gap, f32(cfg.gap_cost),
            f32(cfg.skip_cost), f32(cfg.anchor_score), K.stream_handle(q))
        build.check(err, "chain_dp")
        K.LAUNCHES["chain_dp"] += 1
    return f, d


stages.register_backend("dp", stages.KERNELS, primitive=chain_dp)
