"""Wrapper of the banded chaining-DP kernels (csrc/chain_dp.cu) + their
stage backend.  Both run one warp per read: the default ``chain_band == 32``
launches the shipped kernel (one lane per band slot), any other band the
band kernel at B = min(chain_band, A) (ceil(B / 32) slots a lane, in
registers up to B = 64 and in a scratch row of 16 bytes a slot beyond).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.core import stages
from repro_torch.core.config import MarsConfig
from repro_torch.kernels.chain_dp.ref import chain_dp_ref

BAND = 32             # the shipped kernel's band: one lane per slot
REGISTER_BAND = 64    # the band kernel keeps up to 2 slots a lane in registers


def chain_dp(q: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
             cfg: MarsConfig):
    """q, t: (N, A) int32 sorted by (t, q); valid: (N, A) bool.
    Returns (f (N, A) f32, diag0 (N, A) int32)."""
    K.check_tensor("chain_dp q", q, torch.int32, (None, None))
    K.check_tensor("chain_dp t", t, torch.int32, q.shape)
    K.check_tensor("chain_dp valid", valid, torch.bool, q.shape)
    if q.device.type == "cpu":
        return chain_dp_ref(q, t, valid, cfg)
    if cfg.chain_band < 1:
        raise ValueError(f"chain_dp kernel: chain_band={cfg.chain_band}; the "
                         "band holds at least one predecessor")
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
        costs = (cfg.max_gap, f32(cfg.gap_cost), f32(cfg.skip_cost),
                 f32(cfg.anchor_score))
        ptrs = (q.data_ptr(), t.data_ptr(), valid.data_ptr(), f.data_ptr(),
                d.data_ptr(), n, A)
        if cfg.chain_band == BAND:
            err = build.lib().chain_dp_rows(*ptrs, *costs,
                                            K.stream_handle(q))
        else:
            # every earlier anchor of a read is in a band of A or wider
            B = min(cfg.chain_band, A)
            scratch = (torch.empty((n, B, 4), dtype=torch.int32,
                                   device=q.device)
                       if B > REGISTER_BAND else None)
            err = build.lib().chain_dp_band_rows(
                *ptrs, B, *costs,
                None if scratch is None else scratch.data_ptr(),
                K.stream_handle(q))
        build.check(err, "chain_dp")
        K.LAUNCHES["chain_dp"] += 1
    return f, d


def _dp_kernels(state, cfg, index):
    """Stage body: the banded DP of every read at A = max_anchors in one
    launch."""
    return stages.dp_with(state, cfg, index,
                          dp=lambda q, t, v: chain_dp(q, t, v, cfg))


stages.register_backend("dp", stages.KERNELS, _dp_kernels,
                        primitive=chain_dp)
