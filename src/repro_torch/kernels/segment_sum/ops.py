"""Wrapper of the in-order segment-sum kernel (csrc/segment_sum.cu).

A helper of the float event detection (``events.segment_means_reference``),
not the port of a TPU kernel: the reference package computes these sums
with ``jax.ops.segment_sum``, which XLA's CPU scatter adds in sample order.
On the card, torch's ``index_add_``/``scatter_add_`` use atomics whose order
is not fixed, so the f32 sums would differ from the CPU's and from run to
run; the kernel adds each row's samples in order instead.  It registers as
the kernels plan's segment sum (``stages.register_segment_sum``); the
reference plan keeps the plain loop.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.core import stages
from repro_torch.kernels.segment_sum.ref import segment_sum_ref


def segment_sum(x: torch.Tensor, eid: torch.Tensor, n_seg: int,
                valid_len: int):
    """x: (R, S) f32; eid: (R, S) int32 in [0, n_seg); the samples
    i < valid_len count.  Returns (sums (R, n_seg) f32, counts (R, n_seg)
    f32), each sum taken in sample order."""
    K.check_tensor("segment_sum x", x, torch.float32, (None, None))
    K.check_tensor("segment_sum eid", eid, torch.int32, x.shape)
    if not 0 < valid_len <= x.shape[1]:
        raise ValueError(f"segment_sum: valid_len {valid_len} outside "
                         f"(0, {x.shape[1]}]")
    if x.device.type == "cpu":
        return segment_sum_ref(x, eid, n_seg, valid_len)
    return _segment_sum_kernel(x, eid, n_seg, valid_len)


def _segment_sum_kernel(x, eid, n_seg: int, valid_len: int):
    from repro_torch.kernels import build
    x, eid = x.contiguous(), eid.contiguous()
    K.check_cuda("segment_sum", x, eid)
    R, S = x.shape
    sums = torch.empty((R, n_seg), dtype=torch.float32, device=x.device)
    cnts = torch.empty((R, n_seg), dtype=torch.float32, device=x.device)
    if R:
        err = build.lib().segment_sum_rows(
            x.data_ptr(), eid.data_ptr(), sums.data_ptr(), cnts.data_ptr(),
            R, S, valid_len, n_seg, K.stream_handle(x))
        build.check(err, "segment_sum")
        K.LAUNCHES["segment_sum"] += 1
    return sums, cnts


stages.register_segment_sum(stages.KERNELS, segment_sum)
