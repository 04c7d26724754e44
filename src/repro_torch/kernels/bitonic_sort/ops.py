"""Wrapper of the bitonic row-sort kernel (csrc/bitonic_sort.cu) + its
stage backend.

Rows are padded with INT32_MAX to ``max(128, next_pow2(L))`` lanes, as the
reference package's ``sort_batch`` pads them (the kernel pads in registers,
8 keys a thread), and sorted by one CTA per row (several short rows share
one).  A row that pads past ``MAX_BLOCK`` (8192) does not fit one CTA's
1024 threads; ``sort_batch`` sorts such rows with ``jnp.sort``, its own
route past one kernel block, and so does this wrapper with ``torch.sort`` on
the keys' device, counted as ``sort_rows_library`` (on the mapping path
L <= 4096, so only an oversized config reaches it).
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.core import stages
from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref

MAX_BLOCK = 8192


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """keys: (N, L) int32 -> each row sorted ascending (the ``sort``
    primitive of the chaining phase)."""
    K.check_tensor("bitonic_sort", keys, torch.int32, (None, None))
    L = keys.shape[1]
    if max(128, _next_pow2(L)) > MAX_BLOCK:
        # the reference wrapper's documented route past one block
        K.LAUNCHES["sort_rows_library"] += 1
        return torch.sort(keys, dim=-1).values
    if keys.device.type == "cpu":
        return sort_rows_ref(keys)
    return _sort_rows_kernel(keys)


def _sort_rows_kernel(keys: torch.Tensor) -> torch.Tensor:
    """Rows are padded to ``max(128, next_pow2(L))`` lanes in the kernel's
    registers; only the L real lanes are read and written."""
    n, L = keys.shape
    Lp = max(128, _next_pow2(L))
    keys = keys.contiguous()
    K.check_cuda("bitonic_sort", keys)
    out = torch.empty_like(keys)
    if n and L:
        from repro_torch.kernels import build
        err = build.lib().bitonic_sort_rows(
            keys.data_ptr(), out.data_ptr(), n, L, Lp, K.stream_handle(keys))
        build.check(err, "bitonic_sort")
        K.LAUNCHES["bitonic_sort"] += 1
    return out


def _sort_kernels(state, cfg, index):
    """Stage body: every read's E*H anchor keys sorted by the kernel in one
    launch (3072 keys padded to 4096 lanes at the default config)."""
    return stages.sort_with(state, cfg, index, sorter=sort_rows)


stages.register_backend("sort", stages.KERNELS, _sort_kernels,
                        primitive=sort_rows)
