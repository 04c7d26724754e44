"""Wrapper of the clipping gather kernels (csrc/pluto_lookup.cu) + their
registration as the ``query`` stage's kernel backend.

``lookup(table, idx)`` keeps the reference wrapper's contract
(src/repro/kernels/pluto_lookup/ops.py): a (N,) table gives
``idx.shape``, a (W, N) packed-row table gives (W, *idx.shape); indices
(int32 on the mapping path; the kernel casts others) are clipped to
[0, N-1]; the table's dtype is preserved.  Tables and indices are integers
of at most 32 bits, on either device: the kernel gathers int32 words (a
narrower table is widened and cast back exactly), and a 64-bit value would
not survive that, so one raises.
The TPU grid's BQ/BT padding is not needed.  ``seeding.query_index`` issues
one 1-D lookup (the bucket offsets, ``pluto_lookup``) and one packed-row
lookup (the entry rows, ``pluto_lookup_rows``) per chunk.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.core import stages
from repro_torch.kernels.pluto_lookup.ref import lookup_ref


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[..., i] = table[..., clip(idx[i], 0, N-1)] for a (N,) or (W, N)
    table (the ``query`` stage's gather primitive)."""
    if table.ndim not in (1, 2) or table.shape[-1] == 0:
        raise ValueError(f"lookup: expected a non-empty (N,) or (W, N) "
                         f"table, got {tuple(table.shape)}")
    if table.dtype.is_floating_point or idx.dtype.is_floating_point:
        raise TypeError(f"lookup: integer table and indices, got "
                        f"{table.dtype} and {idx.dtype}")
    if table.dtype.itemsize > 4 or idx.dtype.itemsize > 4:
        raise TypeError(f"lookup: table and indices of at most 32 bits, got "
                        f"{table.dtype} and {idx.dtype}")
    if table.device.type == "cpu":
        return lookup_ref(table, idx)
    return _lookup_kernel(table, idx)


def _lookup_kernel(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels import build
    words = table.to(torch.int32).contiguous()
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    K.check_cuda("lookup", words, flat)
    n, q = words.shape[-1], flat.shape[0]
    out = torch.empty(words.shape[:-1] + (q,), dtype=torch.int32,
                      device=words.device)
    if q:
        stream = K.stream_handle(words)
        if words.ndim == 1:
            err = build.lib().pluto_lookup(words.data_ptr(), flat.data_ptr(),
                                           out.data_ptr(), q, n, stream)
            build.check(err, "pluto_lookup")
            K.LAUNCHES["pluto_lookup"] += 1
        else:
            err = build.lib().pluto_lookup_rows(
                words.data_ptr(), flat.data_ptr(), out.data_ptr(), q, n,
                words.shape[0], stream)
            build.check(err, "pluto_lookup_rows")
            K.LAUNCHES["pluto_lookup_rows"] += 1
    return out.reshape(table.shape[:-1] + idx.shape).to(table.dtype)


def _query_kernels(state, cfg, index):
    """Stage body: the hash-table query with the lookup kernels' gathers
    (one ``pluto_lookup`` and one ``pluto_lookup_rows`` launch a chunk)."""
    return stages.query_with(state, cfg, index, gather=lookup)


stages.register_backend("query", stages.KERNELS, _query_kernels,
                        primitive=lookup)
