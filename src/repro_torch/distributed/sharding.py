"""Layouts of the sharded mapper's arrays on a mesh (``launch/mesh.py``).

The mapping half of the reference package's ``distributed/sharding.py``:
raw reads shard over EVERY mesh axis (the MARS "channel stripe": each rank
maps its own reads), and the reference index is either replicated on every
rank or range-partitioned by bucket over the 'model' axis
(``core/index.INDEX_AXIS``) for the ``query:ring`` / ``query:a2a``
backends (core/distributed.py).  Where JAX places a global array with a
``NamedSharding``, a rank here takes its own block (``shard``) of the
same host array, and ``gather_rows`` brings per-read blocks back to every
rank in shard order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.index import INDEX_AXIS, PARTITIONED_INDEX_KEYS


class Layout(NamedTuple):
    """The mesh axes an array's leading axis is split over, row-major (the
    first axis the slowest); () replicates the array on every rank."""
    axes: Tuple[str, ...]


def mapping_chunk_shardings(mesh, partitioned_index: bool = False):
    """Layouts for the sharded chunk program (``pipeline.sharded_chunk_fn``):
    (the (R, S) signals' layout, the index's): the reads over every axis;
    the index replicated, or with ``partitioned_index=True`` the per-key
    layouts of ``partitioned_index_shardings``."""
    sig = Layout(tuple(mesh.axis_names))
    if partitioned_index:
        return sig, partitioned_index_shardings(mesh)
    return sig, Layout(())


def partitioned_index_shardings(mesh) -> Dict[str, Layout]:
    """Layouts of the ``core/index.partition_index`` planes: the leading
    partition axis over ``INDEX_AXIS``, so each rank holds exactly its
    resident bucket-range partition (paper Section 6.3)."""
    if INDEX_AXIS not in mesh.axis_names:
        raise ValueError(f"a partitioned index lives on the '{INDEX_AXIS}' "
                         f"axis, absent from mesh {mesh.axis_names}")
    return {k: Layout((INDEX_AXIS,)) for k in PARTITIONED_INDEX_KEYS}


def shard(x, mesh, layout: Layout) -> torch.Tensor:
    """This rank's block of ``x`` (a numpy array or a tensor) under
    ``layout``, on the mesh's device: the leading axis cut into as many
    equal blocks as ``layout.axes`` have ranks, block number the rank's
    row-major coordinate over those axes."""
    block, count = 0, 1
    for a in layout.axes:
        block = block * mesh.shape[a] + mesh.coords[a]
        count *= mesh.shape[a]
    n = x.shape[0]
    if n % count:
        raise ValueError(f"a leading extent of {n} does not split into "
                         f"{count} blocks over {layout.axes}")
    step = n // count
    part = x[block * step:(block + 1) * step]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
        if mesh.device.type == "cuda":
            # pinned + non_blocking: the upload does not wait for queued
            # device work
            return part.pin_memory().to(mesh.device, non_blocking=True)
    return part.to(mesh.device)


def local_rows(x, mesh) -> torch.Tensor:
    """This rank's reads of a whole chunk ``x`` (R, ...)."""
    return shard(x, mesh, mapping_chunk_shardings(mesh)[0])


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows ``x`` (R_loc, ...) as the whole chunk (R, ...), in
    shard order, on every rank."""
    return mesh.all_gather_rows(x)


def local_partition(parts, mesh) -> Dict[str, torch.Tensor]:
    """This rank's resident partition of ``core/index.partition_index``'s
    planes: each (1, ...), the partition of the rank's 'model'
    coordinate."""
    lay = partitioned_index_shardings(mesh)
    return {k: shard(parts[k], mesh, lay[k]) for k in PARTITIONED_INDEX_KEYS}
