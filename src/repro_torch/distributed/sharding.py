"""Sharding rules of the port: where the LM's arrays and the sharded
mapper's live on a mesh (``launch/mesh.py``).

**The LM half** (the reference's ``param_spec``, ``param_shardings``,
``batch_specs``, ``cache_spec``, ``cache_shardings``, ``replicated``), the
same rules over the port's meshes and ``AbstractMesh``:

  * TP — attention heads, FFN hidden, vocab, experts over 'model';
  * FSDP — the other big dim over the DP axes ('pod', 'data': every axis
    but 'model');
  * batches over the DP axes; KV caches shard batch over DP and heads (or
    head_dim when the head count does not divide) over 'model'.

An axis applies to a dim only where the dim divides by its size (else a
suffix of an axis tuple is tried, then the dim is replicated), and axes
absent from the mesh are dropped.  A spec is a tuple with one entry a dim:
None (replicated), an axis name, or a tuple of names (a one-name tuple is
written as the name, as ``PartitionSpec`` normalises it).  A
``NamedSharding`` pairs a spec with its mesh.  ``block`` cuts a rank's
block of a whole array, ``gather`` puts the whole array back together on
every rank, and ``shard_tree`` / ``gather_tree`` do it leaf by leaf.

**The mapping half**: raw reads shard over EVERY mesh axis (the MARS
"channel stripe": each rank maps its own reads), and the reference index is
either replicated on every rank or range-partitioned by bucket over the
'model' axis (``core/index.INDEX_AXIS``) for the ``query:ring`` /
``query:a2a`` backends (core/distributed.py).  Where JAX places a global
array with a ``NamedSharding``, a rank here takes its own block (``shard``)
of the same host array, and ``gather_rows`` brings per-read blocks back to
every rank in shard order.
"""
from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import INDEX_AXIS, PARTITIONED_INDEX_KEYS
from repro_torch.launch.mesh import axis_size, dp_axes

Spec = Tuple[Any, ...]


class NamedSharding(NamedTuple):
    """A spec on its mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec


# --------------------------------------------------------------------------- #
# The LM: parameters, batches, caches
# --------------------------------------------------------------------------- #
def _entry(axes):
    """A spec entry as ``PartitionSpec`` writes it: one name bare."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _maybe(mesh, dim: int, axes):
    """Use ``axes`` for this dim only if divisible; else replicate.  Axes
    not present in the mesh are dropped (pure-FSDP meshes have no
    'model')."""
    if axes is None:
        return None
    if isinstance(axes, str):
        if axes not in mesh.axis_names:
            return None
    else:
        axes = tuple(a for a in axes if a in mesh.axis_names)
        if not axes:
            return None
    if dim % axis_size(mesh, axes) == 0:
        return axes
    # try a suffix of the axis tuple (e.g. drop 'pod', keep 'data')
    if isinstance(axes, tuple) and len(axes) > 1:
        return _maybe(mesh, dim, axes[1:])
    return None


def _spec(mesh, shape: Tuple[int, ...], template) -> Spec:
    assert len(template) == len(shape), (template, shape)
    return tuple(_entry(_maybe(mesh, d, t)) for d, t in zip(shape, template))


def _name(path: str) -> str:
    """The leaf's name: the last key of a path joined by "/" (the
    reference's) or "." (``model.flatten``'s)."""
    return re.split(r"[/.]", path)[-1]


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    fsdp = dp_axes(mesh)
    tp = "model"
    name = _name(path)
    nd = len(shape)

    if name == "embed":
        return _spec(mesh, shape, (tp, fsdp))
    if name == "lm_head":
        return _spec(mesh, shape, (fsdp, tp))
    if name == "enc_pos":
        return (None,) * nd
    if name == "router":                      # (G, d, E): E over model (EP)
        return _spec(mesh, shape, (None, None, tp))
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "sh_gate", "sh_up",
                "in_proj"):
        if nd == 4:                           # MoE expert stack (G,E,d,f)
            return _spec(mesh, shape, (None, tp, fsdp, None))
        return _spec(mesh, shape, (None, fsdp, tp))
    if name in ("wo", "w_down", "sh_down", "out_proj"):
        if nd == 4:                           # (G,E,f,d)
            return _spec(mesh, shape, (None, tp, None, fsdp))
        return _spec(mesh, shape, (None, tp, fsdp))
    # norms, conv weights, scalars: replicated
    return (None,) * nd


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths joined by "/"."""
    return {k: (_map_with_path(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in tree.items()}


def param_shardings(params_abstract: Dict, mesh) -> Dict:
    """A tree of ``NamedSharding`` matching a (possibly abstract: meta
    device) parameter tree."""
    return _map_with_path(lambda p, leaf: NamedSharding(
        mesh, param_spec(p, tuple(leaf.shape), mesh)), params_abstract)


def batch_specs(cfg, mesh, batch_abstract: Dict) -> Dict:
    dp = dp_axes(mesh)

    def one(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("tokens", "labels"):
            return NamedSharding(mesh, _spec(mesh, shape, (dp, None)))
        if name == "ctx":                       # (B, Tc, d)
            return NamedSharding(mesh, _spec(mesh, shape, (dp, None, None)))
        if name == "signals":                   # (R, S) raw reads
            return NamedSharding(mesh, _spec(mesh, shape, (dp, None)))
        return NamedSharding(mesh, (None,) * len(shape))
    return {k: one(k, v) for k, v in batch_abstract.items()}


def cache_spec(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    dp = dp_axes(mesh)
    name = _name(path)
    if name in ("k", "v", "k_scale", "v_scale"):   # (G, B, T, K, Dh|1)
        head_ax = _maybe(mesh, shape[3], "model")
        dh_ax = None if head_ax else _maybe(mesh, shape[4], "model")
        return (None, _entry(_maybe(mesh, shape[1], dp)), None, head_ax,
                dh_ax)
    if name == "state":                        # (G, B, H, N, P)
        return (None, _entry(_maybe(mesh, shape[1], dp)),
                _maybe(mesh, shape[2], "model"), None, None)
    if name == "conv":                         # (G, B, W-1, d_inner)
        return (None, _entry(_maybe(mesh, shape[1], dp)), None,
                _maybe(mesh, shape[3], "model"))
    return (None,) * len(shape)


def cache_shardings(cache_abstract: Dict, mesh) -> Dict:
    return _map_with_path(lambda p, leaf: NamedSharding(
        mesh, cache_spec(p, tuple(leaf.shape), mesh)), cache_abstract)


def replicated(tree_abstract: Dict, mesh) -> Dict:
    return _map_with_path(lambda p, leaf: NamedSharding(
        mesh, (None,) * len(leaf.shape)), tree_abstract)


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry's axes as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of an array of ``shape``."""
    return tuple(n // axis_size(mesh, axes_of(e) or None)
                 for n, e in zip(shape, spec))


def block(x, spec: Spec, mesh):
    """This rank's block of the whole array ``x`` (numpy or torch; a view)
    under ``spec``: along each sharded dim, the block of the rank's
    row-major coordinate over the entry's axes (``mesh.coords``)."""
    index = []
    for n, e in zip(x.shape, spec):
        axes = axes_of(e)
        count, pos = 1, 0
        for a in axes:
            pos = pos * mesh.shape[a] + mesh.coords[a]
            count *= mesh.shape[a]
        if n % count:
            raise ValueError(f"a dim of {n} does not split into {count} "
                             f"blocks over {axes}")
        step = n // count
        index.append(slice(pos * step, (pos + 1) * step))
    return x[tuple(index)]


def gather(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole array from every rank's block ``x`` under ``spec``, on
    every rank (``Mesh.all_gather`` along each sharded dim)."""
    for d, e in enumerate(spec):
        if e is not None:
            x, = mesh.all_gather([x], [d], axes_of(e))
    return x


def shard_tree(tree: Dict, shardings: Dict, device=None) -> Dict:
    """A rank's blocks of a tree of whole arrays (numpy or torch), each
    leaf cut by its ``NamedSharding`` and copied (so the rank keeps the
    block alone), on ``device`` (default: the sharding mesh's)."""
    def one(leaf, sh: NamedSharding):
        part = block(leaf, sh.spec, sh.mesh)
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.array(part))
        else:
            part = part.clone()
        return part.to(device if device is not None else sh.mesh.device)
    return _zip_map(one, tree, shardings)


def gather_tree(tree: Dict, shardings: Dict) -> Dict:
    """The whole tree from a rank's blocks, on every rank of the mesh."""
    specs = _zip_map(lambda leaf, sh: sh.spec, tree, shardings)
    mesh = next(iter(_flat(shardings).values())).mesh
    return gather_specs(tree, specs, mesh)


def gather_specs(tree: Dict, specs: Dict, mesh, all_gather=None) -> Dict:
    """Every leaf of ``tree`` gathered along each dim its spec (a congruent
    tree of specs) splits, a dim at a time: the leaves split over the same
    axes go in one packed ``Mesh.all_gather`` (the same calls, in the same
    order, on every rank), or ``all_gather(tensors, dims, axes)`` (one
    with a gradient: ``models.part.gather_fsdp``)."""
    all_gather = all_gather or mesh.all_gather
    leaves, todo = _flat(tree), {}
    for path, spec in _flat(specs).items():
        todo[path] = [(d, axes_of(e)) for d, e in enumerate(spec)
                      if e is not None]
    while any(todo.values()):
        groups: Dict[Tuple[str, ...], list] = {}
        for path, steps in todo.items():
            if steps:
                d, axes = steps.pop(0)
                groups.setdefault(axes, []).append((path, d))
        for axes, items in groups.items():
            got = all_gather([leaves[p] for p, _ in items],
                             [d for _, d in items], axes)
            leaves.update({p: g for (p, _), g in zip(items, got)})
    return _unflat(leaves, tree)


def _flat(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat: Dict[str, Any], like: Dict, prefix: str = "") -> Dict:
    """``flat``'s leaves in the structure of ``like`` (empty dicts kept)."""
    return {k: _unflat(flat, v, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in like.items()}


def _zip_map(fn, tree: Dict, other: Dict) -> Dict:
    return {k: (_zip_map(fn, v, other[k]) if isinstance(v, dict)
                else fn(v, other[k])) for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# The sharded mapper
# --------------------------------------------------------------------------- #


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
