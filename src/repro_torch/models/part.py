"""The LM's layout on a mesh, and the collectives its layers issue.

The reference pins activation layouts with ``with_sharding_constraint``
and lets GSPMD place the collectives.  The port runs one process a rank
(``launch.mesh.Mesh``, SPMD): each rank holds exactly the blocks that
``distributed.sharding``'s ``param_spec`` and ``cache_spec`` give it, and
the layers issue the collectives themselves:

* FSDP: before a layer group runs, its leaves are gathered over the DP
  axes (``gather_fsdp``: one packed message an axis) and dropped after;
* TP: a weight whose output dim lies over 'model' is column-parallel (the
  rank computes its columns: its heads, its hidden units, its vocabulary
  rows); one whose contracted dim lies over 'model' is row-parallel (the
  rank's product is a partial sum, summed over 'model': ``tp_sum``);
* EP: experts over 'model' (``moe.py``);
* the batch over the DP axes (``sharding.batch_specs``).  The residual
  stream between blocks stays replicated over 'model' (not sequence
  parallel): where the reference constrains it to ('dp', 'tp', None), every
  rank of a 'model' line keeps its tokens whole, and each block's output
  is summed over 'model' once.

Sharding changes no value beyond the order of those partial sums.
``constrain`` stays at the reference's call sites as a no-op (its template
checked).  A mesh of one device, or none, runs the single-device path.
The sharded train step is not ported yet (``check_trainable``).
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch

F32 = torch.float32


def sharded(mesh) -> bool:
    """Whether ``mesh`` spans several devices."""
    return mesh is not None and mesh.size > 1


def check_trainable(mesh) -> None:
    """Refuse a sharded train step: gradients through the mesh's
    collectives are the next slice of the port."""
    if sharded(mesh):
        raise NotImplementedError(
            f"the sharded train step (a mesh of {mesh.size} devices) is not "
            "ported yet: ROADMAP queue 1 item 2c-ii (make_train_step on a "
            "mesh, ZeRO-3 moments, the global norm across shards)")


def constrain(x: torch.Tensor, mesh, tmpl: Sequence) -> torch.Tensor:
    """x unchanged: the layers place their collectives explicitly."""
    if mesh is not None:
        assert len(tmpl) == x.ndim, (tmpl, x.shape)
    return x


def tp_size(mesh) -> int:
    if not sharded(mesh) or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


def tp_index(mesh) -> int:
    """This rank's coordinate along 'model' (0 without TP)."""
    return mesh.coords["model"] if tp_size(mesh) > 1 else 0


def tp_sum(x: torch.Tensor, mesh, dtype=None) -> torch.Tensor:
    """The sum over 'model' of every rank's partial ``x``, accumulated in
    f32 and rounded once to ``dtype`` (default ``x``'s)."""
    dtype = dtype or x.dtype
    if tp_size(mesh) == 1:
        return x.to(dtype)
    return mesh.all_reduce(x.to(F32), "model").to(dtype)


def tp_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every 'model' rank's block of ``x`` along ``dim``, in order."""
    if tp_size(mesh) == 1:
        return x
    return mesh.all_gather([x], [dim % x.ndim], "model")[0]


def tp_block(x: torch.Tensor, dim: int, n_local: int, mesh) -> torch.Tensor:
    """This rank's block of ``n_local`` along ``dim`` of a whole ``x``
    (``x`` itself where it holds no more)."""
    if x.shape[dim] == n_local:
        return x
    i = tp_index(mesh) * n_local
    return x.narrow(dim, i, n_local)


@functools.lru_cache(maxsize=64)
def _param_specs(cfg, axis_names: Tuple[str, ...],
                 shape: Tuple[int, ...]) -> Dict:
    from repro_torch.distributed.sharding import param_spec
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as T
    mesh = AbstractMesh(shape, axis_names)

    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else param_spec(prefix + k, tuple(v.shape), mesh)
                for k, v in tree.items()}
    return walk(T.init_params(cfg, None, "meta"), "")


def param_specs(cfg, mesh) -> Dict:
    """``param_spec`` of every leaf of ``cfg``'s parameter tree on
    ``mesh``, as a tree (computed once a config and mesh shape)."""
    return _param_specs(cfg, tuple(mesh.axis_names),
                        tuple(mesh.shape.values()))


def batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The DP axes a batch of ``batch`` rows is split over
    (``sharding.batch_specs``); () replicates it."""
    from repro_torch.distributed.sharding import _maybe, axes_of
    from repro_torch.launch.mesh import dp_axes
    return axes_of(_maybe(mesh, batch, dp_axes(mesh)))


def batch_block(x, axes: Tuple[str, ...], mesh):
    """This rank's rows of a whole batch ``x`` split over ``axes``."""
    if x is None or not axes:
        return x
    from repro_torch.distributed.sharding import block
    return block(x, (axes,) + (None,) * (x.ndim - 1), mesh)


def gather_fsdp(tree: Dict, specs: Dict, mesh) -> Dict:
    """The tree with every leaf's dim over DP axes (its FSDP dim) gathered
    whole, leaving its 'model' blocks: one ``all_gather`` an axis carries
    every leaf split over the same axes."""
    from repro_torch.distributed.sharding import gather_specs
    dp_only = _map_specs(lambda spec: tuple(
        None if e == "model" else e for e in spec), specs)
    return gather_specs(tree, dp_only, mesh)


def _map_specs(fn, specs: Dict) -> Dict:
    return {k: _map_specs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in specs.items()}
