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

Gradients (the sharded train step).  The loss is computed alike on every
rank, and every collective is an autograd function whose backward is its
adjoint, chosen by whether the ranks that consume its output compute the
same thing (a replicated computation: the residual stream over 'model',
the routed MoE batch over DP) or different things (a sharded one: each
rank's rows, heads, columns or experts).  Replicated to sharded, the
gradient is summed over the ranks; sharded to replicated, each rank keeps
its own part:

* ``gather_fsdp`` (all-gather of a leaf's block over the DP axes):
  reduce-scatter over the axes the batch is split on (``sum_axes``), the
  rank's own block along the others;
* ``tp_sum`` (all-reduce of row-parallel partials): identity;
* ``tp_copy`` (identity, where a 'model'-replicated activation enters a
  column-parallel product, Megatron's "f"): all-reduce over 'model';
* ``tp_gather`` and the batch gathers (``gather``): the own block;
* ``tp_block`` and ``batch_block`` (the own block of a replicated
  tensor, ``block``): all-gather;
* ``replica_share`` (identity where a computation is replicated over the
  DP axes, the MoE's whole-batch routing): the gradient over the number
  of those ranks, so that the sums above count it once.

A leaf that ``param_spec`` replicates over an axis the batch is split on
has a partial gradient on each rank; ``reduce_replicated`` sums it after
autograd (one all-reduce a set of axes).
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.launch.mesh import acc_dtype, axis_size


def sharded(mesh) -> bool:
    """Whether ``mesh`` spans several devices."""
    return mesh is not None and mesh.size > 1


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


# --------------------------------------------------------------------------- #
# Collectives with gradients
# --------------------------------------------------------------------------- #
class _Gather(torch.autograd.Function):
    """``mesh.all_gather(tensors, dims, axes)``; backward
    ``mesh.reduce_scatter`` summing over ``sum_axes`` (the own block along
    the other axes)."""

    @staticmethod
    def forward(ctx, mesh, dims, axes, sum_axes, *tensors):
        ctx.args = mesh, dims, axes, sum_axes
        return tuple(mesh.all_gather(tensors, dims, axes))

    @staticmethod
    def backward(ctx, *grads):
        mesh, dims, axes, sum_axes = ctx.args
        return (None,) * 4 + tuple(
            mesh.reduce_scatter(grads, dims, axes, sum_axes))


class _Sum(torch.autograd.Function):
    """The sum over ``axes`` (``tp_sum``, the MoE's statistics); backward
    the identity: the sum's consumers are replicated."""

    @staticmethod
    def forward(ctx, mesh, axes, x):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return None, None, g


class _Copy(torch.autograd.Function):
    """The identity; backward the sum of the gradient over ``axes`` in f32
    (f64 for f64), rounded once to its dtype."""

    @staticmethod
    def forward(ctx, mesh, axes, x):
        ctx.args = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return None, None, mesh.all_reduce(g.to(acc_dtype(g.dtype)),
                                           axes).to(g.dtype)


# Elements of ``w``'s upcast copy that ``_matmul_t`` makes at a time.
_F32_SLICE = 1 << 24


def _matmul_t(g: torch.Tensor, w: torch.Tensor, acc) -> torch.Tensor:
    """g @ w.T with both upcast to ``acc`` (exact products, sums in
    ``acc``), over slices of ``w``'s columns where it is large (its
    upcast copy one slice at a time)."""
    step = max(1, _F32_SLICE // max(1, w.shape[0]))
    out = None
    for i in range(0, w.shape[-1], step):
        part = torch.matmul(g[..., i:i + step].to(acc),
                            w[:, i:i + step].to(acc).T)
        out = part if out is None else out.add_(part)
    return out


class _Columns(torch.autograd.Function):
    """``[prod(x, w) for w in ws]``, each ``w`` column-parallel and ``x``
    replicated over 'model' (``tp_copy`` with the products inside):
    backward, each product's input gradient is computed in f32 (exact
    products, f32 sums), the partials summed over 'model' in one f32
    all-reduce and only then rounded to ``x``'s dtype and added in it,
    the last product's first, as autograd adds one device's whole
    products; the weights' gradients are autograd's."""

    @staticmethod
    def forward(ctx, mesh, prod, x, *ws):
        ctx.mesh = mesh
        ctx.save_for_backward(x, *ws)
        return tuple(prod(x, w) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        acc = acc_dtype(x.dtype)
        parts = torch.stack([_matmul_t(g, w, acc) for g, w in zip(gs, ws)])
        gx = None
        for p in reversed(ctx.mesh.all_reduce(parts, "model")):
            p = p.to(x.dtype)
            gx = p if gx is None else gx + p
        x2 = x.reshape(-1, x.shape[-1])
        dts = [torch.promote_types(x.dtype, w.dtype) for w in ws]
        gws = [x2.to(dt).T.matmul(g.reshape(-1, g.shape[-1]).to(dt))
               .to(w.dtype) for g, w, dt in zip(gs, ws, dts)]
        return (None, None, gx, *gws)


class _Block(torch.autograd.Function):
    """The rank's block of a replicated ``x`` under ``spec``; backward the
    blocks' gradients gathered whole (each rank's block is its own
    consumers' alone)."""

    @staticmethod
    def forward(ctx, mesh, spec, x):
        from repro_torch.distributed.sharding import block
        ctx.args = mesh, spec
        return block(x, spec, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import gather
        return None, None, gather(g, ctx.args[1], ctx.args[0])


class _Share(torch.autograd.Function):
    """The identity; backward the gradient over ``n``."""

    @staticmethod
    def forward(ctx, n, x):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, g / ctx.n


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def gather(tensors, dims, axes, mesh, sum_axes=()) -> list:
    """``mesh.all_gather`` with its adjoint (``_Gather``): summed over
    ``sum_axes``, the own block along the other axes."""
    tensors = list(tensors)
    if not any(_grad(t) for t in tensors):
        return mesh.all_gather(tensors, dims, axes)
    if not mesh._live_axes(axes):
        return tensors
    return list(_Gather.apply(mesh, tuple(dims), axes, tuple(sum_axes),
                              *tensors))


def all_sum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (``mesh.all_reduce``) for replicated
    consumers: the gradient passes unchanged."""
    if not _grad(x):
        return mesh.all_reduce(x, axes)
    return _Sum.apply(mesh, axes, x)


def tp_sum(x: torch.Tensor, mesh, dtype=None) -> torch.Tensor:
    """The sum over 'model' of every rank's partial ``x``, accumulated in
    f32 and rounded once to ``dtype`` (default ``x``'s)."""
    dtype = dtype or x.dtype
    if tp_size(mesh) == 1:
        return x.to(dtype)
    return all_sum(x.to(acc_dtype(x.dtype)), "model", mesh).to(dtype)


def tp_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, a tensor replicated over 'model', where it enters a
    computation that differs by 'model' rank (their columns, heads or
    experts): the gradient is summed over 'model'."""
    if tp_size(mesh) == 1 or not _grad(x):
        return x
    return _Copy.apply(mesh, "model", x)


def column_products(x: torch.Tensor, ws, mesh, prod) -> list:
    """``[prod(x, w) for w in ws]`` where each ``w``'s columns are the
    rank's (column-parallel) and ``x`` is replicated over 'model': as
    ``tp_copy`` then the products, with the input's gradient summed over
    'model' before it is rounded (``_Columns``)."""
    if tp_size(mesh) == 1 or not (_grad(x) or any(map(_grad, ws))):
        return [prod(x, w) for w in ws]
    return list(_Columns.apply(mesh, prod, x, *ws))


def tp_gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every 'model' rank's block of ``x`` along ``dim``, in order."""
    if tp_size(mesh) == 1:
        return x
    return gather([x], [dim % x.ndim], "model", mesh)[0]


def tp_block(x: torch.Tensor, dim: int, n_local: int, mesh) -> torch.Tensor:
    """This rank's block of ``n_local`` along ``dim`` of a whole ``x``
    (``x`` itself where it holds no more)."""
    if x.shape[dim] == n_local:
        return x
    if _grad(x):
        spec = tuple("model" if d == dim % x.ndim else None
                     for d in range(x.ndim))
        return _Block.apply(mesh, spec, x)
    i = tp_index(mesh) * n_local
    return x.narrow(dim, i, n_local)


def replica_share(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``x``, a parameter used by a computation that every rank of
    ``axes`` repeats alike: each gradient is the whole, and its share, the
    gradient over the number of those ranks, is what the sums over
    ``axes`` (the FSDP reduce-scatter, ``reduce_replicated``) add up."""
    n = axis_size(mesh, axes) if axes else 1
    if n == 1 or not _grad(x):
        return x
    return _Share.apply(n, x)


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
    spec = (axes,) + (None,) * (x.ndim - 1)
    if _grad(x):
        return _Block.apply(mesh, spec, x)
    from repro_torch.distributed.sharding import block
    return block(x, spec, mesh)


def gather_fsdp(tree: Dict, specs: Dict, mesh, sum_axes=()) -> Dict:
    """The tree with every leaf's dim over DP axes (its FSDP dim) gathered
    whole, leaving its 'model' blocks: one ``all_gather`` an axis carries
    every leaf split over the same axes.  The gradient of a whole leaf is
    summed over ``sum_axes`` (the axes the batch is split on: their ranks
    compute different rows) into the rank's block."""
    from repro_torch.distributed.sharding import gather_specs
    dp_only = _map_specs(lambda spec: tuple(
        None if e == "model" else e for e in spec), specs)
    return gather_specs(tree, dp_only, mesh, lambda ts, dims, axes: gather(
        ts, dims, axes, mesh, sum_axes))


def reduce_replicated(grads: Dict[str, torch.Tensor], specs: Dict,
                      sum_axes: Tuple[str, ...], mesh) -> Dict:
    """The flat gradient tree ``grads`` ({dotted path: the rank's block})
    with each leaf summed over the axes of ``sum_axes`` (the batch's) that
    its spec (``specs``, flat alike) does not split: those ranks hold the
    same block and computed it from different rows.  The sums run in f32,
    one all-reduce for each set of axes (the leaves packed), and each
    leaf is rounded once to its dtype."""
    from repro_torch.distributed.sharding import axes_of
    groups: Dict[Tuple[str, ...], list] = {}
    for path, spec in specs.items():
        own = {a for e in spec for a in axes_of(e)}
        axes = tuple(a for a in mesh._live_axes(sum_axes) if a not in own)
        if axes:
            groups.setdefault(axes, []).append(path)
    out = dict(grads)
    for axes, paths in groups.items():
        acc = functools.reduce(torch.promote_types,
                               [acc_dtype(grads[p].dtype) for p in paths])
        flat = torch.cat([grads[p].reshape(-1).to(acc) for p in paths])
        flat = mesh.all_reduce(flat, axes)
        for p, piece in zip(paths, flat.split([grads[p].numel()
                                               for p in paths])):
            out[p] = piece.reshape(grads[p].shape).to(grads[p].dtype)
    return out


def _map_specs(fn, specs: Dict) -> Dict:
    return {k: _map_specs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in specs.items()}
