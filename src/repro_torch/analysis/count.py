"""What one rank's step costs, counted on the meta device.

The reference's dry run compiles each step for 512 placeholder devices and
reads flops, bytes and collective bytes out of XLA's HLO text
(``analysis/hlo.py`` there).  Torch has no HLO; the port runs the rank's
step itself, on meta tensors (shapes and dtypes, nothing allocated, no
card), and counts what it does:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``, 2·M·N·K a
  product, forward and backward; the forward that remat recomputes in the
  backward is counted again, as XLA counts it;
* **bytes**: ``ByteCounter``, every op's input and output bytes; a view
  (``view``, a ``reshape`` that copies nothing, ``transpose``, ``expand``,
  ``slice``, ``as_strided``, ...) and a bare allocation add none, as the
  reference's ``_NO_DATA`` ops add none.  Nothing is fused, so this is
  the unfused step's traffic, reported beside the reference's, never held
  to it;
* **collectives**: ``CountingMesh``, a ``launch.mesh.Mesh`` over an
  abstract mesh with a rank whose transport moves nothing.  Every other
  line of the real mesh's collectives runs (packing, the message caps, the
  per-axis loop), so its ``stats`` (calls and bytes sent, by kind) are the
  real mesh's by construction; ``detail`` adds each call in the reference's
  convention: the result's bytes on the rank, an all-reduce weighted 2x,
  the others 1x (``bytes_<kind>``, ``count_<kind>``, HLO's kind names).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import AbstractMesh, Mesh

META = torch.device("meta")

# the port's collective kinds as the reference's HLO names them, and the
# ring-algorithm weight hlo.py gives each
HLO_KIND = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_reduce": "all-reduce", "all_to_all": "all-to-all",
            "ring": "collective-permute"}
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


class CountingMesh(Mesh):
    """Rank ``rank``'s ``Mesh`` of ``shape`` over ``axes`` with no process
    group: tensors are meta, the transport leaves each received buffer as
    allocated (meta: shape and dtype only), and ``stats`` and ``detail``
    count what the real mesh would send and hold."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0):
        AbstractMesh.__init__(self, shape, axes, rank)
        self.device = META
        self.backend = "count"
        self._stage = False
        self.stats: collections.Counter = collections.Counter()
        self.detail: Dict[str, float] = {}
        for k in WIRE_FACTOR:
            self.detail[f"bytes_{k}"] = 0.0
            self.detail[f"count_{k}"] = 0.0

    @classmethod
    def of(cls, mesh: AbstractMesh, rank: int = 0) -> "CountingMesh":
        return cls(tuple(mesh.shape.values()), mesh.axis_names, rank)

    @contextlib.contextmanager
    def _collective(self, kind: str, nbytes: int, result_bytes: int):
        k = HLO_KIND[kind]
        self.detail[f"bytes_{k}"] += WIRE_FACTOR[k] * result_bytes
        self.detail[f"count_{k}"] += 1
        with super()._collective(kind, nbytes, result_bytes):
            yield

    def _send_all_gather(self, parts, wire, axis=None) -> None:
        pass

    def _send_all_to_all(self, recv, wire, axis: str) -> None:
        pass

    def _send_all_reduce(self, wire, op: str, axis=None) -> None:
        pass

    def _send_ring(self, send, recv, axis: str) -> None:
        pass

    @property
    def wire_bytes(self) -> float:
        """The sum of ``detail``'s bytes: the reference's
        ``wire_bytes_per_device``."""
        return sum(v for k, v in self.detail.items()
                   if k.startswith("bytes_"))


def calls_and_bytes(stats) -> Dict[str, int]:
    """A mesh's ``stats`` cut to the calls and bytes sent by kind (no
    seconds, no staging): what a counting mesh and a real one share."""
    return {k: int(v) for k, v in sorted(stats.items())
            if k.endswith(("_calls", "_bytes")) and k != "staged_bytes"}


# --------------------------------------------------------------------------- #
# Bytes
# --------------------------------------------------------------------------- #
_aten = torch.ops.aten
# ops that touch no data: allocations without a fill, and the views a
# reshape decomposes into that are not marked as views in their schema
_NO_DATA = {_aten.empty, _aten.empty_strided, _aten.empty_like,
            _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
            _aten.lift_fresh, _aten.detach, _aten.alias}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.nbytes for t in leaves if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Adds every op's input and output bytes to ``bytes``; views and
    bare allocations add none."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket not in _NO_DATA:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


# --------------------------------------------------------------------------- #
# A rank's step on the meta device
# --------------------------------------------------------------------------- #
def _meta_blocks(tree, shardings, mesh):
    """The rank's blocks of an abstract tree, on the meta device."""
    from repro_torch.distributed.sharding import local_shape
    if isinstance(tree, dict):
        return {k: _meta_blocks(v, shardings[k], mesh)
                for k, v in tree.items()}
    shape = (local_shape(tuple(tree.shape), shardings.spec, mesh)
             if mesh.size > 1 else tuple(tree.shape))
    return torch.empty(shape, dtype=tree.dtype, device=META)


def count_step(cfg, shape, mesh: Optional[CountingMesh], *,
               microbatches: int = 1, kv_dtype=torch.bfloat16,
               with_bytes: bool = True, max_len: Optional[int] = None,
               cache_index: Optional[int] = None) -> Dict:
    """Run one step of ``shape``'s kind (``train.steps``' factories) for
    ``cfg`` on the meta device: on ``mesh`` (a ``CountingMesh``; None: one
    device) the rank's parameter, optimizer and cache blocks and the whole
    batch, as a rank of that mesh runs it.  A serving step's cache holds
    ``max_len`` positions (default the shape's ``seq_len``, the prompt)
    and a decode step writes position ``cache_index`` (default the
    cache's last).  Returns {flops, bytes, arg_bytes, out_bytes}: the
    counted flops and op bytes, and the bytes of the step's arguments and
    outputs on the rank (its blocks; the batch whole)."""
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_lib

    B, S = shape.global_batch, shape.seq_len
    batch_abs = steps_lib.make_batch_abstract(cfg, shape)
    ctx = batch_abs.get("ctx")
    blocks_mesh = steps_lib._mesh_or_one(mesh)
    if shape.kind == "train":
        _, jit_for, sh = steps_lib.make_train_step(
            cfg, mesh, opt.AdamWConfig(), microbatches=microbatches)
        params = _meta_blocks(M.abstract_params(cfg), sh["params"],
                              blocks_mesh)
        args = (params, opt.abstract_state(M.abstract_params(cfg), mesh),
                batch_abs)
        kw = {}
    else:
        make = (steps_lib.make_prefill_step if shape.kind == "prefill"
                else steps_lib.make_decode_step)
        T = max_len or S
        _, jit_for, sh = make(cfg, mesh, T, B, kv_dtype)
        params = _meta_blocks(M.abstract_params(cfg), sh["params"],
                              blocks_mesh)
        cache = M.init_cache(cfg, B, T, kv_dtype, META,
                             mesh if blocks_mesh.size > 1 else None)
        args = (params, batch_abs["tokens"], cache)
        if shape.kind == "decode":
            args += (T - 1 if cache_index is None else cache_index,)
        kw = {} if ctx is None else dict(ctx=ctx)
    step = jit_for(batch_abs)
    fc = FlopCounterMode(display=False)
    bc = ByteCounter() if with_bytes else contextlib.nullcontext()
    with fc, bc:
        out = step(*args, **kw)
    return dict(flops=float(fc.get_total_flops()),
                bytes=float(bc.bytes) if with_bytes else 0.0,
                arg_bytes=_nbytes((args, kw)), out_bytes=_nbytes(out))
