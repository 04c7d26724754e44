"""Device meshes over ``torch.distributed``: the sharded mapper's and the
LM's.

The reference package drives every device of its mesh from one process
(``jax.make_mesh``).  The port runs one process per rank (SPMD): every rank
calls ``make_mesh`` with the same shape and axis names and gets a ``Mesh``
holding its own coordinates, its device, one process group per axis, and
the collectives its programs issue: ``all_gather_rows`` and
``all_reduce_sum`` over the whole mesh and ``ring_shift`` and
``all_to_all`` along one axis (the sharded chunk program), ``all_gather``
along a dim, its adjoint ``reduce_scatter`` and ``all_reduce`` (sum or
max) over one axis or a tuple of axes (the LM's FSDP, TP and EP layers and
their gradients).  Ranks are laid out row-major over
the axes, so a rank's global number is its shard id
(``pipeline.sharded_chunk_fn``).  ``AbstractMesh`` is a mesh's shape and
axis names without ranks (``make_production_mesh``; the sharding rules
take either).

Backends: ``nccl`` when each rank owns a card, ``gloo`` when ranks share one
card or run on the CPU.  gloo takes no CUDA tensors for point-to-point or
all-to-all, so under gloo every collective copies a CUDA payload to pinned
host memory and back, explicitly, and counts the bytes and the seconds
(``Mesh.stats``).  Asking for ``nccl`` where ranks share a card raises:
nothing switches backend silently.

``run_ranks`` spawns the ranks of one process group on this host (the
``spawn`` start method, a ``file://`` store in a fresh temporary
directory, a timeout on every group, each rank's intra-op threads cut to
its share of the host's), returns each rank's result, and raises, after
killing every rank, when one fails or the run overruns.  A rank whose
parent dies (a launcher killed mid-run) exits at once.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import math
import multiprocessing
import multiprocessing.connection
import os
import pathlib
import pickle
import tempfile
import threading
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pipeline import check_device

F32 = torch.float32
# How long a collective may wait for its peers before the group fails.
GROUP_TIMEOUT_S = 120.0
# Each rank's tensors are packed into one buffer; segments start 8-byte
# aligned so every dtype views back in place.
_ALIGN = 8
# The largest message ``reduce_scatter`` packs (a larger tensor goes
# alone): its device copies of a message are a few times its size.
MESSAGE_BYTES = 1 << 28


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum of ``dtype`` values accumulates in: f32, or f64
    for f64."""
    return torch.promote_types(dtype, F32)


def _check_backend(device: torch.device, backend: Optional[str],
                   world_size: int) -> str:
    """The backend for ``world_size`` ranks computing on ``device``: nccl
    when every rank owns a card, else gloo; an explicit nccl on the CPU or
    on a shared card raises."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}; use 'gloo' or "
                         "'nccl'")
    if device.type != "cuda":
        if backend == "nccl":
            raise ValueError("backend 'nccl' needs a card per rank; the "
                             "mesh computes on the CPU (use 'gloo')")
        return "gloo"
    cards = torch.cuda.device_count()
    shared = cards < world_size
    if backend == "nccl" and shared:
        raise ValueError(f"backend 'nccl' needs one card per rank: "
                         f"{world_size} ranks share {cards} card(s) (NCCL "
                         "refuses two ranks on one device); ask for "
                         "backend='gloo'")
    return backend or ("gloo" if shared else "nccl")


class AbstractMesh:
    """A mesh's axis names and extents, without processes
    (``jax.sharding.AbstractMesh``): ``axis_names``, ``shape[axis]`` and
    ``size``, all the sharding rules read.  Given a ``rank`` it also holds
    that rank's ``coords`` (row-major over the axes), enough to cut the
    rank's block of an array (``distributed.sharding.block``) with no
    collective: what a rank of that mesh would hold."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: Optional[int] = None):
        shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axes)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             "in length")
        self.shape = collections.OrderedDict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        if rank is not None:
            self.rank = int(rank)
            coords = np.unravel_index(self.rank, shape)
            self.coords = {a: int(c) for a, c in zip(self.axis_names,
                                                     coords)}


def make_production_mesh(*, multi_pod: bool = False,
                         layout: str = "2d") -> AbstractMesh:
    """The reference's production meshes, abstract (no ranks): 16 x 16 =
    256 devices ('data', 'model'), or with ``multi_pod`` 2 x 16 x 16 = 512
    ('pod', 'data', 'model'); ``pod`` x ``data`` form the DP/FSDP domain,
    ``model`` carries TP and EP.  ``layout='fsdp'`` renames 'model' to
    'data2', so the sharding rules treat every axis as a DP/FSDP axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if layout == "fsdp":
        axes = axes[:-1] + ("data2",)
    elif layout != "2d":
        raise ValueError(f"unknown layout {layout!r}; use '2d' or 'fsdp'")
    return AbstractMesh(shape, axes)


class Mesh(AbstractMesh):
    """One rank's view of a device mesh (build it with ``make_mesh``).

    ``axis_names`` and ``shape[axis]`` as a JAX mesh has them; ``rank`` (the
    global rank, row-major over the axes), ``coords[axis]``,
    ``groups[axis]`` (the process group of the ranks that differ from this
    one only along ``axis``) and ``group_ranks[axis]`` (their global ranks,
    by coordinate); ``device``, where this rank computes; ``backend``.
    ``stats`` counts, per collective kind, the calls, the payload bytes
    this rank sent and the host seconds inside the collective call (under
    gloo the whole exchange, waits on peers included; under NCCL the
    enqueue), and under gloo the bytes staged through host memory and the
    seconds the staging copies took.  Four ``_send_*`` methods move the
    bytes; the rest (packing, the message caps, the per-axis loop, the
    counts) is shared with the dry run's counting mesh
    (``analysis.count.CountingMesh``), whose transport moves nothing.
    """

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 device: torch.device, backend: str, rank: int):
        super().__init__(shape, axes, rank)
        self.device = device
        self.backend = backend
        self._stage = backend == "gloo" and device.type == "cuda"
        self.stats: collections.Counter = collections.Counter()
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        self.groups: Dict[str, dist.ProcessGroup] = {}
        self.group_ranks: Dict[str, Tuple[int, ...]] = {}
        grid = np.arange(self.size).reshape(shape)
        # every rank creates every group, in the same order
        for i, a in enumerate(self.axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            for line in lines:
                ranks = tuple(int(r) for r in line)
                group = dist.new_group(list(ranks), timeout=timeout)
                if self.rank in ranks:
                    self.groups[a] = group
                    self.group_ranks[a] = ranks

    # ------------------------------------------------------------ staging
    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor a collective sends: under gloo a CUDA payload is
        copied to pinned host memory first."""
        x = x.contiguous()
        if not self._stage:
            return x
        # wait for the payload's producers first: the staging time is the
        # copies alone, not the chunk's queued kernels
        torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        self.stats["staging_s"] += time.perf_counter() - t0
        self.stats["staged_bytes"] += x.nbytes
        return host

    def _from_wire(self, x: torch.Tensor) -> torch.Tensor:
        if not self._stage:
            return x
        t0 = time.perf_counter()
        out = x.to(self.device)
        self.stats["staging_s"] += time.perf_counter() - t0
        self.stats["staged_bytes"] += x.nbytes
        return out

    @contextlib.contextmanager
    def _collective(self, kind: str, nbytes: int, result_bytes: int):
        """Count one call of ``kind`` sending ``nbytes`` and timing its
        body; ``result_bytes``, what the call leaves on this rank, is the
        counting mesh's (``analysis.count.CountingMesh``)."""
        self.stats[f"{kind}_calls"] += 1
        self.stats[f"{kind}_bytes"] += nbytes
        t0 = time.perf_counter()
        yield
        self.stats[f"{kind}_s"] += time.perf_counter() - t0

    # ---------------------------------------------------------- transport
    # The only code that moves bytes between ranks; the counting mesh
    # replaces these four and runs everything else as it is.
    def _send_all_gather(self, parts, wire, axis=None) -> None:
        dist.all_gather(parts, wire,
                        group=None if axis is None else self.groups[axis])

    def _send_all_to_all(self, recv, wire, axis: str) -> None:
        dist.all_to_all_single(recv, wire, group=self.groups[axis])

    def _send_all_reduce(self, wire, op: str, axis=None) -> None:
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(wire, op=red,
                        group=None if axis is None else self.groups[axis])

    def _send_ring(self, send, recv, axis: str) -> None:
        n = self.shape[axis]
        ranks, c = self.group_ranks[axis], self.coords[axis]
        group = self.groups[axis]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, ranks[(c + 1) % n], group=group),
            dist.P2POp(dist.irecv, recv, ranks[(c - 1) % n], group=group)])
        for r in reqs:
            r.wait()

    # -------------------------------------------------------- collectives
    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0, in rank (shard)
        order, on every rank."""
        wire = self._to_wire(x)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        with self._collective("all_gather", x.nbytes,
                              self.size * x.nbytes):
            self._send_all_gather(parts, wire)
        return self._from_wire(torch.cat(parts))

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``x``, in ``x``'s dtype."""
        wire = self._to_wire(x)
        if wire is x:
            wire = x.clone()
        with self._collective("all_reduce", x.nbytes, x.nbytes):
            self._send_all_reduce(wire, "sum")
        return self._from_wire(wire)

    def ring_shift(self, tensors: Sequence[torch.Tensor],
                   axis: str) -> list:
        """Send ``tensors`` to the next rank along ``axis`` (coordinate
        c -> (c + 1) mod n) and return the previous rank's: one message
        each way, all tensors packed into it."""
        n = self.shape[axis]
        if n == 1:
            return list(tensors)
        buf, metas = _pack(tensors)
        send = self._to_wire(buf)
        recv = torch.empty_like(send)
        with self._collective("ring", buf.nbytes, buf.nbytes):
            self._send_ring(send, recv, axis)
        return _unpack(self._from_wire(recv), metas)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` of leading extent n = shape[axis]: block j goes to the
        rank of coordinate j along ``axis``, and block i of the result
        came from the rank of coordinate i."""
        if x.shape[0] != self.shape[axis]:
            raise ValueError(f"all_to_all over {axis!r} needs a leading "
                             f"extent of {self.shape[axis]}; got "
                             f"{tuple(x.shape)}")
        if self.shape[axis] == 1:
            return x
        wire = self._to_wire(x)
        out = torch.empty_like(wire)
        with self._collective("all_to_all", x.nbytes, x.nbytes):
            self._send_all_to_all(out, wire, axis)
        return self._from_wire(out)


    # ------------------------------------------- collectives over axes
    def _live_axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names, or None) as the tuple of
        those of more than one rank."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in axes if self.shape[a] > 1)

    def all_gather(self, tensors: Sequence[torch.Tensor],
                   dims: Sequence[int], axes) -> list:
        """Each tensor of ``tensors`` concatenated along its dim of
        ``dims`` over the ranks of ``axes`` (a name or a tuple, the first
        the slowest: blocks in the order of their row-major coordinate), on
        every one of those ranks.  One message an axis carries all the
        tensors, packed."""
        tensors = list(tensors)
        for a in reversed(self._live_axes(axes)):
            n = self.shape[a]
            buf, metas = _pack(tensors)
            wire = self._to_wire(buf)
            # staged parts land in pinned memory and go to the card one by
            # one: no host-side concatenation of the whole
            parts = [torch.empty(wire.shape, dtype=wire.dtype,
                                 device=wire.device, pin_memory=self._stage)
                     for _ in range(n)]
            with self._collective("all_gather", buf.nbytes,
                                  n * buf.nbytes):
                self._send_all_gather(parts, wire, a)
            per_rank = [_unpack(self._from_wire(p), metas) for p in parts]
            tensors = [torch.cat([r[i] for r in per_rank], dim=d)
                       for i, d in enumerate(dims)]
        return tensors

    def reduce_scatter(self, tensors: Sequence[torch.Tensor],
                       dims: Sequence[int], axes, sum_axes=None) -> list:
        """The adjoint of ``all_gather(tensors, dims, axes)``: each tensor
        (whole along its dim of ``dims`` over ``axes``) cut to the rank's
        block, summed over the ranks of each axis of ``sum_axes`` (default
        all of ``axes``); along an axis not in ``sum_axes`` the rank keeps
        its own block.  The sums run in f32, axis by axis (the first the
        slowest) and, within an axis, in coordinate order, the same on
        every rank (in f64 for f64 tensors); each result is rounded once
        to its tensor's dtype.
        One ``all_to_all`` an axis carries the tensors, packed, up to
        ``MESSAGE_BYTES`` a message (a tensor past it goes alone): block j
        of each goes to the rank of coordinate j."""
        out, batch, size = [None] * len(tensors), [], 0
        for i, t in enumerate(tensors):
            if batch and size + t.nbytes > MESSAGE_BYTES:
                self._reduce_scatter(tensors, dims, axes, sum_axes, batch,
                                     out)
                batch, size = [], 0
            batch.append(i)
            size += t.nbytes
        if batch:
            self._reduce_scatter(tensors, dims, axes, sum_axes, batch, out)
        return out

    def _reduce_scatter(self, tensors, dims, axes, sum_axes, batch,
                        out) -> None:
        """``reduce_scatter`` of the tensors numbered ``batch``, into
        ``out``: one message an axis, the device's copy of it freed once
        staged, each sum accumulated in place."""
        dtypes = [tensors[i].dtype for i in batch]
        dims = [dims[i] for i in batch]
        cur = [tensors[i] for i in batch]
        live = self._live_axes(axes)
        summed = live if sum_axes is None else self._live_axes(sum_axes)
        for a in live:
            n, c = self.shape[a], self.coords[a]
            if a not in summed:
                cur = [t.narrow(d, c * (t.shape[d] // n), t.shape[d] // n)
                       for t, d in zip(cur, dims)]
                continue
            chunks = [t.chunk(n, dim=d) for t, d in zip(cur, dims)]
            metas, seg = _layout([ch[0] for ch in chunks])
            buf = torch.empty(n * seg, dtype=torch.uint8,
                              device=cur[0].device)
            for j in range(n):
                for ch, (off, _, _, nb) in zip(chunks, metas):
                    buf[j * seg + off:j * seg + off + nb].copy_(
                        ch[j].contiguous().reshape(-1).view(torch.uint8))
            del chunks
            nbytes = buf.nbytes
            wire = self._to_wire(buf)
            del buf
            recv = torch.empty_like(wire)
            with self._collective("reduce_scatter", nbytes, nbytes // n):
                self._send_all_to_all(recv, wire, a)
            del wire
            parts = [_unpack(p, metas)
                     for p in self._from_wire(recv).chunk(n)]
            del recv
            cur = []
            for i, dt in enumerate(dtypes):
                acc = parts[0][i].to(acc_dtype(dt), copy=True)
                for p in parts[1:]:
                    acc.add_(p[i])
                cur.append(acc)
            del parts
        for i, t, dt in zip(batch, cur, dtypes):
            out[i] = t.to(dt)

    def all_reduce(self, x: torch.Tensor, axes,
                   op: str = "sum") -> torch.Tensor:
        """The elementwise sum (or, ``op='max'``, maximum) of ``x`` over
        the ranks of ``axes`` (a name or a tuple: one call an axis), in
        ``x``'s dtype."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce: op {op!r}; use 'sum' or 'max'")
        for a in self._live_axes(axes):
            wire = self._to_wire(x)
            if wire is x:
                wire = x.clone()
            with self._collective("all_reduce", x.nbytes, x.nbytes):
                self._send_all_reduce(wire, op, a)
            x = self._from_wire(wire)
        return x

    def barrier(self) -> None:
        """Wait until every rank of the mesh gets here."""
        self.all_reduce_sum(torch.zeros(1, device=self.device))


def _layout(tensors: Sequence[torch.Tensor]):
    """``_pack``'s (offset, dtype, shape, bytes) of each tensor, and the
    packed size (``reduce_scatter`` writes its segments in place)."""
    metas, off = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        metas.append((off, t.dtype, t.shape, nb))
        off += nb + (-nb % _ALIGN)
    return metas, off


def _pack(tensors: Sequence[torch.Tensor]):
    """The tensors' bytes in one uint8 buffer, each segment 8-byte aligned,
    and (offset, dtype, shape, bytes) of each."""
    segs, metas, off = [], [], 0
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % _ALIGN
        segs.append(b)
        if pad:
            segs.append(b.new_zeros(pad))
        metas.append((off, t.dtype, t.shape, b.numel()))
        off += b.numel() + pad
    return torch.cat(segs), metas


def _unpack(buf: torch.Tensor, metas) -> list:
    return [buf[o:o + nb].view(dtype).reshape(shape)
            for o, dtype, shape, nb in metas]


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """This rank's ``Mesh`` of ``shape`` over ``axes`` (every rank calls it
    alike).  ``device``: where the rank computes, CUDA unless the caller
    asks for the CPU; a bare "cuda" means card ``rank % device_count``.

    The default process group must span exactly the mesh.  When it is not
    initialised yet it is, from the environment (``torchrun``: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), with ``backend`` (default: nccl
    when each rank owns a card, else gloo); an initialised group must run
    the backend asked for (or any, with ``backend=None``), and nccl on a
    shared card or the CPU raises.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair "
                         "one distinct name with each extent")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    else:
        raise RuntimeError("make_mesh needs a process group: initialise "
                           "torch.distributed, run under torchrun, or "
                           "spawn the ranks with run_ranks")
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} has {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    device = check_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if dist.is_initialized():
        running = dist.get_backend()
        want = _check_backend(device, backend or running, world)
        if want != running:
            raise ValueError(f"the process group runs {running!r}; the "
                             f"mesh asks for {want!r}")
    else:
        want = _check_backend(device, backend, world)
        dist.init_process_group(
            want, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(shape, axes, device, want, rank)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Data-parallel axes of a mesh: everything except 'model'."""
    return tuple(a for a in mesh.axis_names if a != "model")


def tp_axis(mesh: Mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def parse_mesh(spec: str, n_devices: int):
    """The LM launchers' ``--mesh`` (the reference's ``launch/train.py``
    parse_mesh): ``auto`` is (n/2, 2) over n devices, ('data', 'model');
    explicit dims ``AxB[xC]`` are named ``("pod", "data", "model")[-len:]``.
    A mesh of one device is ``None`` (the LM runs unsharded); any other is
    ``(shape, axis names)``, the mesh of ranks to spawn (``run_ranks``),
    each of which builds it with ``make_mesh``."""
    if spec == "auto":
        dims = (1, 1) if n_devices == 1 else (n_devices // 2, 2)
        names = ("data", "model")
    else:
        try:
            dims = tuple(int(x) for x in spec.split("x"))
        except ValueError:
            dims = ()
        names = ("pod", "data", "model")[-len(dims):] if dims else ()
    if not dims or len(dims) != len(names) or min(dims) < 1:
        raise ValueError(f"--mesh {spec}: give 'auto' or 2 or 3 dims "
                         "like 2x2")
    if math.prod(dims) == 1:
        return None
    return dims, names


# --------------------------------------------------------------------------- #
# Spawning the ranks of one process group on this host
# --------------------------------------------------------------------------- #
def _exit_with(sentinel) -> None:
    """Wait for the parent's sentinel, then end this rank at once."""
    multiprocessing.connection.wait([sentinel])
    os._exit(1)


def _rank_main(rank: int, world_size: int, backend: str,
               workdir: str) -> None:
    out = pathlib.Path(workdir)
    parent = multiprocessing.parent_process()
    if parent is not None:
        threading.Thread(target=_exit_with, args=(parent.sentinel,),
                         daemon=True).start()
    try:
        fn, args = pickle.loads((out / "task.pkl").read_bytes())
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                          LOCAL_RANK=str(rank))
        # the ranks share this host's cores: torch's default of a thread
        # a core in every rank would oversubscribe them
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
        dist.init_process_group(
            backend, init_method=(out / "store").as_uri(), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        result = fn(*args)
        (out / f"result_{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)        # no teardown: the peers are killed by the parent
    dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, backend: str = "gloo",
              timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` in ``world_size`` spawned processes joined in one
    process group (``backend``; ranks 0..world_size-1) and return the list
    of their results, by rank.  ``fn`` must be importable by name and its
    result picklable.  A rank that raises or exits non-zero, or a run past
    ``timeout`` seconds, kills every rank and raises with the failing
    ranks' tracebacks."""
    if backend == "nccl":
        _check_backend(torch.device("cuda"), backend, world_size)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        # the task goes through a file: a child that dies before reading
        # its start-up pipe would block a parent writing a large payload
        # into it
        (pathlib.Path(tmp) / "task.pkl").write_bytes(pickle.dumps((fn, args)))
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, tmp))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    failed = "a rank failed"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = f"the ranks did not finish within {timeout} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        work = pathlib.Path(tmp)
        if failed is not None:
            errs = "\n".join(
                f"--- rank {r}\n{(work / f'error_{r}.txt').read_text()}"
                for r in range(world_size)
                if (work / f"error_{r}.txt").exists())
            raise RuntimeError(f"run_ranks: {failed} (exit codes "
                               f"{[p.exitcode for p in procs]})\n{errs}")
        return [pickle.loads((work / f"result_{r}.pkl").read_bytes())
                for r in range(world_size)]
