"""AdamW with decoupled weight decay and global-norm clipping, as the
reference's ``train/optimizer.py`` computes it under ``jax.jit``.

The state (``step``, and ``m``, ``v`` in f32) is a tree congruent with the
parameters (nested dicts of tensors, leaves in sorted-key order, as
``jax.tree_util`` orders them).  ``update`` writes the parameters and the
moments in place with ``donate=True`` (the reference's train step donates
both), one slice of at most ``CHUNK`` elements along the first axis at a
time, so its f32 temporaries stay small beside a stacked (G, ...) leaf;
every op is elementwise, so slicing changes no bit.

Exactness against the reference as XLA compiles it on the CPU:

* the moments' and the step's multiply-adds are the fused ones LLVM
  contracts (``m = fma(b1, m, (1-b1)*g)``, ``v = fma(b2, v, ((1-b2)*g)*g)``,
  ``delta = fma(wd, p, q)``, ``p = fma(-lr, delta, p)``);
  ``torch.addcmul(c, a, b)`` is that fused operation where ``_fused``
  finds it so on the device, else ``f32order.fma_f32`` computes it;
* the schedule is evaluated on the host in f32: a division by a constant
  is a product with the constant's f32 reciprocal, ``cos`` and the bias
  corrections' powers are the C library's ``cosf`` and ``powf`` (XLA's
  CPU code calls them), the cosine's affine map is fused;
* the clipped gradient is rounded to its own dtype before the update.

Not exact: ``global_norm``.  XLA marks a reduction's adds ``reassoc`` and
LLVM vectorizes the last, small reduce of each leaf by its cost model,
in an order that depends on the leaf's shape and dtype.  The port sums
each leaf's squares in f64 (the square of an f32 is exact there) and
rounds the sum to f32, then adds the leaves in f32 in tree order, as the
reference's python ``sum`` does: within a few f32 units of the
reference's norm.  With clipping active, the clip scale can then differ
in its last bit; with it inactive (scale 1) every other output is equal
bit for bit.  Subnormal f32 values, which XLA's CPU code flushes to zero,
are kept.

On a mesh (ZeRO-3: ``shardings``, a tree of
``distributed.sharding.NamedSharding`` congruent with the parameters) the
parameters, gradients and moments are the rank's blocks and ``step`` is
replicated.  ``global_norm`` sums each leaf's f64 squares over the axes
its spec splits (one all-reduce for each set of axes; a replicated leaf
counted once) before the same f32 rounding and tree-order sum, and
``update`` runs the same elementwise arithmetic on the blocks: given the
one-device gradients' blocks, its blocks equal the one-device update's
bit for bit while the clip is inactive.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.f32order import fma_f32

F32 = torch.float32
CHUNK = 1 << 25          # elements of one slice of a leaf in ``update``


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    m: Any
    v: Any


# --------------------------------------------------------------------------- #
# Trees: nested dicts (leaves in sorted-key order) and tuples of tensors
# --------------------------------------------------------------------------- #
def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_state(params) -> AdamWState:
    """Zero moments in f32 beside each parameter, step 0 (on a mesh,
    beside each of the rank's blocks)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def abstract_state(params_abstract, mesh=None) -> AdamWState:
    """The state's tree on the meta device (no allocation); on a mesh of
    several devices, the rank's blocks' shapes (``param_spec``)."""
    meta = lambda p, shape: torch.empty(shape, dtype=p.dtype, device="meta")
    if mesh is not None and mesh.size > 1:
        from repro_torch.distributed.sharding import (local_shape,
                                                      param_shardings)
        return init_state(tree_map(
            lambda p, sh: meta(p, local_shape(tuple(p.shape), sh.spec, mesh)),
            params_abstract, param_shardings(params_abstract, mesh)))
    return init_state(tree_map(lambda p: meta(p, p.shape), params_abstract))


def tree_leaves_of(shardings) -> List:
    """The ``NamedSharding`` leaves of a tree of them, in tree order."""
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings)
                for x in tree_leaves_of(shardings[k])]
    return [shardings]


# --------------------------------------------------------------------------- #
# The schedule, on the host in f32
# --------------------------------------------------------------------------- #
_LIBM = None


def _libm():
    """The C library's ``cosf`` and ``powf``, which XLA's CPU code calls
    for f32 ``cos`` and ``pow``."""
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.cosf.restype = ctypes.c_float
        lib.cosf.argtypes = [ctypes.c_float]
        lib.powf.restype = ctypes.c_float
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        _LIBM = lib
    return _LIBM


def _fma_host(a, b, c) -> np.float32:
    """round_f32(a * b + c), one rounding."""
    t = lambda x: torch.tensor(np.float32(x))
    return np.float32(fma_f32(t(c), t(a), t(b)).item())


def _schedule_f32(cfg: AdamWConfig, step: int) -> np.float32:
    """The reference's ``_schedule`` as XLA compiles it: each division by
    a constant a product with its f32 reciprocal, ``cosf``, and the
    cosine's affine map one fused multiply-add (XLA folds it into
    ``fma(0.45, 1 + cos, 0.1)``, the same value: halving is exact)."""
    f = np.float32
    warm = min(f(step) * (f(1) / f(max(cfg.warmup_steps, 1))), f(1))
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = f(step - cfg.warmup_steps) * (f(1) / f(span))
    prog = min(max(prog, f(0)), f(1))
    cos = f(0.5) * (f(1) + f(_libm().cosf(f(f(math.pi) * prog))))
    inner = _fma_host(f(1 - cfg.min_lr_ratio), cos, f(cfg.min_lr_ratio))
    return f(f(cfg.lr) * warm) * inner


def _schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a 0-d f32
    tensor on the CPU: linear warmup, then a cosine decay to
    ``min_lr_ratio``."""
    return torch.tensor(_schedule_f32(cfg, int(step)))


def _bias_correction(b: float, step: int) -> np.float32:
    """1 - b**step in f32 (``powf``)."""
    return np.float32(1) - np.float32(_libm().powf(np.float32(b),
                                                   np.float32(step)))


# --------------------------------------------------------------------------- #
# Clipping
# --------------------------------------------------------------------------- #
def _chunks(t: torch.Tensor):
    """Slices of ``t`` along its first axis of at most ``CHUNK`` elements
    (the whole tensor if it has no axis)."""
    if t.ndim == 0 or t.numel() <= CHUNK:
        yield t
        return
    rows = max(1, CHUNK // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield t[i:i + rows]


def _sq_sums(leaves, shardings) -> List[torch.Tensor]:
    """Each leaf's sum of squares in f64; with ``shardings`` (the leaves
    the rank's blocks) summed over the axes each leaf's spec splits, one
    all-reduce for each set of axes."""
    sums = [torch.zeros((), dtype=torch.float64, device=leaf.device)
            for leaf in leaves]
    for s, leaf in zip(sums, leaves):
        for piece in _chunks(leaf):
            s += torch.sum(torch.square(piece.to(torch.float64)))
    if shardings is None:
        return sums
    from repro_torch.distributed.sharding import axes_of
    shards = tree_leaves_of(shardings)
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, sh in enumerate(shards):
        axes = tuple(a for a in sh.mesh.axis_names
                     if any(a in axes_of(e) for e in sh.spec))
        if sh.mesh._live_axes(axes):
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        mesh = shards[idx[0]].mesh
        total = mesh.all_reduce(torch.stack([sums[i] for i in idx]), axes)
        for i, t in zip(idx, total):
            sums[i] = t
    return sums


def global_norm(tree, shardings=None) -> torch.Tensor:
    """sqrt of the sum over the leaves (f32, in tree order) of each leaf's
    sum of squares (see the module's note on exactness); with
    ``shardings`` the leaves are the rank's blocks."""
    total = None
    for s in _sq_sums(tree_leaves(tree), shardings):
        s = s.to(F32)
        total = s if total is None else total + s
    return _sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) in f32 (a true division: a
    python number over a tensor would be a reciprocal and a product)."""
    num = torch.full_like(norm, float(np.float32(max_norm)))
    return torch.clamp(num / torch.clamp(norm, min=float(np.float32(1e-9))),
                       max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """The gradients scaled by min(1, max_norm / norm), each rounded back
    to its dtype, and the norm."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


# --------------------------------------------------------------------------- #
# Fused multiply-add
# --------------------------------------------------------------------------- #
_FUSED: Dict[torch.device, bool] = {}


def _fused(device: torch.device) -> bool:
    """Whether ``torch.addcmul`` computes one fused multiply-add on
    ``device``: on inputs whose unfused result is 0 (c = -round(a*b)) a
    fused one returns the product's rounding error.  Decided once per
    device; on the meta device (a counted step: ``analysis.count``) the
    fused route, without a probe."""
    if device.type == "meta":
        return True
    if device not in _FUSED:
        g = torch.Generator().manual_seed(0)
        a = torch.randn(4096, generator=g)
        b = torch.randn(4096, generator=g)
        c = -(a * b)
        want = fma_f32(c, a, b)
        got = torch.addcmul(c.to(device), a.to(device), b.to(device)).cpu()
        _FUSED[device] = bool(torch.equal(got, want)) and bool(
            (want != 0).any())
    return _FUSED[device]


def _fma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c), one rounding (f32 tensors)."""
    if _fused(c.device):
        return torch.addcmul(c, a, b)
    return fma_f32(c, a, b)


_SQRT: Dict[torch.device, bool] = {}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root.  ``torch.sqrt`` is not on
    every device (this host's CPU kernel is off by one unit in the last
    place on some inputs), so where a check of 65536 values against the
    f64 root finds it off, the root is taken in f64 and rounded (exact:
    f64 carries more than twice f32's bits).  Decided once per device;
    on the meta device ``torch.sqrt``, without a probe."""
    dev = x.device
    if dev.type == "meta":
        return torch.sqrt(x)
    if dev not in _SQRT:
        g = torch.Generator().manual_seed(0)
        t = torch.rand(65536, generator=g) * 2.0 ** torch.randint(
            -40, 40, (65536,), generator=g).float()
        want = torch.sqrt(t.double()).float()
        _SQRT[dev] = bool(torch.equal(torch.sqrt(t.to(dev)).cpu(), want))
    if _SQRT[dev]:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


# --------------------------------------------------------------------------- #
# The update
# --------------------------------------------------------------------------- #
def _update_slice(p, g, m, v, k: Dict[str, torch.Tensor], dst) -> None:
    """One slice of a leaf; ``dst`` = (p, m, v) destinations (the slices
    themselves when donating)."""
    g32 = (g.to(F32) * k["scale"]).to(g.dtype).to(F32)   # clip_by_global_norm
    m_new = _fma(k["c1"] * g32, m, k["b1"])
    v_new = _fma((k["c2"] * g32) * g32, v, k["b2"])
    # XLA folds (m / bc1) / (sqrt(v / bc2) + eps) into one division
    q = m_new / (k["bc1"] * (_sqrt(v_new / k["bc2"]) + k["eps"]))
    p32 = p.to(F32)
    delta = _fma(q, p32, k["wd"])
    p_new = _fma(p32, delta, k["neg_lr"])
    dst[0].copy_(p_new)
    dst[1].copy_(m_new)
    dst[2].copy_(v_new)


def update(cfg: AdamWConfig, params, grads, state: AdamWState,
           donate: bool = False, shardings=None
           ) -> Tuple[Any, AdamWState, Dict]:
    """One AdamW step.  Returns (params, state, {grad_norm, lr}); with
    ``donate`` the parameter and moment tensors (and the step) are updated
    in place and returned, else new tensors are.  ``grads`` may be bf16 or
    f32; each is clipped slice by slice, as ``clip_by_global_norm``
    clips it.  With ``shardings`` every tree holds the rank's blocks
    (ZeRO-3), and the gradient norm is the whole tree's."""
    gnorm = global_norm(grads, shardings)
    # a meta step (a counted one) has no value: the schedule's first
    step = (0 if state.step.is_meta else int(state.step)) + 1
    lr = _schedule_f32(cfg, step)
    dev = state.step.device
    f = lambda x: torch.tensor(np.float32(x), device=dev)
    k = dict(scale=_clip_scale(gnorm, cfg.grad_clip),
             b1=f(cfg.b1), c1=f(1 - cfg.b1), b2=f(cfg.b2), c2=f(1 - cfg.b2),
             bc1=f(_bias_correction(cfg.b1, step)),
             bc2=f(_bias_correction(cfg.b2, step)),
             eps=f(cfg.eps), wd=f(cfg.weight_decay), neg_lr=f(-lr))

    def leaf(p, g, m, v):
        dst = ((p, m, v) if donate else
               (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)))
        for sl in zip(*(_chunks(t) for t in (p, g, m, v, *dst))):
            _update_slice(*sl[:4], k, sl[4:])
        return dst

    out = tree_map(leaf, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda t: t[i], out)
    new_step = state.step.add_(1) if donate else state.step + 1
    metrics = dict(grad_norm=gnorm, lr=torch.tensor(lr))
    return pick(0), AdamWState(step=new_step, m=pick(1), v=pick(2)), metrics
