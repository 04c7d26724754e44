"""Step factories of the LM: the train step, and the prefill and decode
steps of serving.

The reference's factories return ``(step, jit_for, shardings)``, where
``jit_for(batch_abstract)`` jits the step with sharded in/out specs and
donates the cache (and, training, the parameters and optimizer state).
Here ``jit_for`` checks the batch stand-ins against the factory's batch
and returns the step, and a donated tree is updated in place.  Every
factory takes a mesh (``launch.mesh.Mesh``: the step runs on this rank's
blocks, ``models.part``) and its third item is the reference's: the
``params`` and ``cache`` shardings (``distributed.sharding``), or for the
train step the ``params`` and ``opt`` shardings (the moments' are the
parameters', ZeRO-3; the step replicated); replicated specs without a
mesh.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as shlib
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import model as M
from repro_torch.models import part
from repro_torch.train import optimizer as opt


def make_batch_abstract(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    """Stand-ins on the meta device for every model input (no
    allocation)."""
    B, S = shape.global_batch, shape.seq_len
    sds = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind == "train":
        batch = dict(tokens=sds((B, S), torch.int32),
                     labels=sds((B, S), torch.int32))
    elif shape.kind == "prefill":
        batch = dict(tokens=sds((B, S), torch.int32))
    else:  # decode: one new token against a seq_len cache
        batch = dict(tokens=sds((B, 1), torch.int32))
    if cfg.n_ctx_tokens:
        batch["ctx"] = sds((B, cfg.n_ctx_tokens, cfg.d_model),
                           torch.bfloat16)
    return batch


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A token-stream batch (numpy) as the train step takes it: tokens and
    labels int32, the context stub in bf16, as the launchers pass it."""
    return {k: torch.as_tensor(v, device=device).to(
        torch.bfloat16 if k == "ctx" else torch.int32)
        for k, v in batch.items()}


def _check_batch(cfg: ArchConfig, batch_abstract: Dict, batch: int,
                 max_len: int, kind: str) -> None:
    tok = batch_abstract["tokens"]
    ok = (tok.dtype == torch.int32 and tok.ndim == 2
          and tok.shape[0] == batch
          and (tok.shape[1] == 1 if kind == "decode"
               else tok.shape[1] <= max_len))
    want_ctx = ((batch, cfg.n_ctx_tokens, cfg.d_model)
                if cfg.n_ctx_tokens else None)
    ctx = batch_abstract.get("ctx")
    got_ctx = None if ctx is None else tuple(ctx.shape)
    if not ok or got_ctx != want_ctx:
        raise ValueError(
            f"{kind} step for batch {batch}, max_len {max_len}: stand-ins "
            f"tokens {tok.dtype}{tuple(tok.shape)}, ctx {got_ctx} "
            f"(ctx expected {want_ctx})")


def _mesh_or_one(mesh):
    """``mesh``, or without one an abstract (1, 1) mesh (every spec
    replicated)."""
    return mesh if mesh is not None else AbstractMesh((1, 1),
                                                      ("data", "model"))


def make_train_step(cfg: ArchConfig, mesh, adamw: opt.AdamWConfig,
                    donate: bool = True, microbatches: int = 1):
    """Returns (step, jit_for, {params, opt} shardings).
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``,
    metrics {loss, nll, aux, grad_norm, lr}: the gradient of
    ``model.loss_fn`` by autograd (the layer groups rematerialised), then
    ``optimizer.update``, in place when ``donate``.  On a mesh of several
    devices ``params`` and ``opt_state`` are the rank's blocks (the
    shardings say which) and ``batch`` is the whole batch, of which the
    rank computes its rows; every rank returns the same metrics.

    ``microbatches`` > 1 accumulates the gradient of M sequential slices
    of the batch in f32 (the reference's scan): each slice's gradient is
    added as ``acc + g.to(f32)``, the sum divided by M, the loss averaged,
    and the parts are {nll: loss, aux: 0}.  On a mesh each slice is split
    over the DP axes as a whole batch is."""
    p_sh = shlib.param_shardings(M.abstract_params(cfg), _mesh_or_one(mesh))
    o_sh = opt.AdamWState(step=shlib.NamedSharding(p_sh["embed"].mesh, ()),
                          m=p_sh, v=p_sh)
    shardings = p_sh if part.sharded(mesh) else None

    def step(params, opt_state, batch):
        if microbatches == 1:
            (loss, parts), grads = M.value_and_grad(params, batch, cfg,
                                                    mesh=mesh)
        else:
            micro = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = M.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(microbatches):
                (l, _), g = M.value_and_grad(
                    params, {k: v[i] for k, v in micro.items()}, cfg,
                    mesh=mesh)
                flat_g = M.flatten(g)
                for path, acc in M.flatten(grads).items():
                    acc.add_(flat_g[path].to(acc.dtype))
                loss = loss + l
                del g, flat_g
            grads = M.tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            parts = dict(nll=loss, aux=torch.zeros_like(loss))
        params, opt_state, om = opt.update(adamw, params, grads, opt_state,
                                           donate=donate,
                                           shardings=shardings)
        metrics = dict(loss=loss, **parts, **om)
        return params, opt_state, metrics

    def jit_for(batch_abstract):
        tok = batch_abstract["tokens"]
        _check_batch(cfg, batch_abstract, tok.shape[0], tok.shape[1],
                     "train")
        lab = batch_abstract.get("labels")
        if (lab is None or lab.dtype != torch.int32
                or tuple(lab.shape) != tuple(tok.shape)
                or tok.shape[0] % microbatches):
            raise ValueError(
                f"train step: labels {None if lab is None else lab.dtype}"
                f"{None if lab is None else tuple(lab.shape)} for tokens "
                f"{tuple(tok.shape)}, {microbatches} microbatches")
        return step
    return step, jit_for, dict(params=p_sh, opt=o_sh)


def _shardings(cfg: ArchConfig, mesh, max_len: int, batch: int,
               kv_dtype) -> Dict:
    """The reference's {params, cache} shardings on ``mesh`` (one device:
    an abstract (1, 1) mesh, every spec replicated)."""
    mesh = _mesh_or_one(mesh)
    return dict(
        params=shlib.param_shardings(M.abstract_params(cfg), mesh),
        cache=shlib.cache_shardings(
            M.abstract_cache(cfg, batch, max_len, kv_dtype), mesh))


def make_prefill_step(cfg: ArchConfig, mesh, max_len: int, batch: int,
                      kv_dtype=torch.bfloat16):
    """Returns (step, jit_for, {params, cache} shardings).
    ``step(params, tokens, cache, ctx=None) -> (logits, cache)``: on a
    mesh the rank's parameter and cache blocks, the whole batch, the whole
    last-position logits."""
    def step(params, tokens, cache, ctx=None):
        logits, new_cache = M.prefill(params, tokens, cfg, cache=cache,
                                      ctx=ctx, mesh=mesh)
        return logits, new_cache

    def jit_for(batch_abstract):
        _check_batch(cfg, batch_abstract, batch, max_len, "prefill")
        return step
    return step, jit_for, _shardings(cfg, mesh, max_len, batch, kv_dtype)


def make_decode_step(cfg: ArchConfig, mesh, max_len: int, batch: int,
                     kv_dtype=torch.bfloat16):
    """As ``make_prefill_step``: ``step(params, tokens, cache,
    cache_index, ctx=None) -> (logits, cache)``."""
    def step(params, tokens, cache, cache_index, ctx=None):
        logits, new_cache = M.decode_step(params, tokens, cfg, cache=cache,
                                          cache_index=cache_index, ctx=ctx,
                                          mesh=mesh)
        return logits, new_cache

    def jit_for(batch_abstract):
        _check_batch(cfg, batch_abstract, batch, max_len, "decode")
        return step
    return step, jit_for, _shardings(cfg, mesh, max_len, batch, kv_dtype)
