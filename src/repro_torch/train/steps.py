"""Step factories of the LM serving path: prefill and decode steps.

The reference's factories return ``(step, jit_for, shardings)``, where
``jit_for(batch_abstract)`` jits the step with sharded in/out specs and
donates the cache.  Here the LM runs on one device: ``jit_for`` checks the
batch stand-ins against the factory's batch and returns the step, the
cache is updated in place (the donation), and the third item holds the
parameter and cache trees on the meta device.  A mesh of several devices
raises (``part.check_mesh``).  The training step is the training slice's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.models.part import check_mesh


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


def make_prefill_step(cfg: ArchConfig, mesh, max_len: int, batch: int,
                      kv_dtype=torch.bfloat16):
    check_mesh(mesh)
    params_abs = M.abstract_params(cfg)
    cache_abs = M.abstract_cache(cfg, batch, max_len, kv_dtype)

    def step(params, tokens, cache, ctx=None):
        logits, new_cache = M.prefill(params, tokens, cfg, cache=cache,
                                      ctx=ctx, mesh=mesh)
        return logits, new_cache

    def jit_for(batch_abstract):
        _check_batch(cfg, batch_abstract, batch, max_len, "prefill")
        return step
    return step, jit_for, dict(params=params_abs, cache=cache_abs)


def make_decode_step(cfg: ArchConfig, mesh, max_len: int, batch: int,
                     kv_dtype=torch.bfloat16):
    check_mesh(mesh)
    params_abs = M.abstract_params(cfg)
    cache_abs = M.abstract_cache(cfg, batch, max_len, kv_dtype)

    def step(params, tokens, cache, cache_index, ctx=None):
        logits, new_cache = M.decode_step(params, tokens, cfg, cache=cache,
                                          cache_index=cache_index, ctx=ctx,
                                          mesh=mesh)
        return logits, new_cache

    def jit_for(batch_abstract):
        _check_batch(cfg, batch_abstract, batch, max_len, "decode")
        return step
    return step, jit_for, dict(params=params_abs, cache=cache_abs)
