"""Model entry points: init / forward / loss / cache management.

Functions of (params, inputs), as in the reference: ``params`` is the
reference's parameter tree as a nested dict of tensors (``LM`` holds one
as an ``nn.Module`` whose ``state_dict`` keys are the tree's paths joined
by "."), and the KV/SSM cache is a nested dict of tensors that prefill and
decode update in place (the reference donates it).  ``abstract_params`` and
``abstract_cache`` build the same trees on the meta device: shapes and
dtypes, nothing allocated.

On a mesh of several devices (``launch.mesh.Mesh``, one process a rank;
``part`` says how the layers split the work) a rank holds only its
blocks: ``init_params``, ``seeded_params`` and ``load_numpy_params`` cut
each leaf as it is made (``distributed.sharding.param_spec``), bit for bit
the one-device tensors' blocks, and ``init_cache`` allocates the rank's
cache blocks (``cache_spec``).  ``forward``, ``prefill`` and
``decode_step`` then take the whole batch on every rank (each computes its
rows: ``batch_specs``) and return the whole logits on every rank.
``loss_fn`` computes the loss alike on every rank, and ``value_and_grad``
gives each rank its gradient blocks (``part`` says how each collective's
gradient flows).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import check_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import column_parallel, rms_norm
from repro_torch.distributed.sharding import (block, cache_shardings,
                                             local_shape)
from repro_torch.models import part
from repro_torch.models.part import constrain

F32 = torch.float32
BF16 = torch.bfloat16


def init_params(cfg: ArchConfig, rng: Optional[torch.Generator],
                device="cuda", mesh=None) -> Dict:
    """Random parameters from ``rng`` (a generator on ``device``), with the
    reference's key paths, shapes, dtypes and scales (on a mesh, the rank's
    blocks of them).  The draws are torch's, so the weights differ from
    the reference's ``jax.random`` ones: to run the reference's weights,
    use ``load_numpy_params``."""
    device = check_device(device)
    return T.init_params(cfg, rng, device, mesh)


def seeded_params(cfg: ArchConfig, seed: int, device="cuda",
                  mesh=None) -> Dict:
    """Random parameters drawn on the host from numpy's generator seeded
    ``seed`` (PCG64), then moved to ``device``: the same weights on every
    host, card and torch version (the goldens' weights); on a mesh, the
    rank's blocks of them."""
    device = check_device(device)
    tree = T.init_params(cfg, np.random.default_rng(seed), "cpu", mesh)
    return tree_map(lambda t: t.to(device), tree)


def tree_map(fn, tree: Dict) -> Dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def abstract_params(cfg: ArchConfig) -> Dict:
    """The parameter tree on the meta device (no allocation)."""
    return T.init_params(cfg, None, "meta")


def flatten(tree: Dict, prefix: str = "") -> Dict[str, object]:
    """{path: leaf} of a nested dict, paths joined by "." in sorted key
    order (the reference's tree order)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "."))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, object]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def load_numpy_params(cfg: ArchConfig, tree: Dict, device,
                      mesh=None) -> Dict:
    """The reference's parameters, a nested dict of numpy arrays, as the
    port's tree on ``device`` (on a mesh, the rank's blocks of them).
    bf16 leaves arrive as their uint16 bit patterns (``.view(np.uint16)``)
    and are reinterpreted as bf16; every key, shape and dtype must match
    ``abstract_params(cfg)``."""
    device = check_device(device)
    want = flatten(abstract_params(cfg))
    specs = (flatten(part.param_specs(cfg, mesh)) if part.sharded(mesh)
             else {})
    got = flatten(tree)
    if set(got) != set(want):
        raise ValueError(
            f"{cfg.name}: parameter keys differ: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    out = {}
    for path, ref in want.items():
        arr = np.asarray(got[path])
        bits = ref.dtype == BF16
        dt = np.uint16 if bits else np.dtype(str(ref.dtype).split(".")[-1])
        if arr.dtype != dt or tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"{cfg.name}: {path} is {arr.dtype}{tuple(arr.shape)}, "
                f"expected {dt}{tuple(ref.shape)}"
                + (" (bf16 as its uint16 bits)" if bits else ""))
        if path in specs:
            arr = block(arr, specs[path], mesh)
        t = torch.from_numpy(np.array(arr))          # a writable copy
        out[path] = (t.view(BF16) if bits else t).to(device)
    return unflatten(out)


class LM(nn.Module):
    """A parameter tree as an ``nn.Module``: ``state_dict`` keys are the
    tree's paths (``blocks.slot0.attn.wq``), with the reference's shapes
    stacked over groups, each a leaf that requires a gradient; ``params``
    gives the tree back for the functions of this module."""

    def __init__(self, cfg: ArchConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        _register(self, params)

    @property
    def params(self) -> Dict:
        return _tree(self)

    def forward(self, tokens, **kw):
        return forward(self.params, tokens, self.cfg, **kw)


def _register(module: nn.Module, tree: Dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            module.add_module(k, child)
        else:
            module.register_parameter(k, nn.Parameter(v))


def _tree(module: nn.Module) -> Dict:
    out: Dict = dict(module._parameters)
    out.update({k: _tree(m) for k, m in module._modules.items()})
    return out


# --------------------------------------------------------------------------- #
# KV / SSM cache
# --------------------------------------------------------------------------- #
def _slot_cache(cfg: ArchConfig, kind: str, G: int, B: int, T_max: int,
                kv_dtype=BF16, device="cuda") -> Dict:
    K, Dh = cfg.n_kv, cfg.d_head
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    if kv_dtype == torch.int8:
        # quantized cache: int8 values + per-(token, head) bf16 scales
        kv = lambda: dict(
            k=zeros((G, B, T_max, K, Dh), torch.int8),
            k_scale=zeros((G, B, T_max, K, 1), BF16),
            v=zeros((G, B, T_max, K, Dh), torch.int8),
            v_scale=zeros((G, B, T_max, K, 1), BF16))
    else:
        kv = lambda: dict(k=zeros((G, B, T_max, K, Dh), kv_dtype),
                          v=zeros((G, B, T_max, K, Dh), kv_dtype))
    ssm = lambda: dict(
        conv=zeros((G, B, cfg.ssm_conv - 1, cfg.d_inner), BF16),
        state=zeros((G, B, cfg.n_ssm_heads, cfg.ssm_state,
                     cfg.ssm_head_dim), F32))
    if kind in ("self", "self_moe", "dec"):
        return kv()
    if kind == "hybrid":
        return dict(attn=kv(), ssm=ssm())
    if kind == "ssd":
        return ssm()
    if kind == "cross":
        return {}
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, kv_dtype=BF16,
               device="cuda", mesh=None) -> Dict:
    """The zero cache of ``batch`` rows and ``max_len`` positions (on a
    mesh of several devices, the rank's blocks of it: ``cache_spec``)."""
    device = check_device(device)
    if part.sharded(mesh):
        abstract = abstract_cache(cfg, batch, max_len, kv_dtype)

        def local(a, sh):
            if isinstance(a, dict):
                return {k: local(v, sh[k]) for k, v in a.items()}
            return torch.zeros(local_shape(tuple(a.shape), sh.spec, mesh),
                               dtype=a.dtype, device=device)
        return local(abstract, cache_shardings(abstract, mesh))
    pattern = T.layer_pattern(cfg)
    G = T.n_groups(cfg)
    return {f"slot{j}": _slot_cache(cfg, kind, G, batch, max_len, kv_dtype,
                                    device)
            for j, kind in enumerate(pattern)}


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int,
                   kv_dtype=BF16) -> Dict:
    return init_cache(cfg, batch, max_len, kv_dtype, "meta")


# --------------------------------------------------------------------------- #
# Forward passes
# --------------------------------------------------------------------------- #
def _encode_ctx(params: Dict, cfg: ArchConfig, ctx: torch.Tensor,
                mesh=None, remat: bool = True, batch_axes=()):
    """Audio: run the stub frame embeddings through the encoder stack (on
    a mesh, the rank's rows of a batch split over ``batch_axes``)."""
    if cfg.family != "audio":
        return ctx
    Tc = ctx.shape[1]
    x = ctx.to(BF16) + params["enc_pos"][None, :Tc, :]
    pos = torch.arange(Tc, device=x.device)
    x, _, _ = T.run_stack(params["enc_blocks"], x, cfg, pos=pos,
                          blocks_key="enc_blocks", remat=remat, mesh=mesh,
                          batch_axes=batch_axes)
    return rms_norm(x, params["enc_final_norm"])


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            ctx: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, cache_index=0, remat: bool = True,
            mesh=None):
    """tokens: (B, S) int32.  ctx: (B, Tc, d_model) stub embeddings for
    vlm/audio.  cache_index: a python int (the host keeps the position).
    Returns (logits (B,S,V) f32, new_cache, aux); the cache is updated in
    place and returned.  On a mesh of several devices ``params`` and
    ``cache`` are the rank's blocks, ``tokens`` and ``ctx`` the whole
    batch, and the logits come back whole on every rank."""
    logits, new_cache, aux = _forward(params, tokens, cfg, ctx, cache,
                                      cache_index, remat, mesh)
    return _whole_logits(logits, cfg, mesh, tokens.shape[0]), new_cache, aux


def _forward(params, tokens, cfg, ctx, cache, cache_index, remat, mesh):
    """``forward`` with the rank's logits: (its rows, S, its vocab block)
    on a mesh of several devices."""
    specs, bax = None, ()
    if part.sharded(mesh):
        specs = part.param_specs(cfg, mesh)
        bax = part.batch_axes(mesh, tokens.shape[0])
        tokens = part.batch_block(tokens, bax, mesh)
        ctx = part.batch_block(ctx, bax, mesh)
    B, S = tokens.shape
    embed, head = params["embed"], params.get("lm_head")
    if specs is not None:
        outer = {k: params[k] for k in ("embed", "lm_head") if k in params}
        outer = part.gather_fsdp(outer, {k: specs[k] for k in outer}, mesh,
                                 bax)
        embed, head = outer["embed"], outer.get("lm_head")
    if embed.shape[0] == cfg.vocab:
        # the reference's one-hot matmul under a mesh gathers the same rows
        x = torch.nn.functional.embedding(tokens, embed)
    else:
        # the rank's vocabulary rows (the reference's one-hot product over
        # the 'model'-split table): its tokens' rows, zero elsewhere, summed
        # over 'model' (one term a token: exact)
        i = tokens - part.tp_index(mesh) * embed.shape[0]
        own = (i >= 0) & (i < embed.shape[0])
        x = torch.nn.functional.embedding(torch.where(own, i, 0), embed)
        x = part.tp_sum(x * own[..., None].to(x.dtype), mesh)
    x = constrain(x, mesh, ("dp", None, None))
    if cache is None:
        pos = torch.arange(S, device=x.device)
    else:
        cache_index = int(cache_index)
        pos = cache_index + torch.arange(S, device=x.device)
    enc = (_encode_ctx(params, cfg, ctx, mesh=mesh, remat=remat,
                       batch_axes=bax) if ctx is not None else None)
    x, new_cache, aux = T.run_stack(params["blocks"], x, cfg, pos=pos,
                                    cache=cache, cache_index=cache_index,
                                    ctx=enc, remat=remat, mesh=mesh,
                                    batch_axes=bax)
    x = rms_norm(x, params["final_norm"])
    if head is None:
        head = embed.T
    # the logits are rounded to bf16 once, as the reference's einsum of
    # two bf16 operands is, then widened (on a mesh, the rank's vocabulary
    # columns where the head splits them)
    logits, = column_parallel(x, (head,), (cfg.vocab,), mesh, torch.matmul)
    logits = logits.to(F32)
    return logits, new_cache, aux


def _whole_logits(logits: torch.Tensor, cfg: ArchConfig, mesh,
                  batch: int) -> torch.Tensor:
    """The rank's logits (rows, ..., vocabulary block) made whole."""
    if not part.sharded(mesh):
        return logits
    if logits.shape[-1] < cfg.vocab:
        logits = part.tp_gather(logits, -1, mesh)
    bax = part.batch_axes(mesh, batch)
    if bax:
        logits = part.gather([logits], [0], bax, mesh)[0]
    return logits


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig,
            aux_weight: float = 0.01, mesh=None,
            remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """batch: {'tokens' (B,S), 'labels' (B,S)[, 'ctx' (B,Tc,d)]}.
    Returns (loss, {'nll', 'aux'}); differentiable in the parameters
    (``value_and_grad``), the layer groups rematerialised in the backward
    pass (``transformer.run_stack``)."""
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             ctx=batch.get("ctx"), remat=remat, mesh=mesh)
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    # the reference contracts with a one-hot (for sharding); the gathered
    # logit is the same value
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (logz - gold).mean()
    loss = nll + aux_weight * aux
    return loss, dict(nll=nll, aux=aux)


def value_and_grad(params: Dict, batch: Dict, cfg: ArchConfig, mesh=None,
                   remat: bool = True
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, parts),
    grads), the gradients a tree like ``params`` (each leaf's dtype), by
    autograd through ``loss_fn`` on leaves detached from ``params``.  On
    a mesh of several devices ``params`` are the rank's blocks and so are
    the gradients: the collectives' adjoints sum the partials of the
    leaves they gather, and ``part.reduce_replicated`` those of the
    leaves replicated over the axes the batch is split on."""
    flat = flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, parts = loss_fn(unflatten(leaves), batch, cfg, mesh=mesh,
                              remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
    parts = {k: v.detach() for k, v in parts.items()}
    grads = dict(zip(leaves, grads))
    if part.sharded(mesh):
        grads = part.reduce_replicated(
            grads, flatten(part.param_specs(cfg, mesh)),
            part.batch_axes(mesh, batch["tokens"].shape[0]), mesh)
    return (loss.detach(), parts), unflatten(grads)


def prefill(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            cache: Dict, ctx: Optional[torch.Tensor] = None, mesh=None):
    """Write the prompt into the cache; return last-position logits."""
    logits, new_cache, _ = _forward(params, tokens, cfg, ctx, cache, 0,
                                    True, mesh)
    return _whole_logits(logits[:, -1, :], cfg, mesh,
                         tokens.shape[0]), new_cache


def decode_step(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                cache: Dict, cache_index,
                ctx: Optional[torch.Tensor] = None, mesh=None):
    """tokens: (B, 1) — one decode step at position cache_index."""
    logits, new_cache, _ = _forward(params, tokens, cfg, ctx, cache,
                                    cache_index, False, mesh)
    return _whole_logits(logits[:, -1, :], cfg, mesh,
                         tokens.shape[0]), new_cache


def param_count(cfg: ArchConfig) -> int:
    tree = abstract_params(cfg)
    return sum(math.prod(l.shape) for l in flatten(tree).values())


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    G = T.n_groups(cfg)
    n_moe_layers = G  # one moe slot per group
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive
