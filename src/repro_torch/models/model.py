"""Model entry points: init / forward / loss / cache management.

Functions of (params, inputs), as in the reference: ``params`` is the
reference's parameter tree as a nested dict of tensors (``LM`` holds one
as an ``nn.Module`` whose ``state_dict`` keys are the tree's paths joined
by "."), and the KV/SSM cache is a nested dict of tensors that prefill and
decode update in place (the reference donates it).  ``abstract_params`` and
``abstract_cache`` build the same trees on the meta device: shapes and
dtypes, nothing allocated.
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
from repro_torch.models.layers import rms_norm
from repro_torch.models.part import check_mesh, constrain

F32 = torch.float32
BF16 = torch.bfloat16


def init_params(cfg: ArchConfig, rng: Optional[torch.Generator],
                device="cuda") -> Dict:
    """Random parameters from ``rng`` (a generator on ``device``), with the
    reference's key paths, shapes, dtypes and scales.  The draws are
    torch's, so the weights differ from the reference's ``jax.random``
    ones: to run the reference's weights, use ``load_numpy_params``."""
    device = check_device(device)
    return T.init_params(cfg, rng, device)


def seeded_params(cfg: ArchConfig, seed: int, device="cuda") -> Dict:
    """Random parameters drawn on the host from numpy's generator seeded
    ``seed`` (PCG64), then moved to ``device``: the same weights on every
    host, card and torch version (the goldens' weights)."""
    device = check_device(device)
    tree = T.init_params(cfg, np.random.default_rng(seed), "cpu")
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


def load_numpy_params(cfg: ArchConfig, tree: Dict, device) -> Dict:
    """The reference's parameters, a nested dict of numpy arrays, as the
    port's tree on ``device``.  bf16 leaves arrive as their uint16 bit
    patterns (``.view(np.uint16)``) and are reinterpreted as bf16; every
    key, shape and dtype must match ``abstract_params(cfg)``."""
    device = check_device(device)
    want = flatten(abstract_params(cfg))
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
               device="cuda") -> Dict:
    device = check_device(device)
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
                mesh=None, remat: bool = True):
    """Audio: run the stub frame embeddings through the encoder stack."""
    if cfg.family != "audio":
        return ctx
    Tc = ctx.shape[1]
    x = ctx.to(BF16) + params["enc_pos"][None, :Tc, :]
    pos = torch.arange(Tc, device=x.device)
    x, _, _ = T.run_stack(params["enc_blocks"], x, cfg, pos=pos,
                          blocks_key="enc_blocks", remat=remat, mesh=mesh)
    return rms_norm(x, params["enc_final_norm"])


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            ctx: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, cache_index=0, remat: bool = True,
            mesh=None):
    """tokens: (B, S) int32.  ctx: (B, Tc, d_model) stub embeddings for
    vlm/audio.  cache_index: a python int (the host keeps the position).
    Returns (logits (B,S,V) f32, new_cache, aux); the cache is updated in
    place and returned."""
    check_mesh(mesh)
    B, S = tokens.shape
    # the reference's one-hot matmul under a mesh gathers the same rows
    x = torch.nn.functional.embedding(tokens, params["embed"])
    x = constrain(x, mesh, ("dp", None, None))
    if cache is None:
        pos = torch.arange(S, device=x.device)
    else:
        cache_index = int(cache_index)
        pos = cache_index + torch.arange(S, device=x.device)
    enc = (_encode_ctx(params, cfg, ctx, mesh=mesh, remat=remat)
           if ctx is not None else None)
    x, new_cache, aux = T.run_stack(params["blocks"], x, cfg, pos=pos,
                                    cache=cache, cache_index=cache_index,
                                    ctx=enc, remat=remat, mesh=mesh)
    x = rms_norm(x, params["final_norm"])
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    # the logits are rounded to bf16 once, as the reference's einsum of
    # two bf16 operands is, then widened
    logits = torch.matmul(x, head).to(F32)
    return logits, new_cache, aux


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
    autograd through ``loss_fn`` on leaves detached from ``params``."""
    flat = flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, parts = loss_fn(unflatten(leaves), batch, cfg, mesh=mesh,
                              remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
    parts = {k: v.detach() for k, v in parts.items()}
    return (loss.detach(), parts), unflatten(dict(zip(leaves, grads)))


def prefill(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            cache: Dict, ctx: Optional[torch.Tensor] = None, mesh=None):
    """Write the prompt into the cache; return last-position logits."""
    logits, new_cache, _ = forward(params, tokens, cfg, ctx=ctx, cache=cache,
                                   cache_index=0, mesh=mesh)
    return logits[:, -1, :], new_cache


def decode_step(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                cache: Dict, cache_index,
                ctx: Optional[torch.Tensor] = None, mesh=None):
    """tokens: (B, 1) — one decode step at position cache_index."""
    logits, new_cache, _ = forward(params, tokens, cfg, ctx=ctx, cache=cache,
                                   cache_index=cache_index, remat=False,
                                   mesh=mesh)
    return logits[:, -1, :], new_cache


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
