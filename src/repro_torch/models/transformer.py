"""Unified decoder stack for all assigned architectures.

Layers are organized in GROUPS so heterogeneous stacks share one
parameter layout: the layer pattern (e.g. Llama-4's [dense, moe],
Llama-3.2-Vision's [self x4, cross]) repeats n_layers/len(pattern) times,
and parameters are stacked per pattern slot with a leading group axis G.
The reference scans the groups (``lax.scan``); the port loops over them
in Python, indexing each stacked tensor at the group.  On a mesh each
group's leaves are gathered over the DP axes (FSDP) just before it runs
(``part.gather_fsdp``; under remat inside the checkpointed group, so the
backward pass gathers them again and reduce-scatters their gradients),
and the layers sum their row-parallel outputs over 'model' (``part``).

Families:
    dense   — pre-norm GQA attention + SwiGLU (SWA / qk-norm variants)
    moe     — attention + routed experts (moe.py), optional dense interleave
    hybrid  — Hymba: parallel attention & SSM branches + SwiGLU
    vlm     — decoder with cross-attention layers every k-th layer
    audio   — Whisper: bidirectional encoder + causal decoder w/ cross-attn
    ssm     — Mamba-2 (SSD), attention-free
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import block, local_shape
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import part
from repro_torch.models.layers import (AttnSpec, apply_rope, attend,
                                       attention, column_parallel,
                                       mha_online, project_heads,
                                       project_out, rms_norm, store_kv,
                                       swiglu, whole_kv)
from repro_torch.models.part import constrain

F32 = torch.float32
BF16 = torch.bfloat16


# --------------------------------------------------------------------------- #
# Layer patterns
# --------------------------------------------------------------------------- #
def layer_pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.family == "dense":
        return ("self",)
    if cfg.family == "moe":
        if cfg.moe_every == 2:
            return ("self", "self_moe")
        return ("self_moe",)
    if cfg.family == "hybrid":
        return ("hybrid",)
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        return tuple(["self"] * (k - 1) + ["cross"])
    if cfg.family == "audio":
        return ("dec",)
    if cfg.family == "ssm":
        return ("ssd",)
    raise ValueError(cfg.family)


def n_groups(cfg: ArchConfig) -> int:
    p = layer_pattern(cfg)
    assert cfg.n_layers % len(p) == 0, (cfg.name, cfg.n_layers, p)
    return cfg.n_layers // len(p)


def attn_spec(cfg: ArchConfig, *, causal=True, window=None) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
                    causal=causal, window=window, qk_norm=cfg.qk_norm,
                    rope_theta=cfg.rope_theta)


# --------------------------------------------------------------------------- #
# Parameter init: the reference's key paths, shapes, dtypes and scales,
# drawn in a fixed order from one torch.Generator (None on the meta device:
# shapes only, nothing allocated)
# --------------------------------------------------------------------------- #
class _Init:
    """Draws for init_params: from a torch.Generator on ``device``, from a
    numpy Generator on the host (the same weights on every host and torch
    version), or none on the meta device.  With ``mesh`` and ``specs``
    (the spec of each leaf, in the order they are drawn) a leaf keeps the
    rank's block alone, cut from each group's draw as it is made: the
    same draws, and the same values, as on one device."""

    def __init__(self, rng, device, mesh=None, specs=None):
        self.rng, self.device = rng, torch.device(device)
        self.mesh, self.specs = mesh, specs
        self.made = []                     # the leaves, in draw order

    def lin(self, shape, scale, dtype=BF16):
        spec = self.specs[len(self.made)] if self.specs else None
        out = self._lin(shape, scale, dtype, spec)
        self.made.append(out)
        return out

    def _lin(self, shape, scale, dtype, spec):
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        # a stacked (G, ...) leaf is drawn one group at a time, so the f32
        # draw held beside the weights is one layer's, not the stack's (a
        # stacked leaf's spec never splits G)
        stacked = len(shape) > 2
        sub = spec[1:] if spec is not None and stacked else spec
        local = shape if spec is None else local_shape(shape, spec,
                                                       self.mesh)
        out = torch.empty(local, dtype=dtype, device=self.device)
        for dst in (out if stacked else (out,)):
            part_shape = shape[1:] if stacked else shape
            if isinstance(self.rng, np.random.Generator):
                x = self.rng.standard_normal(part_shape, dtype=np.float32)
                x = torch.from_numpy(x * np.float32(scale)).to(dtype)
            else:
                x = torch.randn(part_shape, generator=self.rng, dtype=F32,
                                device=self.device).mul_(scale)
            dst.copy_(x if sub is None else block(x, sub, self.mesh))
        return out

    def full(self, shape, value, dtype=BF16):
        spec = self.specs[len(self.made)] if self.specs else None
        if spec is not None:
            shape = local_shape(shape, spec, self.mesh)
        out = torch.full(shape, value, dtype=dtype, device=self.device)
        self.made.append(out)
        return out


def _init_attn(ini: _Init, cfg: ArchConfig, G: int, cross=False) -> Dict:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    s_in = 0.02
    s_out = 0.02 / (2 * cfg.n_layers) ** 0.5
    p = dict(
        wq=ini.lin((G, d, H * Dh), s_in),
        wk=ini.lin((G, d, K * Dh), s_in),
        wv=ini.lin((G, d, K * Dh), s_in),
        wo=ini.lin((G, H * Dh, d), s_out),
    )
    if cfg.qk_norm and not cross:
        p["q_norm"] = ini.full((G, Dh), 1.0)
        p["k_norm"] = ini.full((G, Dh), 1.0)
    return p


def _init_mlp(ini: _Init, cfg: ArchConfig, G: int, d_ff: int) -> Dict:
    d = cfg.d_model
    s_in = 0.02
    s_out = 0.02 / (2 * cfg.n_layers) ** 0.5
    return dict(w_gate=ini.lin((G, d, d_ff), s_in),
                w_up=ini.lin((G, d, d_ff), s_in),
                w_down=ini.lin((G, d_ff, d), s_out))


def _init_moe(ini: _Init, cfg: ArchConfig, G: int) -> Dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    s_in, s_out = 0.02, 0.02 / (2 * cfg.n_layers) ** 0.5
    p = dict(router=ini.lin((G, d, E), s_in, F32),
             w_gate=ini.lin((G, E, d, f), s_in),
             w_up=ini.lin((G, E, d, f), s_in),
             w_down=ini.lin((G, E, f, d), s_out))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p.update(sh_gate=ini.lin((G, d, fs), s_in),
                 sh_up=ini.lin((G, d, fs), s_in),
                 sh_down=ini.lin((G, fs, d), s_out))
    return p


def _init_ssm(ini: _Init, cfg: ArchConfig, G: int) -> Dict:
    d, d_in = cfg.d_model, cfg.d_inner
    H, N, W = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_conv
    e = 2 * d_in + 2 * N + H
    s_in, s_out = 0.02, 0.02 / (2 * cfg.n_layers) ** 0.5
    return dict(
        in_proj=ini.lin((G, d, e), s_in),
        conv_w=ini.lin((G, W, d_in), 0.2),
        A_log=ini.full((G, H), 0.0, F32),
        D=ini.full((G, H), 1.0, F32),
        dt_bias=ini.full((G, H), 0.0, F32),
        gate_norm=ini.full((G, d_in), 1.0),
        out_proj=ini.lin((G, d_in, d), s_out),
    )


def _init_block(ini: _Init, cfg: ArchConfig, kind: str, G: int) -> Dict:
    d = cfg.d_model
    ones = lambda: ini.full((G, d), 1.0)
    if kind == "self":
        return dict(ln1=ones(), attn=_init_attn(ini, cfg, G),
                    ln2=ones(), mlp=_init_mlp(ini, cfg, G, cfg.d_ff))
    if kind == "self_moe":
        return dict(ln1=ones(), attn=_init_attn(ini, cfg, G),
                    ln2=ones(), moe=_init_moe(ini, cfg, G))
    if kind == "cross":
        return dict(ln1=ones(), xattn=_init_attn(ini, cfg, G, cross=True),
                    ln2=ones(), mlp=_init_mlp(ini, cfg, G, cfg.d_ff))
    if kind == "hybrid":
        return dict(ln1=ones(), attn=_init_attn(ini, cfg, G),
                    ssm=_init_ssm(ini, cfg, G),
                    norm_attn=ones(), norm_ssm=ones(),
                    ln2=ones(), mlp=_init_mlp(ini, cfg, G, cfg.d_ff))
    if kind == "dec":
        return dict(ln1=ones(), attn=_init_attn(ini, cfg, G),
                    ln_x=ones(), xattn=_init_attn(ini, cfg, G, cross=True),
                    ln2=ones(), mlp=_init_mlp(ini, cfg, G, cfg.d_ff))
    if kind == "enc":
        return dict(ln1=ones(), attn=_init_attn(ini, cfg, G),
                    ln2=ones(), mlp=_init_mlp(ini, cfg, G, cfg.d_ff))
    if kind == "ssd":
        return dict(ln1=ones(), ssm=_init_ssm(ini, cfg, G))
    raise ValueError(kind)


def _draw_specs(cfg: ArchConfig, mesh) -> list:
    """The spec of each leaf ``init_params`` draws, in draw order."""
    ini = _Init(None, "meta")
    tree = _build(ini, cfg)
    specs = part.param_specs(cfg, mesh)
    path_of = {}

    def walk(node, sp):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, sp[k])
            else:
                path_of[id(v)] = sp[k]
    walk(tree, specs)
    return [path_of[id(t)] for t in ini.made]


def init_params(cfg: ArchConfig, rng, device, mesh=None) -> Dict:
    """The parameter tree on ``device`` (``_Init`` says what ``rng`` may
    be); with a mesh of several devices, the rank's blocks of it."""
    if not part.sharded(mesh):
        return _build(_Init(rng, device), cfg)
    return _build(_Init(rng, device, mesh, _draw_specs(cfg, mesh)), cfg)


def _build(ini: _Init, cfg: ArchConfig) -> Dict:
    pattern = layer_pattern(cfg)
    G = n_groups(cfg)
    params: Dict = dict(
        embed=ini.lin((cfg.vocab, cfg.d_model), 0.02),
        final_norm=ini.full((cfg.d_model,), 1.0),
        blocks={f"slot{j}": _init_block(ini, cfg, kind, G)
                for j, kind in enumerate(pattern)},
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.lin((cfg.d_model, cfg.vocab), 0.02)
    if cfg.family == "audio":
        Ge = cfg.n_enc_layers
        params["enc_blocks"] = {"slot0": _init_block(
            ini, cfg.replace(n_layers=Ge), "enc", Ge)}
        params["enc_final_norm"] = ini.full((cfg.d_model,), 1.0)
        params["enc_pos"] = ini.lin((cfg.n_ctx_tokens, cfg.d_model), 0.02)
    return params


# --------------------------------------------------------------------------- #
# Block application
# --------------------------------------------------------------------------- #
def _apply_block(x, bp, kind: str, cfg: ArchConfig, *, pos, is_global=None,
                 cache=None, cache_index=None, ctx=None, mesh=None,
                 batch_axes=()):
    """One layer.  Returns (x, new_cache, aux); aux is 0.0 for a block
    without experts (no tensor, no launch).  On a mesh ``batch_axes`` are
    the DP axes the batch is split over (the MoE routes the whole
    batch's token groups)."""
    aux = 0.0
    new_cache = cache
    x = constrain(x, mesh, ("dp", "tp", None))

    if kind == "ssd":
        h, new_cache = ssm_lib.ssd_block(rms_norm(x, bp["ln1"]), bp["ssm"],
                                         cfg, cache, mesh=mesh)
        return x + h, new_cache, aux

    if kind == "hybrid":
        xin = rms_norm(x, bp["ln1"])
        window = (1 << 30) if is_global else cfg.swa_window
        spec = attn_spec(cfg, window=None)  # window applied via valid mask
        a_cache = None if cache is None else cache.get("attn")
        s_cache = None if cache is None else cache.get("ssm")
        a_out, a_cache = _windowed_attention(xin, bp["attn"], spec, window,
                                             pos, a_cache, cache_index,
                                             mesh=mesh)
        s_out, s_cache = ssm_lib.ssd_block(xin, bp["ssm"], cfg, s_cache,
                                           mesh=mesh)
        h = 0.5 * (rms_norm(a_out, bp["norm_attn"]) +
                   rms_norm(s_out, bp["norm_ssm"]))
        x = x + h.to(x.dtype)
        x = x + swiglu(rms_norm(x, bp["ln2"]), **bp["mlp"], mesh=mesh,
                       d_ff=cfg.d_ff)
        if cache is not None:
            new_cache = dict(attn=a_cache, ssm=s_cache)
        return x, new_cache, aux

    # attention part (self / cross / dec)
    if kind in ("self", "self_moe", "enc"):
        spec = attn_spec(cfg, causal=kind != "enc", window=cfg.swa_window)
        h, new_cache = attention(rms_norm(x, bp["ln1"]), bp["attn"], spec,
                                 pos=pos, cache=cache,
                                 cache_index=cache_index, mesh=mesh)
        x = x + h
    elif kind == "cross":
        spec = attn_spec(cfg, causal=False)
        kx, vx = _ctx_kv(ctx, bp["xattn"], cfg, mesh)
        h, _ = attention(rms_norm(x, bp["ln1"]), bp["xattn"], spec, pos=pos,
                         ctx_kv=(kx, vx), mesh=mesh)
        x = x + h
    elif kind == "dec":
        spec = attn_spec(cfg, causal=True)
        h, new_cache = attention(rms_norm(x, bp["ln1"]), bp["attn"], spec,
                                 pos=pos, cache=cache,
                                 cache_index=cache_index, mesh=mesh)
        x = x + h
        kx, vx = _ctx_kv(ctx, bp["xattn"], cfg, mesh)
        hx, _ = attention(rms_norm(x, bp["ln_x"]), bp["xattn"],
                          attn_spec(cfg, causal=False), pos=pos,
                          ctx_kv=(kx, vx), mesh=mesh)
        x = x + hx
    else:
        raise ValueError(kind)

    # FFN part
    if kind == "self_moe":
        h, aux = moe_lib.moe_ffn(rms_norm(x, bp["ln2"]), bp["moe"], cfg,
                                 mesh=mesh, batch_axes=batch_axes)
        x = x + h
    else:
        x = x + swiglu(rms_norm(x, bp["ln2"]), **bp["mlp"], mesh=mesh,
                       d_ff=cfg.d_ff)
    return x, new_cache, aux


def _ctx_kv(ctx, p, cfg: ArchConfig, mesh=None):
    """Cross-attention keys and values of the context (B, Tc, d)."""
    K, D = cfg.n_kv, cfg.d_head
    ts = (column_parallel(ctx, (p["wk"], p["wv"]), (K * D, K * D), mesh)
          if part.sharded(mesh) else (None, None))
    return (project_heads(ctx, p["wk"], K, D, mesh, ts[0]),
            project_heads(ctx, p["wv"], K, D, mesh, ts[1]))


def _windowed_attention(x, p, spec: AttnSpec, window, pos, cache,
                        cache_index, mesh=None):
    """Attention with a per-layer window bound (hybrid stacks mix SWA and
    global layers in one stack), applied as a clip on key positions inside
    the online softmax (the reference's ``_mha_dyn_window``: ``attend``
    with the window, as ``_mha_dyn_window`` below is).  Its
    cache is written as the reference writes it, a plain cast into the
    cache's dtype."""
    S = x.shape[1]
    H, K, D = spec.n_heads, spec.n_kv, spec.d_head
    ts = (column_parallel(x, (p["wq"], p["wk"], p["wv"]),
                          (H * D, K * D, K * D), mesh)
          if part.sharded(mesh) else (None,) * 3)
    q = project_heads(x, p["wq"], H, D, mesh, ts[0])
    k = project_heads(x, p["wk"], K, D, mesh, ts[1])
    v = project_heads(x, p["wv"], K, D, mesh, ts[2])
    q = constrain(q, mesh, ("dp", None, "tp", None))
    q = apply_rope(q, pos, spec.rope_theta)
    k = apply_rope(k, pos, spec.rope_theta)
    new_cache = cache
    grouped = dict(H=H, K=K, mesh=mesh, causal=True, window=window,
                   chunk=spec.kv_chunk)
    if cache is None:
        out = attend(q, k, v, q_offset=0, valid_len=S, **grouped)
    else:
        ck = store_kv(cache["k"], k, cache_index, mesh)
        cv = store_kv(cache["v"], v, cache_index, mesh)
        new_cache = dict(k=ck, v=cv)
        out = attend(q, whole_kv(ck, D, mesh).to(q.dtype),
                     whole_kv(cv, D, mesh).to(q.dtype),
                     q_offset=cache_index, valid_len=cache_index + S,
                     **grouped)
    return project_out(out, p["wo"], H, D, mesh), new_cache


def _mha_dyn_window(q, k, v, window, *, q_offset, valid_len, chunk):
    """The reference's mha_online with a traced window size: causal, with
    the window clip, in mha_online's order of operations — which is
    ``mha_online`` itself here, where a window is a plain int."""
    return mha_online(q, k, v, causal=True, window=window,
                      q_offset=q_offset, valid_len=valid_len, chunk=chunk)


# --------------------------------------------------------------------------- #
# Stack forward (a loop over groups)
# --------------------------------------------------------------------------- #
def _group_extras(cfg: ArchConfig) -> Dict[str, List[List[bool]]]:
    """Per-group extras (e.g. hybrid global-layer flags, (G, len(pattern)))."""
    pattern = layer_pattern(cfg)
    G = n_groups(cfg)
    if cfg.family == "hybrid":
        flags = [[False] * len(pattern) for _ in range(G)]
        for g in cfg.global_layers:
            gi, si = divmod(g, len(pattern))
            flags[gi][si] = True
        return dict(is_global=flags)
    return {}


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _at(tree, g: int):
    """The group-g slice of a stacked tree (views: in-place cache writes
    land in the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _at(v, g) for k, v in tree.items()}
    return tree[g]


def _unbind(tree, G: int) -> List:
    """The G group slices of a stacked parameter tree, each leaf split once
    (``torch.unbind``: its gradient is one stack of the G slices' grads,
    where G separate ``tree[g]`` would each scatter into a full-size
    zero tensor)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, G) for k, v in tree.items()}
        return [{k: per_key[k][g] for k in tree} for g in range(G)]
    return list(torch.unbind(tree, 0))


def _drop_group_dim(specs: Dict) -> Dict:
    return {k: _drop_group_dim(v) if isinstance(v, dict) else v[1:]
            for k, v in specs.items()}


def run_stack(blocks: Dict, x, cfg: ArchConfig, *, pos, cache=None,
              cache_index=None, ctx=None, remat=True,
              blocks_key="blocks", mesh=None, batch_axes=()):
    """Run the layer groups in order.  Returns (x, new_cache, aux_sum).

    On a mesh of several devices ``blocks`` are the rank's blocks: each
    group's are gathered over the DP axes (FSDP) just before it runs and
    dropped after it (their gradients summed over ``batch_axes``, the DP
    axes the batch is split on); ``batch_axes`` as ``_apply_block`` takes
    them.

    The cache is updated in place (the reference donates it), so
    ``new_cache`` is ``cache``.  ``remat`` is the reference's
    ``jax.checkpoint`` over each group: when autograd records the forward
    (no cache), each group runs under ``torch.utils.checkpoint`` and its
    activations are recomputed in the backward pass instead of kept; the
    values are the same either way."""
    pattern = (("enc",) if blocks_key == "enc_blocks"
               else layer_pattern(cfg))
    extras = _group_extras(cfg) if blocks_key == "blocks" else {}
    G = _first_leaf(blocks).shape[0]
    checkpointed = remat and cache is None and torch.is_grad_enabled()

    def group(x, gp, gc, g):
        if specs is not None:
            gp = part.gather_fsdp(gp, specs, mesh, batch_axes)
        aux = 0.0
        for j, kind in enumerate(pattern):
            slot = f"slot{j}"
            c_j = None if gc is None else gc.get(slot)
            ig = extras["is_global"][g][j] if extras else None
            x, _, a = _apply_block(
                x, gp[slot], kind, cfg, pos=pos, is_global=ig, cache=c_j,
                cache_index=cache_index, ctx=ctx, mesh=mesh,
                batch_axes=batch_axes)
            aux = aux + a
        return x, aux

    groups = _unbind(blocks, G)
    specs = None
    if part.sharded(mesh):
        specs = _drop_group_dim(part.param_specs(cfg, mesh)[blocks_key])
    aux = 0.0
    for g in range(G):
        gc = None if cache is None else _at(cache, g)
        gp = groups[g]
        if checkpointed:
            x, a = torch.utils.checkpoint.checkpoint(
                group, x, gp, gc, g, use_reentrant=False)
        else:
            x, a = group(x, gp, gc, g)
        del gp
        aux = aux + a
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=F32, device=x.device)
    return x, cache, aux
