"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full / sliding
window / bidirectional / cross / decode-with-cache), SwiGLU MLP.

Attention is an online-softmax loop over KV chunks (never the full (S, T)
score matrix), in the reference's order of operations: its chunk size,
its ``NEG_INF`` mask value and its f32 accumulation.

On a mesh (``part``) attention runs over this rank's heads: the q, k and
v projections are column-parallel (``column_parallel``: the input's
gradient summed over 'model') and ``wo`` row-parallel (its partial output
summed over 'model').  Where the heads do not divide over 'model'
(granite's single KV head, whose cache ``cache_spec`` splits on head_dim)
the projections are gathered whole, the cache keeps the rank's block and
is gathered to attend, and each of the rank's query heads attends to its
own KV head (GQA's grouping, head by head).  The SwiGLU MLP is column-
then row-parallel.

Dtypes follow the reference's: a product of two bf16 operands that the
reference asks for in f32 (``preferred_element_type=F32``) upcasts both
operands first (``einsum(..., f32=True)``), so it is never rounded to bf16;
every other product of bf16 operands is rounded to bf16 once, as the
reference's is.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import part

F32 = torch.float32
NEG_INF = -1e30


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
           f32: bool = False) -> torch.Tensor:
    """``jnp.einsum`` of two operands.  The operands are promoted to their
    common dtype as JAX promotes them (torch refuses mixed dtypes); with
    ``f32`` both are upcast to f32 first (the reference's
    ``preferred_element_type=F32``: bf16 -> f32 is exact, so the product
    is the same f32 product)."""
    if f32:
        a, b = a.to(F32), b.to(F32)
    else:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.einsum(eq, a, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    # statistics in f32; the inverse is cast to x's dtype and the product
    # evaluated left to right, as the reference rounds it
    var = torch.mean(torch.square(x.to(F32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D), pos: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32,
                                          device=x.device) / half))
    if pos.ndim == 1:
        ang = pos[None, :, None].to(F32) * freqs[None, None, :]
    else:
        ang = pos[..., None].to(F32) * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, mesh=None, d_ff: int = 0) -> torch.Tensor:
    """On a mesh, ``d_ff`` is the whole hidden width: a rank holding fewer
    rows of ``w_down`` has a partial output, summed over 'model'."""
    g, u = column_parallel(x, (w_gate, w_up), (d_ff, d_ff), mesh)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    if w_down.shape[0] < d_ff:
        return row_parallel(h, w_down, mesh)
    return einsum("bsf,fd->bsd", h, w_down)


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return einsum("bsd,dx->bsx", x, w)


def column_parallel(x: torch.Tensor, ws, widths, mesh,
                    prod=_product) -> list:
    """``[prod(x, w) for w in ws]`` (x @ w).  On a mesh a ``w`` holding
    fewer columns than its whole width (``widths``) is column-parallel:
    the rank computes its columns from the whole ``x``, whose gradient is
    then summed over 'model' (``part.column_products``, one sum for all
    of them)."""
    split = [part.sharded(mesh) and w.shape[-1] < n
             for w, n in zip(ws, widths)]
    out = [None if s else prod(x, w) for w, s in zip(ws, split)]
    if any(split):
        cols = iter(part.column_products(
            x, [w for w, s in zip(ws, split) if s], mesh, prod))
        out = [next(cols) if s else o for o, s in zip(out, split)]
    return out


def row_parallel(a: torch.Tensor, b: torch.Tensor, mesh) -> torch.Tensor:
    """``a @ b`` whose contracted dim lies over 'model' (b (K, N), or
    (G, K, N) against a (G, M, K)): the rank's partial sum in f32, summed
    over 'model' and rounded to the operands' dtype once, as one device
    rounds its single f32 accumulation."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    eq = "...k,kn->...n" if b.ndim == 2 else "gmk,gkn->gmn"
    return part.tp_sum(einsum(eq, a, b, f32=True), mesh, dtype)


class AttnSpec(NamedTuple):
    n_heads: int
    n_kv: int
    d_head: int
    causal: bool = True
    window: Optional[int] = None     # sliding-window size (None = full)
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    kv_chunk: int = 2048


def _pad_time(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 1 of (B, T, K, X) by n positions at the end."""
    return F.pad(t, (0, 0, 0, 0, 0, n)) if n else t


def mha_online(q: torch.Tensor, k, v, *, causal: bool,
               window: Optional[int], q_offset, valid_len,
               chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, S, H, D); k, v: (B, T, K, D) with H a multiple of K (GQA) — OR
    (values int8, scales) tuples for a quantized KV cache: each chunk is
    dequantized inside the loop.  q_offset: position of q[0] (decode: the
    cache index); valid_len: number of valid KV positions.  Masked scores
    are ``NEG_INF``, not -inf: until a chunk holds a valid key their
    probabilities are 1, and ``alpha`` wipes them out when one arrives, as
    in the reference.  Returns (B, S, H, D) in q.dtype; accumulation in
    f32.  The window may be a per-layer value (the hybrid stack's).
    """
    k, k_sc = k if isinstance(k, tuple) else (k, None)
    v, v_sc = v if isinstance(v, tuple) else (v, None)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    chunk = min(chunk, T)
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    k, v = _pad_time(k, pad), _pad_time(v, pad)
    if k_sc is not None:
        k_sc, v_sc = _pad_time(k_sc, pad), _pad_time(v_sc, pad)
    scale = 1.0 / math.sqrt(D)
    qg = (q.reshape(B, S, K, G, D).to(F32) * scale).to(q.dtype)
    dev = q.device
    q_pos = int(q_offset) + torch.arange(S, device=dev)
    c_pos = torch.arange(chunk, device=dev)

    m = torch.full((B, S, K, G), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, S, K, G), dtype=F32, device=dev)
    acc = torch.zeros((B, S, K, G, D), dtype=F32, device=dev)
    for c in range(n_chunks):
        t0 = c * chunk
        kb, vb = k[:, t0:t0 + chunk], v[:, t0:t0 + chunk]
        if k_sc is not None:           # dequantize the int8 chunk
            kb = (kb.to(F32) * k_sc[:, t0:t0 + chunk].to(F32)).to(q.dtype)
            vb = (vb.to(F32) * v_sc[:, t0:t0 + chunk].to(F32)).to(q.dtype)
        s = einsum("bskgd,btkd->bskgt", qg, kb, f32=True)
        k_pos = t0 + c_pos
        ok = k_pos[None, :] < valid_len
        if causal:
            ok = ok & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + einsum(
            "bskgt,btkd->bskgd", p.to(vb.dtype), vb, f32=True)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, D).to(q.dtype)


def update_slice(buf: torch.Tensor, val: torch.Tensor,
                 index) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, val, (0, index, 0, ...))`` written
    into ``buf`` in place (the reference donates the cache).  As in JAX, a
    negative start counts from the end, and the start is clamped so that
    the update fits."""
    n, start = val.shape[1], int(index)
    if start < 0:
        start += buf.shape[1]
    start = min(max(start, 0), buf.shape[1] - n)
    buf[:, start:start + n] = val.to(buf.dtype)
    return buf


def project_heads(x: torch.Tensor, w: torch.Tensor, n: int, D: int,
                  mesh=None, t=None) -> torch.Tensor:
    """``x @ w`` as (B, S, heads, D).  On a mesh: the rank's heads where
    ``w``'s columns lie over 'model' and ``n`` divides, else all ``n``
    (the columns gathered); ``t``, the product ``column_parallel`` made,
    if given."""
    if not part.sharded(mesh):
        return einsum("bsd,dhx->bshx", x, w.reshape(x.shape[-1], n, D))
    if t is None:
        t, = column_parallel(x, (w,), (n * D,), mesh)
    if t.shape[-1] < n * D and n % part.tp_size(mesh):
        t = part.tp_gather(t, -1, mesh)
    return t.reshape(*t.shape[:2], -1, D)


def project_out(out: torch.Tensor, wo: torch.Tensor, n: int, D: int,
                mesh=None) -> torch.Tensor:
    """(B, S, heads, D) @ wo.  On a mesh ``wo``'s rows over 'model' make
    it row-parallel: the rank's rows of the heads it computed (all of
    them, or its own), a partial sum over 'model'."""
    if not part.sharded(mesh):
        return einsum("bshx,hxd->bsd", out, wo.reshape(n, D, -1))
    o = out.reshape(*out.shape[:2], -1)
    rows = wo.shape[0]
    if rows == n * D:
        return einsum("bsx,xd->bsd", o, wo)
    return row_parallel(part.tp_block(o, -1, rows, mesh), wo, mesh)


def store_kv(buf: torch.Tensor, val: torch.Tensor, index,
             mesh=None) -> torch.Tensor:
    """Write ``val`` into the rank's cache block ``buf`` at ``index``:
    its head_dim block where the cache splits head_dim over 'model'."""
    if buf.shape[-1] < val.shape[-1]:
        val = part.tp_block(val, -1, buf.shape[-1], mesh)
    return update_slice(buf, val, index)


def whole_kv(buf: torch.Tensor, D: int, mesh=None) -> torch.Tensor:
    """The cache as attention reads it: a head_dim split gathered."""
    if buf.shape[-1] < D:
        return part.tp_gather(buf, -1, mesh)
    return buf


def _own_kv(q: torch.Tensor, kv, H: int, K: int, mesh):
    """The KV heads of the rank's query heads, where the rank computes its
    own query heads against all K KV heads (query head h attends to KV
    head h // (H / K)): the run of KV heads they use, when each of those
    serves as many of them (GQA's grouping kept), else one a query
    head."""
    Hl = q.shape[2]
    k0 = kv[0] if isinstance(kv, tuple) else kv
    if Hl == H or k0.shape[2] < K:
        return kv
    q0, G = part.tp_index(mesh) * Hl, H // K
    lo, hi = q0 // G, (q0 + Hl - 1) // G + 1
    if Hl % (hi - lo) == 0 and all(
            (q0 + j) // G - lo == j // (Hl // (hi - lo)) for j in range(Hl)):
        pick = lambda t: t[:, :, lo:hi]
    else:
        idx = torch.tensor([(q0 + j) // G for j in range(Hl)],
                           device=q.device)
        pick = lambda t: t[:, :, idx]
    return tuple(map(pick, kv)) if isinstance(kv, tuple) else pick(kv)


def attend(q, k, v, H: int, K: int, mesh=None, **kw) -> torch.Tensor:
    """``mha_online`` of the rank's query heads (``_own_kv``).  Where the
    rank computes its own query heads against all K KV heads, those
    enter a computation that differs by 'model' rank
    (``part.tp_copy``)."""
    if q.shape[2] < H:
        k, v = (part.tp_copy(t, mesh)
                if torch.is_tensor(t) and t.shape[2] == K else t
                for t in (k, v))
    return mha_online(q, _own_kv(q, k, H, K, mesh), _own_kv(q, v, H, K, mesh),
                      **kw)


def attention(x: torch.Tensor, p: dict, spec: AttnSpec, *,
              pos: torch.Tensor, cache: Optional[dict] = None,
              cache_index=None, ctx_kv: Optional[tuple] = None, mesh=None):
    """Self- or cross-attention with optional KV cache.

    x: (B, S, d).  p: {'wq','wk','wv','wo'[, 'q_norm','k_norm']}.
    pos: (S,) absolute positions of x.
    cache: {'k','v'} (B, T_max, K, D), or the int8 layout {'k', 'k_scale',
    'v', 'v_scale'}: updated in place and returned (on a mesh, the rank's
    blocks).
    ctx_kv: (k, v) precomputed cross-attention KV (overrides x-derived kv).
    """
    from repro_torch.models.part import constrain
    H, K, D = spec.n_heads, spec.n_kv, spec.d_head
    names, widths = ("wq", "wk", "wv"), (H * D, K * D, K * D)
    n = 1 if ctx_kv is not None else 3
    ts = (column_parallel(x, [p[k] for k in names[:n]], widths[:n], mesh)
          if part.sharded(mesh) else [None] * n)
    q = project_heads(x, p["wq"], H, D, mesh, ts[0])
    q = constrain(q, mesh, ("dp", None, "tp", None))
    if ctx_kv is None:
        k = project_heads(x, p["wk"], K, D, mesh, ts[1])
        v = project_heads(x, p["wv"], K, D, mesh, ts[2])
        k = constrain(k, mesh, ("dp", None, "tp", None))
        v = constrain(v, mesh, ("dp", None, "tp", None))
    else:
        k, v = ctx_kv
    if spec.qk_norm:
        # a norm over head_dim of the rank's own heads: its gradient is
        # summed over 'model'
        own = lambda t, n, w: part.tp_copy(w, mesh) if t.shape[2] < n else w
        q = rms_norm(q, own(q, H, p["q_norm"]))
        if ctx_kv is None:
            k = rms_norm(k, own(k, K, p["k_norm"]))
    if ctx_kv is None:
        q = apply_rope(q, pos, spec.rope_theta)
        k = apply_rope(k, pos, spec.rope_theta)

    S = x.shape[1]
    new_cache = cache
    grouped = dict(H=H, K=K, mesh=mesh, chunk=spec.kv_chunk)
    if ctx_kv is not None:
        # cross-attention: full-context bidirectional over ctx
        out = attend(q, k, v, causal=False, window=None, q_offset=0,
                     valid_len=k.shape[1], **grouped)
    elif cache is None:
        out = attend(q, k, v, causal=spec.causal, window=spec.window,
                     q_offset=0, valid_len=S, **grouped)
    elif "k_scale" in cache:
        # int8 KV cache: per-(token, head) block scales; dequantization
        # happens per chunk inside the online-softmax loop
        from repro_torch.distributed.collectives import quantize_kv_int8
        kq, ks = quantize_kv_int8(k)
        vq, vs = quantize_kv_int8(v)
        new_cache = dict(
            k=store_kv(cache["k"], kq, cache_index, mesh),
            k_scale=store_kv(cache["k_scale"], ks, cache_index, mesh),
            v=store_kv(cache["v"], vq, cache_index, mesh),
            v_scale=store_kv(cache["v_scale"], vs, cache_index, mesh))
        out = attend(q, (whole_kv(new_cache["k"], D, mesh),
                         new_cache["k_scale"]),
                     (whole_kv(new_cache["v"], D, mesh),
                      new_cache["v_scale"]),
                     causal=spec.causal, window=spec.window,
                     q_offset=cache_index, valid_len=cache_index + S,
                     **grouped)
    else:
        ck = store_kv(cache["k"], k, cache_index, mesh)
        cv = store_kv(cache["v"], v, cache_index, mesh)
        new_cache = dict(k=ck, v=cv)
        out = attend(q, whole_kv(ck, D, mesh).to(q.dtype),
                     whole_kv(cv, D, mesh).to(q.dtype),
                     causal=spec.causal, window=spec.window,
                     q_offset=cache_index, valid_len=cache_index + S,
                     **grouped)
    return project_out(out, p["wo"], H, D, mesh), new_cache
