"""The LM's golden from the JAX package, for hosts without JAX (the card's).

``jax_lm_golden.json`` holds, for the ten architectures of the registry:
the full configs' ``param_count`` and ``active_param_count``, and for each
reduced config the JAX package's forward logits at a few positions, for
``model.seeded_params(cfg, weights_seed)`` weights (numpy draws, the same
on every host) and the inputs of ``inputs``.  It also states the
tolerances that decide the port's float outputs:

- ``tolerance[family]``: max|port - JAX| over max|JAX| of the logits
  (bf16 weights make the JAX package's own bf16 forward differ from its
  f32 forward by 0.59-1.56 % of max|logit| outside MoE, 3.64-3.89 % with
  MoE routing; each bound sits 1.5-2.6x above its family's spread);
- ``nll_tol``: |port - JAX| of the loss's nll and aux;
- ``prefill_decode_tol``: prefill(S) + decode(1) against forward(S+1) at
  the last token, rtol = atol (the JAX package's own test's bound);
- ``int8_tol``: the int8 cache's decode logits against the forward's,
  max|diff| over max|forward| (the JAX package's own test's bound).

``tests/test_torch_lm_configs.py`` regenerates the file from the JAX
package and requires the counts, positions and shapes to be equal and
every logit to be equal or one bf16 unit in the last place away (the
logits are bf16 values; XLA's CPU code may round one differently on
another instruction set).

``jax_lm_sharded_golden.json`` holds the sharded serving path's oracle
(``load_sharded``): for each reduced config, the JAX package's prefill
and decode logits (``make_prefill_step`` / ``make_decode_step`` jitted on
a mesh of Auto axes over host devices: (2, 2) ('data', 'model') for every
config, and the JAX package's own test's (4, 2) for h2o-danube-1.8b) on
``seeded_params`` weights and the inputs of ``sharded_inputs``, as
digests (``digest_rows``), and the JAX package's own spread between its
sharded and its one-device logits; and its ``psum_int8`` in ``shard_map``
over 4 host devices and ``pipeline_apply`` over a 'pipe' axis of 4 on the
inputs of ``collective_inputs``.  ``tests/torch_lm_sharded_cases.py``
writes it.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PATH = pathlib.Path(__file__).resolve().parent / "jax_lm_golden.json"
SHARDED_PATH = PATH.with_name("jax_lm_sharded_golden.json")


def load() -> Dict:
    return json.loads(PATH.read_text())


def load_sharded() -> Dict:
    return json.loads(SHARDED_PATH.read_text())


def inputs(cfg, golden: Dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The golden's tokens (batch, seq) int32 and context stub (batch,
    n_ctx_tokens, d_model) f32 (None for an architecture without one)."""
    B, S = golden["batch"], golden["seq"]
    tokens = np.random.default_rng(golden["tokens_seed"]).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    ctx = None
    if cfg.n_ctx_tokens:
        ctx = np.random.default_rng(golden["ctx_seed"]).normal(
            0, 1, (B, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return tokens, ctx


def digest(logits, golden: Dict) -> Dict:
    """max|logits| and the rows at the golden's positions, every
    ``stride``-th vocabulary entry, of (batch, seq, vocab) logits."""
    x = np.asarray(logits.cpu() if torch.is_tensor(logits) else logits,
                   dtype=np.float32)
    st = golden["stride"]
    return dict(max_abs=float(np.abs(x).max()),
                rows=[[float(v) for v in x[b, s, ::st]]
                      for b, s in golden["positions"]])


def rel_err(got: Dict, want: Dict) -> float:
    """max|got - want| over the digest's rows, over want's max|logits|."""
    d = np.abs(np.asarray(got["rows"]) - np.asarray(want["rows"])).max()
    return float(d / want["max_abs"])


def outputs(params: Dict, cfg, tokens: torch.Tensor,
            ctx: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """What a card-against-CPU check compares, computed on the tokens'
    device: the forward's logits, the loss's nll and aux (labels: the
    tokens shifted by one), and the decode logits after a prefill of all
    but the last token, with a bf16 and with an int8 KV cache.  Returned
    as f32 on the CPU."""
    from repro_torch.models import model as M
    B, S = tokens.shape
    logits, _, _ = M.forward(params, tokens, cfg, ctx=ctx)
    batch = dict(tokens=tokens, labels=torch.roll(tokens, -1, 1))
    if ctx is not None:
        batch["ctx"] = ctx
    _, parts = M.loss_fn(params, batch, cfg)
    out = dict(logits=logits, nll=parts["nll"], aux=parts["aux"])
    for name, kv in (("decode", torch.bfloat16), ("decode_int8", torch.int8)):
        cache = M.init_cache(cfg, B, S + 7, kv, tokens.device)
        _, cache = M.prefill(params, tokens[:, :S - 1], cfg, cache=cache,
                             ctx=ctx)
        out[name], _ = M.decode_step(params, tokens[:, S - 1:], cfg,
                                     cache=cache, cache_index=S - 1, ctx=ctx)
    return {k: v.detach().float().cpu() for k, v in out.items()}


def deviations(got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """max|got - want| over max|want| of each logits output, |got - want|
    of nll and aux."""
    out = {}
    for k, w in want.items():
        d = float((got[k] - w).abs().max())
        out[k] = d if w.ndim == 0 else d / float(w.abs().max())
    return out


# --------------------------------------------------------------------------- #
# The sharded serving path
# --------------------------------------------------------------------------- #
def sharded_inputs(cfg, golden: Dict) -> Tuple[torch.Tensor,
                                                Optional[torch.Tensor]]:
    """The sharded golden's tokens (batch, seq + 1) int32 (a prompt of
    ``seq`` and one token to decode) and context stub (batch,
    n_ctx_tokens, d_model) bf16, or None."""
    B, S = golden["batch"], golden["seq"]
    tokens = np.random.default_rng(golden["tokens_seed"]).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    ctx = None
    if cfg.n_ctx_tokens:
        ctx = torch.from_numpy(np.random.default_rng(golden["ctx_seed"])
                               .normal(0, 1, (B, cfg.n_ctx_tokens,
                                              cfg.d_model))
                               .astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(tokens), ctx


def prefill_decode(params: Dict, cfg, tokens: torch.Tensor,
                   ctx: Optional[torch.Tensor], golden: Dict, mesh=None,
                   kv_dtype=torch.bfloat16):
    """The prefill's last-position logits over all but the last token and
    the decode step's on the last, with a ``kv_dtype`` cache (on a mesh:
    the rank's parameter blocks and cache, the whole inputs and logits)."""
    from repro_torch.models import model as M
    B, S = tokens.shape[0], tokens.shape[1] - 1
    cache = M.init_cache(cfg, B, golden["max_len"], kv_dtype, tokens.device,
                         mesh=mesh)
    prefill, cache = M.prefill(params, tokens[:, :S], cfg, cache=cache,
                               ctx=ctx, mesh=mesh)
    decode, _ = M.decode_step(params, tokens[:, S:], cfg, cache=cache,
                              cache_index=S, ctx=ctx, mesh=mesh)
    return prefill, decode


def serve_outputs(params: Dict, cfg, tokens: torch.Tensor,
                  ctx: Optional[torch.Tensor], golden: Dict,
                  mesh=None) -> Dict[str, np.ndarray]:
    """What the sharded checks compare, on the tokens' device: the prefill
    and decode logits (``prefill_decode``) with a bf16 and with an int8 KV
    cache, and the forward's at the last position, each (batch, vocab)
    f32 as numpy."""
    from repro_torch.models import model as M
    out = {}
    for name, kv in (("", torch.bfloat16), ("_int8", torch.int8)):
        out["prefill" + name], out["decode" + name] = prefill_decode(
            params, cfg, tokens, ctx, golden, mesh, kv)
    out["forward"] = M.forward(params, tokens, cfg, ctx=ctx,
                               mesh=mesh)[0][:, -1]
    return {k: v.detach().float().cpu().numpy() for k, v in out.items()}


def digest_rows(x, golden: Dict) -> Dict:
    """max|x| and every ``stride``-th vocabulary entry of each row of
    (batch, vocab) logits."""
    x = np.asarray(x, dtype=np.float32)
    return dict(max_abs=float(np.abs(x).max()),
                rows=x[:, ::golden["stride"]].tolist())


def collective_inputs() -> Dict[str, np.ndarray]:
    """The sharded golden's collective inputs: ``x`` (4, 1000) f32, one
    row a rank, for ``psum_int8``; ``pipe_w`` (4, 16, 16) and ``pipe_x``
    (8, 16) f32 for ``pipeline_apply`` with the stage ``tanh(x @ w)``."""
    rng = np.random.default_rng(0)
    return dict(x=(rng.standard_normal((4, 1000)) * 3).astype(np.float32),
                pipe_w=(rng.standard_normal((4, 16, 16)) * 0.3)
                .astype(np.float32),
                pipe_x=rng.standard_normal((8, 16)).astype(np.float32))


def serve_reduced(golden: Dict, device, mesh=None) -> Dict[str, Dict]:
    """``serve_outputs`` of every reduced config on ``seeded_params``
    weights and the sharded golden's inputs, on ``device`` (on a mesh: the
    rank's blocks)."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import model as M
    out = {}
    for arch in sorted(ARCHS):
        cfg = get_config(arch).reduced()
        tokens, ctx = sharded_inputs(cfg, golden)
        out[arch] = serve_outputs(
            M.seeded_params(cfg, golden["weights_seed"], device, mesh=mesh),
            cfg, tokens.to(device), None if ctx is None else ctx.to(device),
            golden, mesh)
    return out


def sharded_deviations(arch: str, ranks: List[Dict[str, np.ndarray]],
                       want: Dict[str, np.ndarray],
                       golden: Dict) -> Tuple[Dict[str, float], List[str]]:
    """Hold the ranks' ``serve_outputs`` of a reduced config against one
    device's (``want``) and the JAX package's sharded golden.  Returns the
    deviations of rank 0 (each key of ``want``, max|Δ| over max|want|;
    ``jax_prefill``/``jax_decode`` against the golden's digests) and what
    failed: a deviation over the family's bound, a rank whose outputs
    differ from rank 0's."""
    from repro_torch.configs import get_config
    tol = golden["tolerance"][get_config(arch).family]
    got = ranks[0]
    d = {k: float(np.abs(got[k] - v).max() / np.abs(v).max())
         for k, v in want.items()}
    case = golden["cases"][f"{arch} (2, 2)"]
    d.update({f"jax_{k}": rel_err(digest_rows(got[k], golden), case[k])
              for k in ("prefill", "decode")})
    failed = [f"{arch}-reduced {k} {v} (limit {tol})"
              for k, v in d.items() if not v <= tol]
    failed += [f"{arch}-reduced: rank {i}'s {k} differs from rank 0's"
               for i, r in enumerate(ranks[1:], 1) for k in got
               if not np.array_equal(r[k], got[k])]
    return d, failed


def psum_int8_host(rows: np.ndarray) -> np.ndarray:
    """``psum_int8`` of ``rows`` (one a rank) computed on the host, the
    algorithm step by step: each row quantized, requantized to the largest
    scale, summed in int32 and rescaled."""
    from repro_torch.distributed.collectives import quantize_int8
    x = torch.from_numpy(rows)
    qs = [quantize_int8(r) for r in x]
    smax = torch.stack([s for _, s, _ in qs]).amax(0)
    acc = sum(torch.clamp(torch.round(q.float() * (s / smax)), -127, 127)
              .to(torch.int8).to(torch.int32) for q, s, _ in qs)
    return (acc.float() * smax).reshape(-1)[:x.shape[1]].numpy()
