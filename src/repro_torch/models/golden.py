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
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

PATH = pathlib.Path(__file__).resolve().parent / "jax_lm_golden.json"


def load() -> Dict:
    return json.loads(PATH.read_text())


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
