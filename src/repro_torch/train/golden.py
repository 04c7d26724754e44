"""The LM training golden from the JAX package, for hosts without JAX (the
card's).

``jax_train_golden.json`` holds, for each reduced config of the registry,
what the JAX package's train step computes from
``model.seeded_params(cfg, weights_seed)`` weights (numpy draws, the same
on every host) on the first ``steps`` batches of ``TokenStream(vocab,
batch, seq, seed=stream_seed)``, with ``adamw``'s settings (the launcher's
schedule for ``steps`` steps: warmup, then the decay to its floor): each
step's ``loss``, ``grad_norm`` and ``lr``, and the first step's gradient
norm of every parameter (``leaf_grad_norms``, keyed by the port's dotted
paths).  The reference computes a step as its ``make_train_step`` does
with one microbatch: ``jax.value_and_grad(loss_fn)``, then
``optimizer.update``, each under ``jax.jit``.

It also states the tolerances that decide the port's training outputs,
and the JAX package's own bf16-against-f32 spread each was sized from
(``spread[arch]``: the same measures between the JAX package's gradients
with bf16 parameters and with the same parameters in f32):

- ``grad_tol[family]``: per leaf, ||g_port - g_JAX|| / ||g_JAX||;
- ``grad_norm_tol``: the global gradient norm, relative;
- ``loss_tol``: |loss_port - loss_JAX| over the steps.

``tests/test_torch_train_grads_*.py`` regenerate each config's entry
from the JAX package and require it equal to the file (floats within
2**-20 relative, ``lr`` exactly).
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List

import numpy as np
import torch

from repro_torch.data.tokens import TokenStream

PATH = pathlib.Path(__file__).resolve().parent / "jax_train_golden.json"


def load() -> Dict:
    return json.loads(PATH.read_text())


def batches(cfg, gold: Dict) -> List[Dict[str, np.ndarray]]:
    """The golden's batches: the first ``steps`` of the token stream."""
    stream = TokenStream(cfg.vocab, gold["batch"], gold["seq"],
                         seed=gold["stream_seed"], n_ctx=cfg.n_ctx_tokens,
                         d_model=cfg.d_model)
    return [stream.next_batch() for _ in range(gold["steps"])]


def leaf_norms(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{dotted path: ||g||} (f64) of a flattened gradient tree."""
    return {k: float(torch.linalg.vector_norm(v.double().cpu()))
            for k, v in grads.items()}


def leaf_errors(got: Dict[str, torch.Tensor],
                want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{path: ||got - want|| / ||want||} of two flattened gradient trees
    (f64; a leaf whose reference gradient is 0 compares ||got||)."""
    out = {}
    for k, w in want.items():
        w = w.double().cpu()
        d = float(torch.linalg.vector_norm(got[k].double().cpu() - w))
        n = float(torch.linalg.vector_norm(w))
        out[k] = d / n if n else d
    return out


def global_norm_f64(grads: Dict[str, torch.Tensor]) -> float:
    return float(np.sqrt(sum(float(torch.sum(v.double().cpu() ** 2))
                             for v in grads.values())))


def step_outputs(params: Dict, batch: Dict, cfg, adamw) -> Dict:
    """One train step from ``params`` on the batch's device, what a
    card-against-CPU check compares (CPU tensors, flattened trees): the
    loss, the gradients, the clipped step's grad norm and learning rate,
    and the updated parameters and moments (from a fresh state)."""
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    (loss, _), grads = M.value_and_grad(params, batch, cfg)
    new_p, state, m = O.update(adamw, params, grads, O.init_state(params))
    cpu = lambda tree: {k: v.detach().cpu() for k, v in
                        M.flatten(tree).items()}
    return dict(loss=float(loss), grads=cpu(grads),
                grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                params=cpu(new_p), m=cpu(state.m), v=cpu(state.v))


def step_deviations(got: Dict, want: Dict, family: str,
                    gold: Dict) -> Dict[str, float]:
    """``step_outputs`` of two devices against each other, each measure
    over its bound (<= 1 passes): |Δloss| / ``loss_tol``; the worst leaf's
    gradient and first moment (the clipped gradient's tenth) against
    ``grad_tol[family]`` and second moment against twice it; the grad
    norm against ``grad_norm_tol``; the parameters' worst |Δp| against
    2 lr (a first Adam step moves each parameter by lr times the sign of
    its gradient, up to rounding, and a tiny gradient's sign can differ
    between the devices), with 2**-10 of it for the quotient's rounding,
    plus each side's bf16 rounding (half a unit: 2**-8 of |p|).  The
    learning rates must be equal."""
    tol = gold["grad_tol"][family]
    worst = lambda a, b: max(leaf_errors(a, b).values())
    def p_ratio(g, w):
        g, w = g.double(), w.double()
        bound = 2 * want["lr"] * (1 + 2.0 ** -10) + 2.0 ** -8 * (
            g.abs() + w.abs())
        return float(((g - w).abs() / bound).max())
    p_err = max(p_ratio(got["params"][k], w)
                for k, w in want["params"].items())
    return dict(
        loss=abs(got["loss"] - want["loss"]) / gold["loss_tol"],
        grads=worst(got["grads"], want["grads"]) / tol,
        grad_norm=abs(got["grad_norm"] - want["grad_norm"])
        / want["grad_norm"] / gold["grad_norm_tol"],
        m=worst(got["m"], want["m"]) / tol,
        v=worst(got["v"], want["v"]) / (2 * tol),
        params=p_err,
        lr=0.0 if got["lr"] == want["lr"] else float("inf"))
