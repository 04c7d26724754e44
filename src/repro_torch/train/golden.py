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

``jax_train_sharded_golden.json`` (``load_sharded``) holds the sharded
train step's oracle: for each reduced config, the JAX package's
``make_train_step`` jitted on a (2, 2) ('data', 'model') mesh of Auto
axes over host devices, on the same weights, batches and settings: each
step's ``loss``, ``nll``, ``aux``, ``grad_norm`` and ``lr``, the first
sharded gradient's ``leaf_grad_norms``, and the JAX package's own spread
between that gradient and its one-device one (``jax_spread``); and
``oracle``, the JAX package's own sharded training test (reduced
qwen3-4b on (2, 2, 2), batch 4, seq 32, five steps; weights from
``seeded_params``, the port's and the reference's alike).  Its
``tolerance``: ``sharded_grad``, per leaf ||g_mesh - g_one|| / ||g_one||
of the port's gathered sharded gradient against the port's one-device
one on the CPU; ``card_grad``, the same on the card (full width, 2
layers); ``loss``, each step's loss against the one device and the JAX
package's sharded run.  ``tests/torch_lm_sharded_train_cases.py`` writes
it.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List

import numpy as np
import torch

from repro_torch.data.tokens import TokenStream

PATH = pathlib.Path(__file__).resolve().parent / "jax_train_golden.json"
SHARDED_PATH = PATH.with_name("jax_train_sharded_golden.json")


def load() -> Dict:
    return json.loads(PATH.read_text())


def load_sharded() -> Dict:
    return json.loads(SHARDED_PATH.read_text())


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


def train_run(cfg, gold: Dict, device, mesh=None, params=None,
              steps=None, gather: bool = True) -> Dict:
    """The port's train steps of ``cfg`` from ``params`` (default
    ``seeded_params(cfg, weights_seed)``) over the golden's batches
    (``steps`` of them, default the golden's), on ``device``: each step's
    loss, grad norm and learning rate, and the first step's gradients
    (``value_and_grad``; the first step is the update from them, the
    others ``make_train_step``'s), on the CPU.  On a mesh of several
    devices ``params`` are the rank's blocks and the gradients come back
    gathered whole (with ``gather`` False, the rank's blocks)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.models import model as M
    from repro_torch.models import part
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps as S
    if params is None:
        params = M.seeded_params(cfg, gold["weights_seed"], device, mesh)
    adamw = O.AdamWConfig(**gold["adamw"])
    _, jit_for, sh = S.make_train_step(cfg, mesh, adamw)
    step = jit_for(S.make_batch_abstract(
        cfg, ShapeSpec("t", gold["seq"], gold["batch"], "train")))
    bs = [S.device_batch(b, device) for b in batches(cfg, gold)]
    bs = bs[:steps or gold["steps"]]
    shardings = sh["params"] if part.sharded(mesh) else None
    state = O.init_state(params)
    (loss, _), grads = M.value_and_grad(params, bs[0], cfg, mesh=mesh)
    params, state, m = O.update(adamw, params, grads, state, donate=True,
                                shardings=shardings)
    if shardings is not None and gather:
        grads = gather_tree(grads, shardings)
    out = dict(grads={k: v.cpu() for k, v in M.flatten(grads).items()},
               loss=[float(loss)], grad_norm=[float(m["grad_norm"])],
               lr=[float(m["lr"])])
    for b in bs[1:]:
        params, state, m = step(params, state, b)
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
    return out


def sharded_train_deviations(arch: str, ranks: List[Dict], single: Dict,
                             gold: Dict, sharded: Dict, grad_tol: float
                             ) -> Tuple[Dict[str, float], List[str]]:
    """Hold the ranks' ``train_run`` of a reduced config against one
    device's (``single``) and the JAX package's sharded golden entry
    (``sharded["reduced"][arch]``; ``gold``, the training golden, gives
    the family bounds).  Returns rank 0's deviations (``grads``: the worst
    leaf's ||Δg|| / ||g|| against one device; ``loss``: the largest loss
    difference over the steps against one device, ``jax_loss`` against
    the golden; ``jax_leaf_norm``: the worst leaf norm's relative
    difference from the golden's) and what failed: a deviation over its
    bound (``grad_tol``, the sharded golden's ``loss``, the family's
    ``grad_tol`` for the leaf norms), another learning rate, a rank whose
    outputs differ from rank 0's."""
    from repro_torch.configs import get_config
    fam = get_config(arch).family
    want = sharded["reduced"][arch]
    got = ranks[0]
    norms = leaf_norms(got["grads"])
    d = dict(
        grads=max(leaf_errors(got["grads"], single["grads"]).values()),
        loss=max(abs(a - b) for a, b in zip(got["loss"], single["loss"])),
        jax_loss=max(abs(a - b) for a, b in zip(got["loss"], want["loss"])),
        jax_leaf_norm=max(abs(norms[k] - w) / w for k, w in
                          want["leaf_grad_norms"].items() if w))
    bounds = dict(grads=grad_tol, loss=sharded["tolerance"]["loss"],
                  jax_loss=sharded["tolerance"]["loss"],
                  jax_leaf_norm=gold["grad_tol"][fam])
    failed = [f"{arch}-reduced {k} {v} (limit {bounds[k]})"
              for k, v in d.items() if not v <= bounds[k]]
    if got["lr"] != want["lr"] or got["lr"] != single["lr"]:
        failed.append(f"{arch}-reduced lr {got['lr']} (one device "
                      f"{single['lr']}, golden {want['lr']})")
    for i, r in enumerate(ranks[1:], 1):
        if r["loss"] != got["loss"] or any(
                not torch.equal(r["grads"][k], v)
                for k, v in got["grads"].items()):
            failed.append(f"{arch}-reduced: rank {i}'s outputs differ from "
                          "rank 0's")
    return d, failed


def mesh_train_run(archs, shape, axes, device="cpu", steps=None) -> Dict:
    """One rank of a mesh of ``shape`` over ``axes`` (spawned by
    ``launch.mesh.run_ranks``): ``train_run`` of each reduced config of
    ``archs`` on the training golden's inputs, the rank's blocks, on
    ``device`` ("cpu" or "cuda": the card of the rank), with the rank's
    ``Mesh.stats`` and hand-written kernel launches."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    if device == "cpu":
        torch.set_num_threads(1)          # tiny products; the host is shared
    else:
        exact_matmuls()
    mesh = make_mesh(shape, axes, device=device)
    gold = load()
    K.reset_launches()
    out = {a: train_run(get_config(a).reduced(), gold, mesh.device, mesh,
                        steps=steps) for a in archs}
    return dict(rank=mesh.rank, runs=out, stats=dict(mesh.stats),
                launches=dict(K.LAUNCHES))


def exact_matmuls() -> None:
    """f32 products and f32 reductions in cuBLAS (no TF32, no bf16
    split-K reduction), as the LM's launchers set them on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
