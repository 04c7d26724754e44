"""The JAX package's side of the LM training checks, shared by
``tests/test_torch_train_grads_*.py``: the reference's gradient and its
train steps on the golden's weights and batches
(``repro_torch.train.golden`` says what the golden holds), and the port's
on the same inputs.

Run as a script to rewrite ``src/repro_torch/train/jax_train_golden.json``
after a deliberate change of the JAX package (it also measures the JAX
package's own bf16-against-f32 spread, which sized the tolerances), or
with ``--deviations`` to print the port's measured deviations, one line
a config:

    PYTHONPATH=src python tests/torch_train_cases.py [--deviations]
"""
from __future__ import annotations

import functools
import json
import sys
from typing import Dict

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro import configs as JC
from repro.models import model as JM
from repro.train import optimizer as JO
from repro_torch import configs as TC
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import model as TM
from repro_torch.train import golden as G
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

ARCHS = sorted(TC.ARCHS)


def jax_tree(tree: Dict):
    """A port parameter tree as the JAX package's (bf16 through its bit
    pattern)."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return jnp.asarray(bits.view(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return TM.tree_map(leaf, tree)


def port_flat(jtree) -> Dict[str, torch.Tensor]:
    """A JAX tree of dicts as the port's flattened tree of tensors."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    out = {}
    for path, x in flat:
        a = np.asarray(x)
        key = ".".join(k.key for k in path)
        if a.dtype == ml_dtypes.bfloat16:
            out[key] = torch.from_numpy(a.view(np.uint16).view(np.int16)
                                        .copy()).view(torch.bfloat16)
        else:
            out[key] = torch.from_numpy(a.copy())
    return out


def adamw(gold: Dict, pkg=JO):
    return pkg.AdamWConfig(**gold["adamw"])


@functools.lru_cache(maxsize=None)
def jax_fns(arch: str):
    """The reference's jitted ``value_and_grad(loss_fn)`` and ``update``
    for a reduced config (each compiles once a process and input
    signature)."""
    cfg = JC.get_config(arch).reduced()
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, b, cfg),
                                    has_aux=True))
    upd = jax.jit(lambda p, g, s: JO.update(adamw(G.load()), p, g, s))
    return vg, upd


def jax_batch(b: Dict) -> Dict:
    """A stream batch as the reference's launcher passes it."""
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "ctx" else None)
            for k, v in b.items()}


def jax_run(arch: str, gold: Dict, f32: bool = False) -> Dict:
    """The reference's ``steps`` train steps (``value_and_grad`` then
    ``update``, each jitted): losses, grad norms and learning rates, the
    first step's gradients (port-flattened) and its leaf norms.  ``f32``:
    the same parameters in f32, the first step's gradients only."""
    cfg = JC.get_config(arch).reduced()
    params = jax_tree(TM.seeded_params(TC.get_config(arch).reduced(),
                                       gold["weights_seed"], "cpu"))
    if f32:
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                        params)
    vg, upd = jax_fns(arch)
    state = JO.init_state(params)
    out = dict(loss=[], nll=[], aux=[], grad_norm=[], lr=[])
    for i, b in enumerate(G.batches(cfg, gold)):
        (loss, parts), grads = vg(params, jax_batch(b))
        if i == 0:
            out["grads"] = port_flat(grads)
            out["leaf_grad_norms"] = G.leaf_norms(out["grads"])
            if f32:
                return out
        params, state, m = upd(params, grads, state)
        out["loss"].append(float(loss))
        out["nll"].append(float(parts["nll"]))
        out["aux"].append(float(parts["aux"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lr"].append(float(m["lr"]))
    return out


def port_run(arch: str, gold: Dict, device="cpu") -> Dict:
    """The port's first gradient (``model.value_and_grad``) and its train
    steps over the golden's batches, on ``device``: the first one the
    update from that gradient (what ``make_train_step`` computes with one
    microbatch), the others ``make_train_step``'s."""
    cfg = TC.get_config(arch).reduced()
    params = TM.seeded_params(cfg, gold["weights_seed"], device)
    bs = [TS.device_batch(b, device) for b in G.batches(cfg, gold)]
    _, jit_for, _ = TS.make_train_step(cfg, None, adamw(gold, TO))
    step = jit_for(TS.make_batch_abstract(
        cfg, ShapeSpec("t", gold["seq"], gold["batch"], "train")))
    state = TO.init_state(params)
    (loss, _), grads = TM.value_and_grad(params, bs[0], cfg)
    out = dict(grads=TM.flatten(grads), loss=[], grad_norm=[], lr=[])
    for i, b in enumerate(bs):
        if i == 0:          # the train step's first step, from its gradient
            params, state, m = TO.update(adamw(gold, TO), params, grads,
                                         state, donate=True)
            m = dict(m, loss=loss)
        else:
            params, state, m = step(params, state, b)
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
    out["params"], out["state"] = params, state
    return out


@functools.lru_cache(maxsize=None)
def case(arch: str) -> Dict:
    """One reduced config's reference and port runs on the golden's
    inputs, computed once a process (the reference's gradient and update
    compile once)."""
    gold = G.load()
    return dict(arch=arch, gold=gold, family=TC.get_config(arch).family,
                jax=jax_run(arch, gold), port=port_run(arch, gold))


def leaf_ids(archs):
    """(arch, leaf path) of every parameter of the reduced configs, from
    the parameter trees on the meta device."""
    return [(a, k) for a in archs for k in
            TM.flatten(TM.abstract_params(TC.get_config(a).reduced()))]


def check_leaf(c: Dict, leaf: str) -> None:
    """The leaf's gradient: the reference's shape and the parameter's
    dtype, finite, ||g_port - g_JAX|| / ||g_JAX|| within the family's
    bound."""
    gj, gp = c["jax"]["grads"][leaf], c["port"]["grads"][leaf]
    assert gp.shape == gj.shape and gp.dtype == gj.dtype
    assert torch.isfinite(gp.float()).all()
    err = G.leaf_errors({leaf: gp}, {leaf: gj})[leaf]
    assert err <= c["gold"]["grad_tol"][c["family"]], err


def check_norm_and_steps(c: Dict) -> None:
    """The global gradient norm within ``grad_norm_tol``; the port's
    ``make_train_step`` over the golden's batches: each step's loss
    within ``loss_tol`` of the reference's, its grad norm within
    ``grad_norm_tol``, its learning rate equal; and the same against the
    committed golden (what the card checks)."""
    j, p, gold = c["jax"], c["port"], c["gold"]
    assert set(p["grads"]) == set(j["grads"])
    nj, np_ = G.global_norm_f64(j["grads"]), G.global_norm_f64(p["grads"])
    assert abs(np_ - nj) / nj <= gold["grad_norm_tol"], (np_, nj)
    for want in (j, gold["reduced"][c["arch"]]):
        assert p["lr"] == want["lr"]
        for lp, lj in zip(p["loss"], want["loss"]):
            assert abs(lp - lj) <= gold["loss_tol"], (p["loss"], want["loss"])
        for np_, nj in zip(p["grad_norm"], want["grad_norm"]):
            assert abs(np_ - nj) / nj <= gold["grad_norm_tol"], (np_, nj)
    norms = G.leaf_norms(p["grads"])
    tol = gold["grad_tol"][c["family"]]
    for k, w in gold["reduced"][c["arch"]]["leaf_grad_norms"].items():
        assert abs(norms[k] - w) <= tol * w + 1e-30, (k, norms[k], w)


def check_golden(c: Dict) -> None:
    """The committed golden entry equals the fresh reference run: floats
    within 2**-20 relative (XLA's CPU code on another instruction set may
    round one differently), the learning rates exactly."""
    want = c["gold"]["reduced"][c["arch"]]
    got = json.loads(json.dumps(golden_entry(c["jax"])))
    assert got["lr"] == want["lr"]
    assert sorted(got["leaf_grad_norms"]) == sorted(want["leaf_grad_norms"])
    close = lambda a, b: abs(a - b) <= 2.0 ** -20 * max(abs(b), 1e-30)
    for k in ("loss", "nll", "aux", "grad_norm"):
        assert all(close(a, b) for a, b in zip(got[k], want[k])), k
    for k, v in want["leaf_grad_norms"].items():
        assert close(got["leaf_grad_norms"][k], v), k


def golden_entry(run: Dict) -> Dict:
    return {k: run[k] for k in ("loss", "nll", "aux", "grad_norm", "lr",
                                "leaf_grad_norms")}


def spread(arch: str, gold: Dict, bf16_run: Dict) -> Dict:
    """The JAX package's own bf16-against-f32 spread of the golden's
    measures: the worst leaf's relative gradient difference and the
    global norm's."""
    f32 = jax_run(arch, gold, f32=True)["grads"]
    errs = G.leaf_errors(bf16_run["grads"], f32)
    gn = G.global_norm_f64(f32)
    return dict(grad_leaf_max=max(errs.values()),
                grad_norm=abs(G.global_norm_f64(bf16_run["grads"]) - gn) / gn)


def deviations(arch: str) -> Dict:
    """What the bounds hold, measured: the worst leaf's gradient error,
    the global norm's, the largest loss difference over the steps, and the
    port's ``global_norm`` of the reference's own first gradients against
    the reference's norm of them (f32 units)."""
    c = case(arch)
    j, p = c["jax"], c["port"]
    errs = G.leaf_errors(p["grads"], j["grads"])
    nj = G.global_norm_f64(j["grads"])
    norm = TO.global_norm(TM.unflatten(j["grads"]))
    units = abs(int(np.float32(float(norm)).view(np.int32))
                - int(np.float32(j["grad_norm"][0]).view(np.int32)))
    return dict(leaf=max(errs.values()),
                norm=abs(G.global_norm_f64(p["grads"]) - nj) / nj,
                loss=max(abs(a - b) for a, b in zip(p["loss"], j["loss"])),
                optimizer_norm_units=units)


if __name__ == "__main__" and "--deviations" in sys.argv:
    # the measured deviations the tests bound, one line a config
    for a in ARCHS:
        d = deviations(a)
        print(f"{a:28s} {TC.get_config(a).family:7s} leaf {d['leaf']:.4f} "
              f"norm {d['norm']:.2e} loss {d['loss']:.2e} optimizer's norm "
              f"{d['optimizer_norm_units']} f32 units", flush=True)
elif __name__ == "__main__":
    settings = dict(
        weights_seed=0, stream_seed=0, batch=2, seq=16, steps=3,
        adamw=dict(lr=1e-3, warmup_steps=2, total_steps=3),
        grad_tol=dict(dense=3e-2, vlm=3e-2, audio=3e-2, hybrid=4e-2,
                      ssm=4e-2, moe=6e-2),
        grad_norm_tol=1e-2, loss_tol=1e-2)
    reduced, spreads = {}, {}
    for a in ARCHS:
        run = jax_run(a, settings)
        reduced[a] = golden_entry(run)
        spreads[a] = spread(a, settings, run)
        print(a, spreads[a], file=sys.stderr, flush=True)
    G.PATH.write_text(json.dumps(dict(settings, spread=spreads,
                                      reduced=reduced), indent=1) + "\n")
    print(f"wrote {G.PATH}", file=sys.stderr)
