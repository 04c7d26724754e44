"""The JAX package's side of the LM's sharded training checks: its
gradient and train steps (``jax.value_and_grad(loss_fn)`` and
``repro.train.steps.make_train_step``, jitted on a mesh of Auto axes over
host devices) on the training golden's weights and batches
(``repro_torch.train.golden`` says what the sharded golden holds).

``jax.make_mesh`` builds Explicit axes in this JAX version, which the
model's sharding constraints refuse (the JAX package's own sharded tests
fail for that reason alone); a mesh of Auto axes runs the same functions.
The host devices must exist before JAX starts, so this runs as its own
process:

    PYTHONPATH=src python tests/torch_lm_sharded_train_cases.py
        rewrites src/repro_torch/train/jax_train_sharded_golden.json (the
        ten reduced configs on (2, 2); reduced qwen3-4b on (2, 2, 2), the
        JAX package's own sharded training test, five steps);
    PYTHONPATH=src python tests/torch_lm_sharded_train_cases.py \\
        --grads ARCH[,ARCH...] --out FILE.npz
        writes those configs' first sharded gradients on (2, 2)
        (``ARCH/dotted.path`` keys, f32; bf16 leaves exactly), for a
        config whose golden spread (``jax_spread``) passes its family's
        bound in some leaf also the one-device gradients
        (``ARCH/one/dotted.path``), and their golden entries
        (``ARCH/entry``, JSON), as the tests check the golden against
        them.

The tests compare the port's sharded gradient with the JAX package's
through the golden's ``leaves``: ||g_mesh - g_JAX|| <= ||g_mesh - g_one||
+ ||g_one - g_JAX||, the first term measured live, the second (the port
on one device against the JAX reference) recorded with the port's
one-device gradient's norm, which the test finds again.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
from typing import Dict

import numpy as np
import torch

from repro_torch import configs as TC
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.train import golden as G

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEVICES = 8

MESH = (2, 2)
# the JAX package's own sharded training test
# (tests/test_distributed.py::test_sharded_train_step_loss_decreases):
# reduced qwen3-4b on (2, 2, 2), batch 4, seq 32, five steps
ORACLE = dict(arch="qwen3-4b", mesh=[2, 2, 2], batch=4, seq=32, steps=5,
              weights_seed=0, stream_seed=0,
              adamw=dict(lr=1e-3, warmup_steps=2, total_steps=20))


def _jax():
    """The JAX package's modules and this directory's JAX helpers (a
    process with ``DEVICES`` host devices: ``main`` sets them up)."""
    import jax
    from repro import configs as JC
    from repro.configs.base import ShapeSpec
    from repro.data.tokens import TokenStream
    from repro.distributed import sharding as JSH
    from repro.models import model as JM
    from repro.train import optimizer as JO
    from repro.train import steps as JS
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_lm_sharded_cases import auto_mesh, jax_tree
    from torch_train_cases import jax_batch, port_flat
    return dict(jax=jax, JC=JC, ShapeSpec=ShapeSpec, TokenStream=TokenStream,
                JSH=JSH, JM=JM, JO=JO, JS=JS, auto_mesh=auto_mesh,
                jax_tree=jax_tree, jax_batch=jax_batch, port_flat=port_flat)


def sharded_grad(arch: str, gold, shape=MESH):
    """The first step's (loss, gradients) of the JAX package's sharded
    ``value_and_grad(loss_fn)`` on ``shape``, the gradients
    port-flattened."""
    J = _jax()
    jax, JC, JSH, JM = J["jax"], J["JC"], J["JSH"], J["JM"]
    auto_mesh, jax_tree = J["auto_mesh"], J["jax_tree"]
    jax_batch, port_flat = J["jax_batch"], J["port_flat"]
    cfg = JC.get_config(arch).reduced()
    mesh = auto_mesh(shape)
    p_sh = JSH.param_shardings(JM.abstract_params(cfg), mesh)
    params = jax.device_put(jax_tree(TM.seeded_params(
        TC.get_config(arch).reduced(), gold["weights_seed"], "cpu")), p_sh)
    batch = jax_batch(G.batches(cfg, gold)[0])
    b_sh = JSH.batch_specs(cfg, mesh, batch)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, cfg, mesh=mesh), has_aux=True),
        in_shardings=(p_sh, b_sh))
    (loss, _), grads = vg(params, jax.device_put(batch, b_sh))
    return float(loss), port_flat(grads)


def sharded_steps(arch: str, gold, shape=MESH):
    """``gold["steps"]`` steps of the JAX package's sharded
    ``make_train_step`` on ``shape``: each step's metrics."""
    J = _jax()
    jax, JC, JO, JS = J["jax"], J["JC"], J["JO"], J["JS"]
    ShapeSpec, TokenStream = J["ShapeSpec"], J["TokenStream"]
    auto_mesh, jax_tree, jax_batch = (J["auto_mesh"], J["jax_tree"],
                                      J["jax_batch"])
    cfg = JC.get_config(arch).reduced()
    mesh = auto_mesh(shape)
    adamw = JO.AdamWConfig(**gold["adamw"])
    _, jit_for, sh = JS.make_train_step(cfg, mesh, adamw)
    fn = jit_for(JS.make_batch_abstract(
        cfg, ShapeSpec("t", gold["seq"], gold["batch"], "train")))
    params = jax.device_put(jax_tree(TM.seeded_params(
        TC.get_config(arch).reduced(), gold["weights_seed"], "cpu")),
        sh["params"])
    state = jax.jit(JO.init_state, out_shardings=sh["opt"])(params)
    stream = TokenStream(cfg.vocab, gold["batch"], gold["seq"],
                         seed=gold["stream_seed"], n_ctx=cfg.n_ctx_tokens,
                         d_model=cfg.d_model)
    out = dict(loss=[], nll=[], aux=[], grad_norm=[], lr=[])
    for _ in range(gold["steps"]):
        params, state, m = fn(params, state, jax_batch(stream.next_batch()))
        for k in out:
            out[k].append(float(m[k]))
    return out


def one_device_grad(arch: str, gold):
    """The JAX package's one-device gradients of the same step."""
    J = _jax()
    jax, JC, JM = J["jax"], J["JC"], J["JM"]
    cfg = JC.get_config(arch).reduced()
    params = J["jax_tree"](TM.seeded_params(TC.get_config(arch).reduced(),
                                            gold["weights_seed"], "cpu"))
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, b, cfg),
                                    has_aux=True))
    (loss, _), grads = vg(params, J["jax_batch"](G.batches(cfg, gold)[0]))
    return float(loss), J["port_flat"](grads)


def entry(arch: str, gold) -> dict:
    """One reduced config's golden entry: the sharded steps' metrics, the
    first sharded gradient's leaf norms, the JAX package's own spread
    between its sharded and its one-device first gradient, and
    ``leaves``: each leaf's JAX reference (``ref``: the sharded gradient,
    or the one-device one where the spread passes the family's bound),
    its norm, and the port's one-device gradient's norm and distance from
    it (``check_leaf_against_jax``'s bound)."""
    run = sharded_steps(arch, gold)
    _, grads = sharded_grad(arch, gold)
    _, one = one_device_grad(arch, gold)
    run["leaf_grad_norms"] = G.leaf_norms(grads)
    spread = G.leaf_errors(grads, one)
    run["jax_spread"] = dict(grad_leaf_max=max(spread.values()),
                             leaf=spread)
    tol = G.load()["grad_tol"][TC.get_config(arch).family]
    port = port_one_device(arch)
    run["leaves"] = {}
    for k, g in grads.items():
        ref = "one" if spread[k] > tol else "sharded"
        want = one[k] if ref == "one" else g
        run["leaves"][k] = dict(
            ref=ref, ref_norm=G.leaf_norms({k: want})[k],
            port_one_norm=G.leaf_norms({k: port[k]})[k],
            port_one_err=G.leaf_errors({k: port[k]}, {k: want})[k])
    return run


def port_one_device(arch: str) -> Dict[str, torch.Tensor]:
    """The port's one-device first gradient of a reduced config on the
    golden's inputs (flattened, on the CPU)."""
    return G.train_run(TC.get_config(arch).reduced(), G.load(), "cpu",
                       steps=1)["grads"]


def rewrite() -> dict:
    train = G.load()
    old = G.load_sharded() if G.SHARDED_PATH.exists() else {}
    out = dict(mesh=list(MESH), **{k: train[k] for k in (
        "weights_seed", "stream_seed", "batch", "seq", "steps", "adamw")},
        tolerance=old.get("tolerance", dict(sharded_grad=1e-2,
                                            card_grad=3e-2, loss=1e-2)),
        reduced={})
    for arch in sorted(TC.ARCHS):
        out["reduced"][arch] = entry(arch, out)
        print(arch, out["reduced"][arch]["loss"],
              out["reduced"][arch]["jax_spread"], flush=True)
    oracle = dict(ORACLE)
    oracle.update(sharded_steps(ORACLE["arch"], ORACLE,
                                tuple(ORACLE["mesh"])))
    out["oracle"] = oracle
    print("oracle", oracle["loss"], flush=True)
    G.SHARDED_PATH.write_text(json.dumps(out, indent=1) + "\n")
    return out


def dump_grads(archs, path: str) -> None:
    gold = G.load_sharded()
    arrays = {}
    for arch in archs:
        loss, grads = sharded_grad(arch, gold)
        for k, v in grads.items():
            arrays[f"{arch}/{k}"] = v.float().numpy()
        if flipped(arch):
            for k, v in one_device_grad(arch, gold)[1].items():
                arrays[f"{arch}/one/{k}"] = v.float().numpy()
        arrays[f"{arch}/entry"] = np.array(json.dumps(dict(
            loss=loss, leaf_grad_norms=G.leaf_norms(grads))))
    np.savez(path, **arrays)


# --------------------------------------------------------------------------- #
# The tests' side (no JAX in this process)
# --------------------------------------------------------------------------- #
def start_jax_grads(archs, path) -> subprocess.Popen:
    """This script in a subprocess of ``DEVICES`` host devices, writing
    the JAX package's first sharded gradients of ``archs`` to ``path``
    (``dump_grads``) while the caller runs the port's side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DEVICES}",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--grads",
         ",".join(archs), "--out", str(path)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def flipped(arch: str) -> Dict[str, float]:
    """The leaves whose JAX sharded gradient departs from the JAX
    one-device one by more than the family's bound (the golden's
    ``jax_spread``): {leaf: spread}."""
    tol = G.load()["grad_tol"][TC.get_config(arch).family]
    spread = G.load_sharded()["reduced"][arch]["jax_spread"]["leaf"]
    return {k: v for k, v in spread.items() if v > tol}


def jax_grads(proc: subprocess.Popen, path, archs) -> Dict:
    """The subprocess's result: {arch: {grads: {dotted path: f32 tensor},
    one: {the same, one device; flipped configs only}, entry: {loss,
    leaf_grad_norms}}}."""
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    data = np.load(path)
    res = {a: dict(grads={}, one={}, entry=None) for a in archs}
    for key in data.files:
        arch, leaf = key.split("/", 1)
        if leaf == "entry":
            res[arch]["entry"] = json.loads(str(data[key]))
        elif leaf.startswith("one/"):
            res[arch]["one"][leaf[4:]] = torch.from_numpy(data[key])
        else:
            res[arch]["grads"][leaf] = torch.from_numpy(data[key])
    return res


def port_runs(archs, steps=None) -> Dict:
    """The port's ``golden.train_run`` of ``archs`` on a (2, 2) mesh of 4
    gloo ranks (``ranks``: each rank's) and on one device (``single``)."""
    ranks = TMESH.run_ranks(G.mesh_train_run, 4, tuple(archs), MESH,
                            ("data", "model"), "cpu", steps, timeout=600)
    gold = G.load()
    single = {a: G.train_run(TC.get_config(a).reduced(), gold, "cpu",
                             steps=steps) for a in archs}
    return dict(ranks=[r["runs"] for r in ranks], single=single,
                stats=[r["stats"] for r in ranks])


def live_jax(archs, tmp) -> Dict:
    """``jax_grads`` of ``archs`` from a subprocess run now."""
    path = pathlib.Path(tmp) / "jax_grads.npz"
    return jax_grads(start_jax_grads(archs, path), path, archs)


def leaf_ids(archs):
    """(arch, dotted leaf path) of every parameter of the reduced
    configs."""
    return [(a, k) for a in archs for k in
            TM.flatten(TM.abstract_params(TC.get_config(a).reduced()))]


def check_leaf_against_one_device(c: Dict, arch: str, leaf: str) -> float:
    """Rank 0's gathered gradient of the leaf: the parameter's dtype and
    shape, finite, every rank's equal, within the sharded golden's
    ``sharded_grad`` of one device's.  Returns the deviation."""
    got = c["ranks"][0][arch]["grads"][leaf]
    want = c["single"][arch]["grads"][leaf]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    for r in c["ranks"][1:]:
        assert torch.equal(r[arch]["grads"][leaf], got)
    err = G.leaf_errors({leaf: got}, {leaf: want})[leaf]
    assert err <= G.load_sharded()["tolerance"]["sharded_grad"], err
    return err


def check_leaf_against_jax(c: Dict, arch: str, leaf: str) -> float:
    """Rank 0's gathered gradient of the leaf within the training
    golden's family bound of the JAX package's sharded one; of its
    one-device one where those two differ by more than the bound (the
    MoE layer's experts, router and norm, where the JAX package's sharded
    gradient departs from its own one-device gradient by up to 19%).
    The distance is bounded through the port's one-device gradient
    (``entry``'s ``leaves``), which must be the one the golden recorded
    (its norm within 1e-6).  Returns the bound."""
    e = G.load_sharded()["reduced"][arch]["leaves"][leaf]
    got = c["ranks"][0][arch]["grads"][leaf].double()
    one = c["single"][arch]["grads"][leaf].double()
    n_one = float(torch.linalg.vector_norm(one))
    assert abs(n_one - e["port_one_norm"]) <= 1e-6 * max(
        e["port_one_norm"], 1e-30), (n_one, e["port_one_norm"])
    d = float(torch.linalg.vector_norm(got - one))
    ref = e["ref_norm"] or 1.0
    bound = (d + e["port_one_err"] * ref) / ref
    fam = TC.get_config(arch).family
    assert bound <= G.load()["grad_tol"][fam], (bound, e)
    return bound


def check_steps(c: Dict, arch: str) -> Dict:
    """``golden.sharded_train_deviations`` on the CPU's bound."""
    d, failed = G.sharded_train_deviations(
        arch, [r[arch] for r in c["ranks"]], c["single"][arch], G.load(),
        G.load_sharded(), G.load_sharded()["tolerance"]["sharded_grad"])
    assert not failed, failed
    return d


def check_golden(jax_run: Dict, arch: str) -> None:
    """The committed golden's first loss, leaf norms and ``leaves`` equal
    a live JAX run's (``jax_grads``) within 2**-20 relative (XLA's CPU
    code on another instruction set may round one differently), and its
    ``leaves`` hold for the port's one-device gradient now."""
    want = G.load_sharded()["reduced"][arch]
    got = jax_run["entry"]
    close = lambda a, b: abs(a - b) <= 2.0 ** -20 * max(abs(b), 1e-30)
    assert close(got["loss"], want["loss"][0])
    assert got["leaf_grad_norms"].keys() == want["leaf_grad_norms"].keys()
    for k, v in want["leaf_grad_norms"].items():
        assert close(got["leaf_grad_norms"][k], v), k
    port = port_one_device(arch)
    for k, e in want["leaves"].items():
        ref = jax_run["one"][k] if e["ref"] == "one" else jax_run["grads"][k]
        assert close(G.leaf_norms({k: ref})[k], e["ref_norm"]), k
        err = G.leaf_errors({k: port[k]}, {k: ref})[k]
        assert abs(err - e["port_one_err"]) <= 1e-6, (k, err, e)


def deviations(c: Dict, archs) -> Dict:
    """What the bounds hold, measured, one entry a config: the worst
    leaf against one device and against the JAX package's sharded
    gradient, and ``check_steps``'s."""
    out = {}
    for a in archs:
        one = G.leaf_errors(c["ranks"][0][a]["grads"], c["single"][a]["grads"])
        want = dict(c["jax"][a]["grads"])
        want.update({k: c["jax"][a]["one"][k] for k in flipped(a)})
        jx = G.leaf_errors({k: v.float() for k, v in
                            c["ranks"][0][a]["grads"].items()}, want)
        bound = {k: check_leaf_against_jax(c, a, k) for k in one}
        d, _ = G.sharded_train_deviations(
            a, [r[a] for r in c["ranks"]], c["single"][a], G.load(),
            G.load_sharded(), 1.0)
        out[a] = dict(leaf_one_device=max(one.values()),
                      leaf_jax=max(jx.values()),
                      leaf_jax_bound=max(bound.values()), **d)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grads")
    ap.add_argument("--out")
    ap.add_argument("--deviations", action="store_true",
                    help="print the port's measured deviations, one line "
                    "a config")
    args = ap.parse_args(argv)
    if args.deviations:
        with tempfile.TemporaryDirectory() as tmp:
            archs = sorted(TC.ARCHS)
            c = dict(port_runs(archs), jax=live_jax(archs, tmp))
            for a, d in deviations(c, archs).items():
                print(a, {k: round(v, 5) for k, v in d.items()}, flush=True)
        return
    if args.grads:
        dump_grads(args.grads.split(","), args.out)
        return
    rewrite()


if __name__ == "__main__":
    os.environ.setdefault(
        "XLA_FLAGS", f"--xla_force_host_platform_device_count={DEVICES}")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
