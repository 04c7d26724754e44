"""The JAX package's side of the LM's sharded serving checks: its sharded
prefill and decode steps (``repro.train.steps.make_prefill_step`` /
``make_decode_step``, jitted on a mesh of Auto axes over host devices) on
the sharded golden's weights and inputs (``repro_torch.models.golden``
says what the golden holds).

``jax.make_mesh`` builds Explicit axes in this JAX version, which the
model's sharding constraints refuse (the JAX package's own sharded tests
fail for that reason alone); a mesh of Auto axes runs the same functions.
The host devices must exist before JAX starts, so this runs as its own
process:

    PYTHONPATH=src python tests/torch_lm_sharded_cases.py
        rewrites src/repro_torch/models/jax_lm_sharded_golden.json (the ten
        reduced configs on (2, 2), h2o-danube-1.8b also on (4, 2));
    PYTHONPATH=src python tests/torch_lm_sharded_cases.py --case ARCH \
        --mesh 4x2
        prints one case's JSON;
    PYTHONPATH=src python tests/torch_lm_sharded_cases.py --check
        prints, as JSON, what the golden holds beyond the (2, 2) cases:
        the h2o-danube-1.8b case on (4, 2), and ``psum_int8`` (no noise)
        in ``shard_map`` over a mesh of 4 host devices and
        ``pipeline_apply`` over a 'pipe' axis of 4 on
        ``golden.collective_inputs()`` (one process for the tests' whole
        JAX side).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

DEVICES = 8
os.environ.setdefault("XLA_FLAGS",
                      f"--xla_force_host_platform_device_count={DEVICES}")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import golden as G  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

# the sharded golden's inputs: the JAX package's own sharded test's batch,
# prompt and cache length (tests/test_distributed.py)
SETUP = dict(weights_seed=0, tokens_seed=1, ctx_seed=2, batch=4, seq=16,
             max_len=32, stride=8)
MESHES = {(2, 2): None, (4, 2): ("h2o-danube-1.8b",)}


def jax_tree(tree):
    """A port parameter tree as the JAX package's (bf16 through its bits)."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return jnp.asarray(bits.view(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return TM.tree_map(leaf, tree)


def auto_mesh(shape):
    n = int(np.prod(shape))
    names = ("pod", "data", "model")[-len(shape):]
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(
        shape), devices=jax.devices()[:n])


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def case(arch: str, shape) -> dict:
    """The JAX package's sharded prefill and decode logits on ``shape``
    (digests), and its sharded-against-one-device spread."""
    gold = SETUP
    cfg_t = TC.get_config(arch).reduced()
    cfg = JC.get_config(arch).reduced()
    tokens, ctx = G.sharded_inputs(cfg_t, gold)
    toks = jnp.asarray(tokens.numpy())
    ctx_j = (() if ctx is None else
             (jnp.asarray(ctx.view(torch.int16).numpy().view(np.uint16)
                          .view(ml_dtypes.bfloat16)),))
    params = jax_tree(TM.seeded_params(cfg_t, gold["weights_seed"], "cpu"))
    B, S, T = gold["batch"], gold["seq"], gold["max_len"]
    mesh = auto_mesh(shape)
    _, jit_p, sh = JS.make_prefill_step(cfg, mesh, T, B)
    _, jit_d, _ = JS.make_decode_step(cfg, mesh, T, B)
    prefill = jit_p(JS.make_batch_abstract(cfg, ShapeSpec("p", S, B,
                                                          "prefill")))
    decode = jit_d(JS.make_batch_abstract(cfg, ShapeSpec("d", T, B,
                                                         "decode")))
    p_sh = jax.device_put(params, sh["params"])
    cache = jax.device_put(JM.init_cache(cfg, B, T), sh["cache"])
    lp, cache = prefill(p_sh, toks[:, :S], cache, *ctx_j)
    ld, _ = decode(p_sh, toks[:, S:], cache, jnp.int32(S), *ctx_j)

    @jax.jit
    def one_device(p, t, c):
        x = c[0] if c else None
        cache1 = JM.init_cache(cfg, B, T)
        a, cache1 = JM.prefill(p, t[:, :S], cfg, cache=cache1, ctx=x)
        b, _ = JM.decode_step(p, t[:, S:], cfg, cache=cache1,
                              cache_index=S, ctx=x)
        return a, b
    op, od = one_device(params, toks, ctx_j)
    return dict(mesh=list(shape), prefill=G.digest_rows(lp, gold),
                decode=G.digest_rows(ld, gold),
                jax_spread=dict(prefill=rel(lp, op), decode=rel(ld, od)))


def key(arch: str, shape) -> str:
    return f"{arch} {tuple(shape)}"


def rewrite() -> dict:
    old = G.load()
    out = dict(SETUP, tolerance=old["tolerance"],
               prefill_decode_tol=old["prefill_decode_tol"], cases={})
    for shape, archs in MESHES.items():
        for arch in archs or sorted(TC.ARCHS):
            out["cases"][key(arch, shape)] = case(arch, shape)
            print(key(arch, shape), out["cases"][key(arch, shape)]
                  ["jax_spread"], flush=True)
    out["collectives"] = collectives()
    G.SHARDED_PATH.write_text(json.dumps(out, indent=1) + "\n")
    return out


def collectives() -> dict:
    """The JAX package's int8 psum and GPipe stages on 4 host devices."""
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.distributed.collectives import psum_int8
    from repro.distributed.pipeline import pipeline_apply
    data = G.collective_inputs()
    mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:4])
    psum = shard_map(lambda xl: psum_int8(xl[0], "data")[None], mesh=mesh,
                     in_specs=P("data"), out_specs=P("data"))(
                         jnp.asarray(data["x"]))
    pipe = jax.make_mesh((4,), ("pipe",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:4])
    staged = pipeline_apply(lambda w, xb: jnp.tanh(xb @ w),
                            jnp.asarray(data["pipe_x"]),
                            jnp.asarray(data["pipe_w"]), pipe, n_micro=4,
                            axis="pipe")
    return dict(psum=np.asarray(psum).tolist(),
                pipeline=np.asarray(staged).tolist())


def check() -> dict:
    return dict(collectives(), case=case("h2o-danube-1.8b", (4, 2)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    if args.check:
        json.dump(check(), sys.stdout)
        return
    if args.case is None:
        rewrite()
        return
    shape = tuple(int(x) for x in args.mesh.split("x"))
    json.dump(case(args.case, shape), sys.stdout)


if __name__ == "__main__":
    main()
