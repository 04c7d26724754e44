"""The LM's sharded train step beyond the gradient, on gloo ranks (CPU),
reduced qwen3-4b:

- ``optimizer.update`` on a (2, 2) mesh's blocks (ZeRO-3), given the
  one-device gradients' blocks, against the one-device update: with
  clipping inactive every parameter, both moments, the step and the
  learning rate bit for bit; with it active the norm within 1e-5 and
  the rest as the one-device optimizer's own rule (moments within 1e-5,
  parameters within one unit);
- the global norm over blocks with a dominant replicated leaf (counted
  once, not once a rank);
- ``make_train_step(microbatches=2)`` on the mesh against one device;
- the train step's shardings against ``jax.jit(make_train_step)``'s
  in/out specs on a JAX ``AbstractMesh`` (exact);
- a sharded save of (params, opt_state) sha256-equal to the one-device
  save, restored onto the mesh and onto one device, read by the JAX
  package's ``ckpt.restore``; and a JAX save restored onto the mesh;
- one train step's collective calls and bytes by kind on each rank
  (``Mesh.stats``) against the counting mesh's count of the same step for
  that rank on the meta device (``analysis.count``): exact;
- the JAX package's own sharded training test on the port: (2, 2, 2),
  batch 4, seq 32, five steps; the loss falls, each step within 1e-2 of
  the JAX package's run (``jax_train_sharded_golden.json``'s ``oracle``)
  and of the port on one device.

The spawned ranks import this module: no JAX at its top.
"""
import hashlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.analysis import count as COUNT  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import golden as G  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARCH = "qwen3-4b"
AXES = ("data", "model")
# grad_clip far above the norm (inactive) and far below it (active)
CLIPS = dict(inactive=1e9, active=1e-3)
# the final norm's gradient scaled up so that it dominates the norm
DOMINANT = 1e4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return TC.get_config(ARCH).reduced()


def _adamw(gold, clip=None):
    kw = dict(gold["adamw"])
    if clip is not None:
        kw["grad_clip"] = clip
    return TO.AdamWConfig(**kw)


def _cpu(tree):
    return {k: v.detach().cpu().clone() for k, v in TM.flatten(tree).items()}


def _blocks(flat, shardings):
    spec = {k: s.spec for k, s in TM.flatten(shardings).items()}
    mesh = next(iter(TM.flatten(shardings).values())).mesh
    return TM.unflatten({k: SH.block(v, spec[k], mesh).clone()
                         for k, v in flat.items()})


def _microbatch_batch(cfg):
    stream = TokenStream(cfg.vocab, 4, 16, seed=3)
    return TS.device_batch(stream.next_batch(), "cpu")


def _rank(job) -> dict:
    """One rank of the (2, 2) mesh: the update on blocks from the
    one-device gradients, the dominant norm, a microbatched step, a
    sharded save and its restore, a JAX save's restore."""
    torch.set_num_threads(1)
    mesh = MESH.make_mesh((2, 2), AXES, device="cpu")
    cfg, gold = _cfg(), G.load()
    _, _, sh = TS.make_train_step(cfg, mesh, _adamw(gold))
    params = TM.seeded_params(cfg, gold["weights_seed"], "cpu", mesh)
    grads = _blocks(job["grads"], sh["params"])
    out = dict(rank=mesh.rank)
    for name, clip in CLIPS.items():
        p = TM.tree_map(torch.clone, params)
        new_p, st, m = TO.update(_adamw(gold, clip), p, grads,
                                 TO.init_state(p), donate=True,
                                 shardings=sh["params"])
        out[name] = dict(
            params=_cpu(SH.gather_tree(new_p, sh["params"])),
            m=_cpu(SH.gather_tree(st.m, sh["params"])),
            v=_cpu(SH.gather_tree(st.v, sh["params"])),
            step=int(st.step), lr=float(m["lr"]),
            grad_norm=float(m["grad_norm"]))
        if name == "inactive":
            CK.save(job["ckpt"] / "sharded", 1, (new_p, st),
                    data_state=dict(step=1), shardings=(sh["params"],
                                                        sh["opt"]))
            saved = (_cpu(new_p), _cpu(st.m))
    dominant = dict(job["grads"])
    dominant["final_norm"] = dominant["final_norm"] * DOMINANT
    out["dominant_norm"] = float(TO.global_norm(
        _blocks(dominant, sh["params"]), sh["params"]))
    # the sharded save restored onto this mesh: the rank's blocks again
    abstract = (TM.abstract_params(cfg),
                TO.abstract_state(TM.abstract_params(cfg)))
    (rp, rs), step, ds, _ = CK.restore(job["ckpt"] / "sharded", abstract,
                                       device="cpu",
                                       shardings=(sh["params"], sh["opt"]))
    out["restore_bad"] = [k for k, v in _cpu(rp).items()
                          if not torch.equal(v, saved[0][k])]
    out["restore_bad"] += [k for k, v in _cpu(rs.m).items()
                           if not torch.equal(v, saved[1][k])]
    out["restore_step"] = (step, int(rs.step), ds)
    # the JAX package's save of the one-device update, onto this mesh
    (jp, js), _, _, _ = CK.restore(job["ckpt"] / "jax", abstract,
                                   device="cpu",
                                   shardings=(sh["params"], sh["opt"]))
    want = _blocks(job["single_params"], sh["params"])
    out["jax_restore_bad"] = [
        k for k, v in _cpu(jp).items()
        if not torch.equal(v, _cpu(want)[k])]
    # one train step's collectives, and the counting mesh's count of the
    # same step for this rank on the meta device
    batch = TS.device_batch(G.batches(cfg, gold)[0], "cpu")
    step, _, _ = TS.make_train_step(cfg, mesh, _adamw(gold))
    p = TM.tree_map(torch.clone, params)
    mesh.stats.clear()
    step(p, TO.init_state(p), batch)
    counted = COUNT.CountingMesh((2, 2), AXES, rank=mesh.rank)
    B, S = batch["tokens"].shape
    COUNT.count_step(cfg, ShapeSpec("t", S, B, "train"), counted,
                     with_bytes=False)
    out["collectives"] = (COUNT.calls_and_bytes(mesh.stats),
                          COUNT.calls_and_bytes(counted.stats))
    # microbatches 2 on the mesh
    step_mb, _, _ = TS.make_train_step(cfg, mesh, _adamw(gold), donate=False,
                                       microbatches=2)
    p_mb, _, m = step_mb(params, TO.init_state(params),
                         _microbatch_batch(cfg))
    out["microbatch"] = dict(loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]),
                             params=_cpu(SH.gather_tree(p_mb, sh["params"])))
    return out


def _oracle_rank() -> list:
    """One rank of the (2, 2, 2) mesh: the JAX package's own sharded
    training test's five steps on the port."""
    torch.set_num_threads(1)
    mesh = MESH.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    return _oracle_steps(mesh)


def _oracle_steps(mesh) -> list:
    o = G.load_sharded()["oracle"]
    cfg = TC.get_config(o["arch"]).reduced()
    step, jit_for, _ = TS.make_train_step(cfg, mesh,
                                          TO.AdamWConfig(**o["adamw"]))
    fn = jit_for(TS.make_batch_abstract(
        cfg, ShapeSpec("t", o["seq"], o["batch"], "train")))
    params = TM.seeded_params(cfg, o["weights_seed"], "cpu", mesh)
    state = TO.init_state(params)
    stream = TokenStream(cfg.vocab, o["batch"], o["seq"],
                         seed=o["stream_seed"])
    losses = []
    for _ in range(o["steps"]):
        params, state, m = fn(params, state,
                              TS.device_batch(stream.next_batch(), "cpu"))
        losses.append(float(m["loss"]))
    return losses


def _jax_save(path, params, state) -> None:
    """The JAX package's save of the port's one-device trees."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro.train import checkpoint as JCK
    from repro.train import optimizer as JO

    def leaf(t):
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return jnp.asarray(bits.view(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    JCK.save(path, 1, (TM.tree_map(leaf, params), JO.AdamWState(
        step=jnp.asarray(state.step.numpy()),
        m=TM.tree_map(leaf, state.m), v=TM.tree_map(leaf, state.v))),
        data_state=dict(step=1))


@pytest.fixture(scope="module")
def single():
    """The port on one device: the first gradient, the updates from it,
    the dominant norm, the microbatched step."""
    cfg, gold = _cfg(), G.load()
    params = TM.seeded_params(cfg, gold["weights_seed"], "cpu")
    batch = TS.device_batch(G.batches(cfg, gold)[0], "cpu")
    _, grads = TM.value_and_grad(params, batch, cfg)
    out = dict(grads=_cpu(grads))
    for name, clip in CLIPS.items():
        p = TM.tree_map(torch.clone, params)
        new_p, st, m = TO.update(_adamw(gold, clip), p, grads,
                                 TO.init_state(p))
        out[name] = dict(params=_cpu(new_p), m=_cpu(st.m), v=_cpu(st.v),
                         step=int(st.step), lr=float(m["lr"]),
                         grad_norm=float(m["grad_norm"]), tree=(new_p, st))
    dominant = dict(out["grads"])
    dominant["final_norm"] = dominant["final_norm"] * DOMINANT
    out["dominant_norm"] = float(TO.global_norm(TM.unflatten(dominant)))
    step_mb, _, _ = TS.make_train_step(cfg, None, _adamw(gold), donate=False,
                                       microbatches=2)
    p_mb, _, m = step_mb(params, TO.init_state(params),
                         _microbatch_batch(cfg))
    out["microbatch"] = dict(loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]),
                             params=_cpu(p_mb))
    return out


@pytest.fixture(scope="module")
def ranks(single, tmp_path_factory):
    pytest.importorskip("jax")
    ckpt = tmp_path_factory.mktemp("ckpt")
    _jax_save(ckpt / "jax", *single["inactive"]["tree"])
    job = dict(grads=single["grads"], ckpt=ckpt,
               single_params=single["inactive"]["params"])
    return MESH.run_ranks(_rank, 4, job, timeout=300), ckpt


def test_update_on_blocks_equals_one_device_bit_for_bit(ranks, single):
    want = single["inactive"]
    for r in ranks[0]:
        got = r["inactive"]
        assert got["step"] == want["step"] == 1 and got["lr"] == want["lr"]
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            1e-5 * want["grad_norm"] and want["grad_norm"] < CLIPS["inactive"]
        for part in ("params", "m", "v"):
            for k, v in want[part].items():
                assert got[part][k].dtype == v.dtype
                assert torch.equal(got[part][k], v), (part, k)


def test_update_on_blocks_with_clipping_active(ranks, single):
    want = single["active"]
    for r in ranks[0]:
        got = r["active"]
        assert got["step"] == want["step"] and got["lr"] == want["lr"]
        assert want["grad_norm"] > CLIPS["active"]
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            1e-5 * want["grad_norm"]
        for part in ("m", "v"):
            for k, w in want[part].items():
                np.testing.assert_allclose(
                    got[part][k].numpy(), w.numpy(), rtol=1e-5,
                    atol=1e-5 * float(w.abs().max()), err_msg=k)
        for k, w in want["params"].items():
            bits = lambda t: t.view(torch.int16).numpy().astype(np.int64)
            d = np.abs(bits(got["params"][k]) - bits(w))
            assert d.max() <= 1 and (d == 0).mean() >= 0.5, k


def test_global_norm_counts_a_replicated_leaf_once(ranks, single):
    """A replicated leaf (final_norm, the same block on all 4 ranks) that
    dominates the norm: counted once a mesh, the norm is the one
    device's; counted once a rank it would be twice it."""
    want = single["dominant_norm"]
    assert want > 10 * single["inactive"]["grad_norm"]
    for r in ranks[0]:
        assert abs(r["dominant_norm"] - want) <= 1e-6 * want


def test_microbatches_on_a_mesh(ranks, single):
    """Two microbatches of 2 rows, each split over 'data': the loss, the
    norm and the updated parameters as one device's (the parameters
    within the training golden's first-step rule: 2 lr, plus bf16's half
    unit a side)."""
    want = single["microbatch"]
    lr = single["inactive"]["lr"]
    for r in ranks[0]:
        got = r["microbatch"]
        assert abs(got["loss"] - want["loss"]) <= \
            G.load_sharded()["tolerance"]["loss"]
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            G.load()["grad_norm_tol"] * want["grad_norm"]
        for k, w in want["params"].items():
            g, w = got["params"][k].double(), w.double()
            bound = 2 * lr * (1 + 2.0 ** -10) + 2.0 ** -8 * (g.abs() +
                                                              w.abs())
            assert float(((g - w).abs() / bound).max()) <= 1.0, k
        assert got["loss"] == ranks[0][0]["microbatch"]["loss"]
        assert all(torch.equal(got["params"][k], v) for k, v in
                   ranks[0][0]["microbatch"]["params"].items())


def _digests(d: pathlib.Path) -> dict:
    step = next(d.glob("step_*"))
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(step.iterdir())}


def test_sharded_save_equals_one_device_save(ranks, single, tmp_path):
    CK.save(tmp_path / "single", 1, single["inactive"]["tree"],
            data_state=dict(step=1))
    assert _digests(ranks[1] / "sharded") == _digests(tmp_path / "single")


def test_restores_both_ways(ranks, single):
    """The sharded save onto the mesh (each rank its blocks) and onto one
    device; the JAX package's ckpt.restore reads it; the JAX package's
    save onto the mesh."""
    for r in ranks[0]:
        assert r["restore_bad"] == [] and r["jax_restore_bad"] == []
        assert r["restore_step"] == (1, 1, dict(step=1))
    cfg = _cfg()
    abstract = (TM.abstract_params(cfg),
                TO.abstract_state(TM.abstract_params(cfg)))
    (p, st), step, _, _ = CK.restore(ranks[1] / "sharded", abstract,
                                     device="cpu")
    assert step == 1 and int(st.step) == 1
    for k, v in single["inactive"]["params"].items():
        assert torch.equal(_cpu(p)[k], v), k
    import jax
    from repro.models import model as JM
    from repro.train import checkpoint as JCK
    from repro.train import optimizer as JO
    from repro import configs as JC
    jcfg = JC.get_config(ARCH).reduced()
    pa = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    (jp, js), jstep, _, _ = JCK.restore(ranks[1] / "sharded",
                                        (pa, jax.eval_shape(JO.init_state,
                                                            pa)))
    assert jstep == 1 and int(js.step) == 1
    flat = {".".join(k.key for k in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    for k, v in single["inactive"]["params"].items():
        want = (v.view(torch.int16).numpy().view(np.uint16)
                if v.dtype == torch.bfloat16 else v.numpy())
        got = flat[k]
        got = got.view(np.uint16) if v.dtype == torch.bfloat16 else got
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_train_step_shardings_equal_jax_make_train_step(arch):
    """``make_train_step``'s third item on a (2, 2) and a (2, 2, 2)
    mesh: the JAX package's in/out shardings of its jitted step (params,
    and opt: the step replicated, the moments the parameters'), spec for
    spec, for the full and the reduced config."""
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh
    from repro import configs as JC
    from repro.train import optimizer as JO
    from repro.train import steps as JS
    for shape, names in (((2, 2), AXES),
                         ((2, 2, 2), ("pod", "data", "model"))):
        for reduced in (False, True):
            cj, ct = JC.get_config(arch), TC.get_config(arch)
            if reduced:
                cj, ct = cj.reduced(), ct.reduced()
            jsh = JS.make_train_step(cj, AbstractMesh(shape, names),
                                     JO.AdamWConfig())[2]
            tsh = TS.make_train_step(ct, MESH.AbstractMesh(shape, names),
                                     TO.AdamWConfig())[2]
            assert tuple(jsh["opt"].step.spec) == tsh["opt"].step.spec == ()
            for part in ("params", "m", "v"):
                jt = jsh["params"] if part == "params" else getattr(
                    jsh["opt"], part)
                tt = tsh["params"] if part == "params" else getattr(
                    tsh["opt"], part)
                import jax
                want = {"/".join(k.key for k in path): tuple(s.spec)
                        for path, s in jax.tree_util.tree_flatten_with_path(
                            jt)[0]}
                got = {k.replace(".", "/"): s.spec
                       for k, s in TM.flatten(tt).items()}
                assert got == want, (arch, shape, reduced, part)


def test_abstract_state_on_a_mesh_gives_the_blocks():
    """``abstract_state`` on a mesh: each moment the shape of the rank's
    block of its parameter (``param_spec``), f32; the step a scalar."""
    from repro_torch.distributed.sharding import local_shape, param_spec
    cfg = _cfg()
    pa = TM.abstract_params(cfg)
    mesh = MESH.AbstractMesh((2, 2), AXES, rank=3)
    st = TO.abstract_state(pa, mesh)
    assert st.step.shape == () and st.step.dtype == torch.int32
    for k, p in TM.flatten(pa).items():
        want = local_shape(tuple(p.shape), param_spec(k, tuple(p.shape),
                                                      mesh), mesh)
        for tree in (st.m, st.v):
            leaf = TM.flatten(tree)[k]
            assert tuple(leaf.shape) == want and leaf.dtype == torch.float32
    assert any(tuple(TM.flatten(st.m)[k].shape) != tuple(p.shape)
               for k, p in TM.flatten(pa).items())


@pytest.fixture(scope="module")
def oracle():
    ranks = MESH.run_ranks(_oracle_rank, 8, timeout=300)
    return ranks, _oracle_steps(None)


def test_jax_sharded_training_oracle_on_the_port(oracle):
    """The JAX package's test_sharded_train_step_loss_decreases on the
    port: the loss falls over five steps on (2, 2, 2), every rank alike,
    each step within 1e-2 of the JAX package's sharded run and of the
    port on one device."""
    ranks, one = oracle
    want = G.load_sharded()["oracle"]["loss"]
    tol = G.load_sharded()["tolerance"]["loss"]
    got = ranks[0]
    assert got[-1] < got[0], got
    assert all(r == got for r in ranks)
    for a, b, c in zip(got, want, one):
        assert abs(a - b) <= tol and abs(a - c) <= tol, (got, want, one)


def test_counting_mesh_equals_gloo_stats_train_step(ranks):
    for r in ranks[0]:
        gloo, counted = r["collectives"]
        assert gloo["all_gather_calls"] > 0 and gloo["reduce_scatter_calls"] > 0
        assert counted == gloo, (r["rank"], counted, gloo)

