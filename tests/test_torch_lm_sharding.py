"""The LM's sharding rules and a rank's blocks, port against the JAX
package.

Exact: every spec of ``param_spec``, ``cache_spec`` and ``batch_specs``
for every leaf of the ten configs, full and reduced, against the JAX
functions on a ``jax.sharding.AbstractMesh`` of (1, 1), (2, 2), (4, 2),
(2, 2, 2) and the production meshes (16, 16) and (2, 16, 16) in both
layouts; on a (2, 2) mesh of gloo ranks (CPU, spawned once), every rank's
blocks of ``seeded_params``, ``init_params`` and ``load_numpy_params``
against the one-device tensors, ``gather_tree`` against the whole tree,
the cache's blocks, and the checkpoint: a sharded save's files sha256-equal
to the one-device save's, a restore onto a (2, 1) mesh giving each block
exactly, and a corrupted file raising ``IOError``.  One subprocess with 8
host devices (``tests/torch_lm_sharded_cases.py --check``) regenerates
what the sharded golden holds beyond its (2, 2) cases: h2o-danube-1.8b on
a (4, 2) mesh (the JAX package's own sharded test's case) and the JAX
package's ``psum_int8`` and ``pipeline_apply`` on 4 devices.

The spawned ranks import this module, so JAX is imported inside the
tests, never at its top.
"""
import functools
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(TC.ARCHS)
# (shape, axis names) of the meshes the rules are compared on
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "prod": ((16, 16), ("data", "model")),
    "prod-multi": ((2, 16, 16), ("pod", "data", "model")),
    "prod-fsdp": ((16, 16), ("data", "data2")),
    "prod-multi-fsdp": ((2, 16, 16), ("pod", "data", "data2")),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    return pytest.importorskip("jax")


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch: str, reduced: bool):
    from repro import configs as JC
    from repro.models import model as JM
    cfg = JC.get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    import jax.numpy as jnp
    caches = {f"{kv} {b}": JM.abstract_cache(cfg, b, 32, getattr(jnp, kv))
              for kv in ("bfloat16", "int8") for b in (4, 3)}
    return cfg, JM.abstract_params(cfg), caches


def _paths(tree):
    jax = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in kp): leaf for kp, leaf in flat}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh_name):
    jax = _jax()
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding as JSH
    from repro.train import steps as JS
    from repro.configs.base import ShapeSpec as JShapeSpec
    shape, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    tmesh = MESH.AbstractMesh(shape, names)
    for reduced in (False, True):
        cfg_j, params_j, caches_j = _jax_abstract(arch, reduced)
        cfg_t = TC.get_config(arch)
        cfg_t = cfg_t.reduced() if reduced else cfg_t
        # parameters: every leaf, the port's tree against the reference's
        want = {p: tuple(JSH.param_spec(p, leaf.shape, jmesh))
                for p, leaf in _paths(params_j).items()}
        got_tree = SH.param_shardings(TM.abstract_params(cfg_t), tmesh)
        got = {p.replace(".", "/"): sh.spec
               for p, sh in TM.flatten(got_tree).items()}
        assert got == want, (arch, reduced, mesh_name)
        # caches: bf16 and int8 layouts, a batch that divides and one not
        for name, cache_j in caches_j.items():
            b = next(iter(_paths(cache_j).values())).shape[1]
            kv = torch.int8 if "int8" in name else torch.bfloat16
            want = {p: tuple(JSH.cache_spec(p, leaf.shape, jmesh))
                    for p, leaf in _paths(cache_j).items()}
            got = {p.replace(".", "/"): sh.spec for p, sh in TM.flatten(
                SH.cache_shardings(TM.abstract_cache(cfg_t, b, 32, kv),
                                   tmesh)).items()}
            assert got == want, (arch, reduced, mesh_name, name)
        # batches: every kind, three batch sizes
        for kind in ("train", "prefill", "decode"):
            for batch in (4, 6, 3):
                bj = JS.make_batch_abstract(
                    cfg_j, JShapeSpec("s", 48, batch, kind))
                bt = TS.make_batch_abstract(
                    cfg_t, ShapeSpec("s", 48, batch, kind))
                want = {k: tuple(v.spec) for k, v in
                        JSH.batch_specs(cfg_j, jmesh, bj).items()}
                got = {k: v.spec for k, v in
                       SH.batch_specs(cfg_t, tmesh, bt).items()}
                assert got == want, (arch, reduced, mesh_name, kind, batch)


def test_production_mesh_and_parse_mesh():
    """The reference's production meshes, abstract; ``--mesh`` as the
    reference's launcher parses it (one device: no mesh)."""
    for multi, layout, shape, names in (
            (False, "2d", (16, 16), ("data", "model")),
            (True, "2d", (2, 16, 16), ("pod", "data", "model")),
            (False, "fsdp", (16, 16), ("data", "data2")),
            (True, "fsdp", (2, 16, 16), ("pod", "data", "data2"))):
        m = MESH.make_production_mesh(multi_pod=multi, layout=layout)
        assert (m.axis_names, tuple(m.shape.values()), m.size) == (
            names, shape, int(np.prod(shape)))
    with pytest.raises(ValueError, match="layout"):
        MESH.make_production_mesh(layout="3d")
    assert MESH.parse_mesh("auto", 1) is None
    assert MESH.parse_mesh("1x1", 4) is None
    assert MESH.parse_mesh("auto", 8) == ((4, 2), ("data", "model"))
    assert MESH.parse_mesh("2x2", 1) == ((2, 2), ("data", "model"))
    assert MESH.parse_mesh("2x2x2", 1) == ((2, 2, 2),
                                           ("pod", "data", "model"))
    assert MESH.parse_mesh("4", 1) == ((4,), ("model",))
    with pytest.raises(ValueError):
        MESH.parse_mesh("2x2x2x2", 16)


def test_block_and_local_shape():
    mesh = MESH.AbstractMesh((2, 2, 2), ("pod", "data", "model"), rank=5)
    assert mesh.coords == {"pod": 1, "data": 0, "model": 1}
    x = np.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    assert SH.local_shape(x.shape, spec, mesh) == (2, 3)
    np.testing.assert_array_equal(SH.block(x, spec, mesh), x[4:6, 3:6])
    with pytest.raises(ValueError, match="split"):
        SH.block(np.zeros((3, 6)), spec, mesh)


# --------------------------------------------------------------------------- #
# A (2, 2) mesh of gloo ranks on the CPU
# --------------------------------------------------------------------------- #
def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


def _mismatches(local: dict, whole: dict, mesh, cfg) -> list:
    specs = TM.flatten(TS.make_prefill_step(cfg, mesh, 32, 4)[2]["params"])
    bad = []
    for path, t in TM.flatten(local).items():
        want = SH.block(whole[path], specs[path].spec, mesh)
        if not (t.dtype == want.dtype and torch.equal(t, want)):
            bad.append(path)
    return bad


def _rank(workdir: str) -> dict:
    """One rank: its blocks of every reduced config, the gathered trees,
    the cache blocks, and a sharded save and a (2, 1) restore of
    qwen3-4b-reduced."""
    torch.set_num_threads(1)          # tiny products; the host is shared
    mesh = MESH.make_mesh((2, 2), ("data", "model"), device="cpu")
    res = dict(rank=mesh.rank, coords=mesh.coords, seeded={}, torch_rng={},
               numpy={}, gathered={}, cache={})
    for arch in ARCHS:
        cfg = TC.get_config(arch).reduced()
        whole = TM.flatten(TM.seeded_params(cfg, 0, "cpu"))
        local = TM.seeded_params(cfg, 0, "cpu", mesh=mesh)
        res["seeded"][arch] = _mismatches(local, whole, mesh, cfg)
        sh = TS.make_prefill_step(cfg, mesh, 32, 4)[2]
        back = TM.flatten(SH.gather_tree(local, sh["params"]))
        res["gathered"][arch] = [p for p, t in whole.items()
                                 if not torch.equal(back[p], t)]
        numpy_tree = TM.unflatten({p: _bits(t) for p, t in whole.items()})
        res["numpy"][arch] = _mismatches(
            TM.load_numpy_params(cfg, numpy_tree, "cpu", mesh=mesh), whole,
            mesh, cfg)
        gen = lambda: torch.Generator().manual_seed(3)
        res["torch_rng"][arch] = _mismatches(
            TM.init_params(cfg, gen(), "cpu", mesh=mesh),
            TM.flatten(TM.init_params(cfg, gen(), "cpu")), mesh, cfg)
        cache = TM.flatten(TM.init_cache(cfg, 4, 32, torch.int8, "cpu",
                                         mesh=mesh))
        res["cache"][arch] = {p: (tuple(t.shape), str(t.dtype),
                                  bool(t.eq(0).all()))
                              for p, t in cache.items()}
    # the checkpoint: saved from the (2, 2) mesh, restored onto (2, 1)
    cfg = TC.get_config("qwen3-4b").reduced()
    local = TM.seeded_params(cfg, 0, "cpu", mesh=mesh)
    sh = TS.make_prefill_step(cfg, mesh, 32, 4)[2]["params"]
    CK.save(pathlib.Path(workdir) / "sharded", 7, local,
            data_state=dict(step=7), shardings=sh)
    mesh21 = MESH.AbstractMesh((2, 1), ("data", "model"),
                               rank=mesh.rank % 2)
    sh21 = TS.make_prefill_step(cfg, mesh21, 32, 4)[2]["params"]
    restored, step, ds, _ = CK.restore(
        pathlib.Path(workdir) / "sharded", TM.abstract_params(cfg),
        device="cpu", shardings=sh21)
    whole = TM.flatten(TM.seeded_params(cfg, 0, "cpu"))
    res["restore"] = dict(step=step, data_state=ds,
                          bad=_mismatches(restored, whole, mesh21, cfg))
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("lm_sharding")
    return MESH.run_ranks(_rank, 4, str(workdir), timeout=240), workdir


def test_every_rank_holds_exactly_its_blocks(ranks):
    outs, _ = ranks
    assert [r["coords"] for r in outs] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    for r in outs:
        for kind in ("seeded", "numpy", "torch_rng", "gathered"):
            assert r[kind] == {a: [] for a in ARCHS}, (r["rank"], kind)


def test_cache_blocks_follow_cache_spec(ranks):
    outs, _ = ranks
    mesh = MESH.AbstractMesh((2, 2), ("data", "model"))
    for arch in ARCHS:
        cfg = TC.get_config(arch).reduced()
        abstract = TM.flatten(TM.abstract_cache(cfg, 4, 32, torch.int8))
        want = {p: (SH.local_shape(tuple(a.shape), SH.cache_spec(
            p, tuple(a.shape), mesh), mesh), str(a.dtype), True)
            for p, a in abstract.items()}
        for r in outs:
            assert r["cache"][arch] == want, (arch, r["rank"])


def _digests(d: pathlib.Path) -> dict:
    step = next(d.glob("step_*"))
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(step.iterdir())}


def test_sharded_save_equals_the_single_device_save(ranks, tmp_path):
    outs, workdir = ranks
    cfg = TC.get_config("qwen3-4b").reduced()
    CK.save(tmp_path / "single", 7, TM.seeded_params(cfg, 0, "cpu"),
            data_state=dict(step=7))
    assert _digests(workdir / "sharded") == _digests(tmp_path / "single")


def test_restore_onto_another_mesh_gives_each_block(ranks):
    outs, workdir = ranks
    for r in outs:
        assert r["restore"] == dict(step=7, data_state=dict(step=7), bad=[])
    # corruption raises, also when the restore reads one block
    ckdir = workdir / "corrupt"
    cfg = TC.get_config("qwen3-4b").reduced()
    CK.save(ckdir, 3, TM.seeded_params(cfg, 0, "cpu"))
    next(ckdir.glob("step_*/arr_00000.npy")).write_bytes(b"garbage")
    mesh21 = MESH.AbstractMesh((2, 1), ("data", "model"), rank=1)
    sh21 = TS.make_prefill_step(cfg, mesh21, 32, 4)[2]["params"]
    with pytest.raises(IOError, match="corruption"):
        CK.restore(ckdir, TM.abstract_params(cfg), device="cpu",
                   shardings=sh21)


# --------------------------------------------------------------------------- #
# The sharded golden's JAX side, regenerated
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_lm_sharded_cases.py"),
         "--check"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=600)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_the_golden_case_of_the_reference_test_regenerates(jax_side):
    """h2o-danube-1.8b on (4, 2), as the JAX package's sharded test runs
    it (on Auto axes), equals the committed golden: every logit of the
    digest equal or one bf16 unit in the last place away."""
    from repro_torch.models import golden as G
    gold = G.load_sharded()
    got, want = jax_side["case"], gold["cases"]["h2o-danube-1.8b (4, 2)"]
    assert got["mesh"] == want["mesh"] == [4, 2]
    for k in ("prefill", "decode"):
        a, b = np.asarray(got[k]["rows"]), np.asarray(want[k]["rows"])
        ulp = np.abs(b) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(a - b) <= ulp), k
    assert got["jax_spread"]["decode"] <= gold["tolerance"]["dense"]


def test_the_golden_collectives_regenerate(jax_side):
    """The JAX package's ``psum_int8`` (bit for bit) and
    ``pipeline_apply`` on 4 host devices equal the committed golden."""
    from repro_torch.models import golden as G
    gold = G.load_sharded()["collectives"]
    np.testing.assert_array_equal(np.float32(jax_side["psum"]),
                                  np.float32(gold["psum"]))
    np.testing.assert_allclose(np.float32(jax_side["pipeline"]),
                               np.float32(gold["pipeline"]), rtol=1e-6,
                               atol=1e-7)
