"""The LM scaffold's discrete parts, port against the JAX package, exact:
the architecture registry, ``reduced()``, the shape registry and cell
rules, the full configs' parameter counts (on the meta device), every
reduced config's parameter and cache trees (key paths, shapes, dtypes; bf16
and int8 caches), MoE capacity, the int8 KV quantizer, and the mesh guard.

``test_golden_equals_a_fresh_jax_run`` regenerates
``src/repro_torch/models/jax_lm_golden.json`` (``repro_torch.models.golden``
says what it holds) from the JAX package.  Regenerate the file after a
deliberate change of the JAX package:

    PYTHONPATH=src python tests/test_torch_lm_configs.py
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.distributed import collectives as JCOL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.distributed import collectives as TCOL  # noqa: E402
from repro_torch.launch.mesh import parse_mesh  # noqa: E402
from repro_torch.models import golden as G  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import part  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARCHS = sorted(TC.ARCHS)
ALL = ARCHS + sorted(TC.EXTRA_ARCHS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(tree) -> dict:
    """{dotted path: (shape, dtype name)} of a JAX pytree of dicts."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.key for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _port_tree(tree) -> dict:
    return {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in TM.flatten(tree).items()}


def test_registry_equals_reference():
    assert list(TC.ARCHS) == list(JC.ARCHS) == TC.list_archs()
    assert list(TC.EXTRA_ARCHS) == list(JC.EXTRA_ARCHS)
    for name in ALL:
        assert (dataclasses.asdict(TC.get_config(name))
                == dataclasses.asdict(JC.get_config(name))), name
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-2")
    assert TC.base.FAMILIES == JC.base.FAMILIES


@pytest.mark.parametrize("arch", ALL)
def test_reduced_and_properties_equal_reference(arch):
    t, j = TC.get_config(arch), JC.get_config(arch)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for c_t, c_j in ((t, j), (t.reduced(), j.reduced())):
        for prop in ("d_inner", "n_ssm_heads", "is_attention_free",
                     "sub_quadratic"):
            assert getattr(c_t, prop) == getattr(c_j, prop), prop
    assert (dataclasses.asdict(t.replace(n_layers=2))
            == dataclasses.asdict(j.replace(n_layers=2)))


def test_shapes_and_cell_rules_equal_reference():
    assert TC.SHAPE_ORDER == JC.SHAPE_ORDER
    assert ({k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()})
    for name in ALL:
        for key in TC.SHAPE_ORDER:
            assert (TC.cell_applicable(TC.get_config(name), TC.SHAPES[key])
                    == JC.cell_applicable(JC.get_config(name),
                                          JC.SHAPES[key])), (name, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_of_full_configs_equal_reference(arch):
    """On the meta device: llama3-405b is never allocated."""
    t, j = TC.get_config(arch), JC.get_config(arch)
    assert TM.param_count(t) == JM.param_count(j)
    assert TM.active_param_count(t) == JM.active_param_count(j)


def test_named_param_counts():
    assert TM.param_count(TC.get_config("qwen3-4b")) == 4_411_424_256
    moe = TC.get_config("qwen3-moe-30b-a3b")
    assert TM.param_count(moe) == 30_532_122_624
    assert TM.active_param_count(moe) == 3_353_032_704
    assert TM.param_count(TC.get_config("mamba2-780m")) == 857_170_176


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_equal_reference(arch):
    t, j = TC.get_config(arch).reduced(), JC.get_config(arch).reduced()
    assert _port_tree(TM.abstract_params(t)) == _jax_tree(
        JM.abstract_params(j))
    for kv_t, kv_j in ((torch.bfloat16, jnp.bfloat16),
                       (torch.int8, jnp.int8)):
        want = _jax_tree(JM.abstract_cache(j, 2, 24, kv_j))
        assert _port_tree(TM.abstract_cache(t, 2, 24, kv_t)) == want
        assert _port_tree(TM.init_cache(t, 2, 24, kv_t, "cpu")) == want
    lm = TM.LM(t, TM.init_params(t, torch.Generator().manual_seed(0),
                                 "cpu"))
    sd = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
          for k, v in lm.state_dict().items()}
    assert sd == _jax_tree(JM.abstract_params(j))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_capacity_equals_reference(arch):
    assert TMOE.GROUP == JMOE.GROUP
    assert TMOE.CAPACITY_FACTOR == JMOE.CAPACITY_FACTOR
    for cfg_t, cfg_j in ((TC.get_config(arch), JC.get_config(arch)),
                         (TC.get_config(arch).reduced(),
                          JC.get_config(arch).reduced())):
        for group in (TMOE.GROUP, 7, 128, 1000):
            assert (TMOE.capacity(cfg_t, group)
                    == JMOE.capacity(cfg_j, group)), (arch, group)


def test_quantize_kv_int8_equals_reference():
    """Exact on one f32 input: random blocks, a zero block, a block of one
    magnitude, a block with small integer ratios."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 9, 3, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = 4.0
    x[1, 2, 2, :4] = np.float32([127.0, 0.5, -1.5, 2.5])
    x[1, 2, 2, 4:] = 0.0
    q_t, s_t = TCOL.quantize_kv_int8(torch.from_numpy(x))
    # as compiled (the model calls it inside its scan): XLA turns the
    # division by 127 into a product with the f32 reciprocal
    q_j, s_j = jax.jit(JCOL.quantize_kv_int8)(jnp.asarray(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    back_t = TCOL.dequantize_kv_int8(q_t, s_t)
    back_j = JCOL.dequantize_kv_int8(q_j, s_j)
    np.testing.assert_array_equal(back_t.float().numpy(),
                                  np.asarray(back_j, np.float32))


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


def test_only_a_single_device_mesh_is_accepted():
    """A one-device mesh (or none) runs the single-device path; a mesh of
    several devices is a mesh of ranks to spawn (``parse_mesh``), on
    which prefill and decode run sharded (``tests/test_torch_lm_sharded.py``)
    and so does the train step: its shardings are the parameters' (the
    moments beside them, the step replicated), and on a (1, 2) mesh of
    gloo ranks its gathered gradient is the one device's within the
    sharded golden's bound
    (``tests/test_torch_lm_sharded_train*.py`` hold the rest)."""
    assert parse_mesh("auto", 1) is None
    assert parse_mesh("1x1", 1) is None
    assert parse_mesh("1x1x1", 4) is None
    for spec, n, shape in (("auto", 4, (2, 2)), ("2x2", 4, (2, 2)),
                           ("1x2", 2, (1, 2)), ("2x1x1", 2, (2, 1, 1))):
        assert parse_mesh(spec, n)[0] == shape
    x = torch.zeros(2, 3)
    assert part.constrain(x, None, (None, None)) is x
    assert part.constrain(x, _FakeMesh(data=1, model=1), (None, None)) is x
    cfg = TC.get_config("qwen3-4b").reduced()
    four = _FakeMesh(data=2, model=2)
    assert part.constrain(x, four, (None, None)) is x
    with pytest.raises(AssertionError):
        part.constrain(x, four, (None,))
    for make in (TS.make_prefill_step, TS.make_decode_step):
        sh = make(cfg, four, 24, 2)[2]
        assert sh["params"]["embed"].spec == ("model", "data")
    sh = TS.make_train_step(cfg, four, TO.AdamWConfig())[2]
    assert sh["params"]["embed"].spec == ("model", "data")
    assert sh["opt"].m is sh["params"] and sh["opt"].v is sh["params"]
    assert sh["opt"].step.spec == ()
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.train import golden as TG
    ranks = run_ranks(TG.mesh_train_run, 2, ("qwen3-4b",), (1, 2),
                      ("data", "model"), "cpu", 1, timeout=300)
    got = ranks[0]["runs"]["qwen3-4b"]
    one = TG.train_run(cfg, TG.load(), "cpu", steps=1)
    errs = TG.leaf_errors(got["grads"], one["grads"])
    assert max(errs.values()) <= TG.load_sharded()["tolerance"][
        "sharded_grad"], errs
    assert got["lr"] == one["lr"] and abs(got["loss"][0] - one["loss"][0]) \
        <= TG.load_sharded()["tolerance"]["loss"]
    assert ranks[1]["runs"]["qwen3-4b"]["loss"] == got["loss"]


# --------------------------------------------------------------------------- #
# The golden for hosts without JAX
# --------------------------------------------------------------------------- #
def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def jax_params_of(tree: dict):
    """A port parameter tree as the JAX package's (bf16 through its bit
    pattern)."""
    import ml_dtypes
    return {k: jax_params_of(v) if isinstance(v, dict) else jnp.asarray(
        _bf16_bits(v).view(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16
        else v.numpy()) for k, v in tree.items()}


def jax_golden(old: dict) -> dict:
    """The golden, regenerated: ``old`` gives the seeds, shapes, positions
    and tolerances (they are settings, not results)."""
    settings = {k: old[k] for k in old if k not in ("full", "reduced")}
    full = {a: dict(param_count=JM.param_count(JC.get_config(a)),
                    active_param_count=JM.active_param_count(
                        JC.get_config(a)))
            for a in ARCHS}
    reduced = {}
    for a in ARCHS:
        cfg = JC.get_config(a).reduced()
        params = jax_params_of(TM.seeded_params(
            TC.get_config(a).reduced(), settings["weights_seed"], "cpu"))
        tokens, ctx = G.inputs(cfg, settings)
        fwd = jax.jit(lambda p, t, x: JM.forward(p, t, cfg, ctx=x)[0])
        logits = fwd(params, jnp.asarray(tokens),
                     None if ctx is None else jnp.asarray(ctx))
        reduced[a] = G.digest(np.asarray(logits), settings)
    return dict(settings, full=full, reduced=reduced)


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_golden_equals_a_fresh_jax_run():
    old = G.load()
    fresh = json.loads(json.dumps(jax_golden(old)))
    assert fresh["full"] == old["full"]
    assert sorted(fresh["reduced"]) == sorted(old["reduced"]) == ARCHS
    for a in ARCHS:
        got, want = fresh["reduced"][a], old["reduced"][a]
        g, w = np.asarray(got["rows"]), np.asarray(want["rows"])
        assert g.shape == w.shape, a
        assert (np.abs(g - w) <= _ulp_bf16(w)).all(), a
        assert abs(got["max_abs"] - want["max_abs"]) <= _ulp_bf16(
            np.float64(want["max_abs"])), a
    assert old["full"]["qwen3-4b"]["param_count"] == 4_411_424_256


@pytest.mark.parametrize("arch", ARCHS)
def test_port_on_the_cpu_matches_the_golden(arch):
    """What the card's check does, on the CPU: the port's forward from the
    golden's weights against the JAX package's logits."""
    gold = G.load()
    cfg = TC.get_config(arch).reduced()
    params = TM.seeded_params(cfg, gold["weights_seed"], "cpu")
    tokens, ctx = G.inputs(cfg, gold)
    logits, _, _ = TM.forward(params, torch.from_numpy(tokens), cfg,
                              ctx=None if ctx is None
                              else torch.from_numpy(ctx))
    err = G.rel_err(G.digest(logits, gold), gold["reduced"][arch])
    assert err <= gold["tolerance"][cfg.family], err


if __name__ == "__main__":
    settings = dict(
        weights_seed=0, tokens_seed=1, ctx_seed=2, batch=2, seq=16,
        stride=8, positions=[[0, 15], [1, 15], [0, 8], [1, 0]],
        tolerance=dict(dense=2e-2, vlm=2e-2, audio=2e-2, hybrid=3e-2,
                       ssm=3e-2, moe=6e-2),
        nll_tol=1e-2, prefill_decode_tol=5e-2, int8_tol=0.08)
    G.PATH.write_text(json.dumps(jax_golden(settings), indent=1) + "\n")
    print(f"wrote {G.PATH}", file=sys.stderr)
