"""The int8 collectives, error feedback and GPipe stages, port against the
JAX package.

Exact: ``quantize_int8`` / ``dequantize_int8`` against ``jax.jit`` of the
JAX functions (padding, f32 and bf16 inputs); ``ErrorFeedback``;
``psum_int8`` without noise on a (2, 2) mesh of gloo ranks (CPU, spawned
once) over both axes, and on a (4,) mesh over its axis, each bit for bit
against the JAX package's ``psum_int8`` in ``shard_map`` over a mesh of 4
host devices (Auto axes; the sharded golden holds it, and
``tests/test_torch_lm_sharding.py`` regenerates it).  Within the JAX
test's bounds: ``psum_int8`` against the exact sum (2% of max), with
stochastic rounding too, and ``pipeline_apply`` over a 'pipe' axis of 4
against the sequential stages and the JAX package's ``pipeline_apply``
(rtol 2e-4, atol 2e-5).

The spawned ranks import this module: no JAX at its top.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collectives as TCOL  # noqa: E402
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import golden as G  # noqa: E402

JAX = G.load_sharded()["collectives"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage(w, xb):
    return torch.tanh(xb @ w)


def _rank() -> dict:
    """One rank: psum_int8 over the (2, 2) mesh's axes and over a (4,)
    mesh, with and without noise, and the pipeline over a 'pipe' axis."""
    torch.set_num_threads(1)          # tiny products; the host is shared
    data = G.collective_inputs()
    mesh = MESH.make_mesh((2, 2), ("data", "model"), device="cpu")
    line = MESH.make_mesh((4,), ("data",), device="cpu")
    pipe = MESH.make_mesh((4,), ("pipe",), device="cpu")
    x = torch.from_numpy(data["x"][mesh.rank])
    gen = torch.Generator().manual_seed(10 + mesh.rank)
    out = dict(
        rank=mesh.rank,
        both=TCOL.psum_int8(x, mesh, ("data", "model")).numpy(),
        line=TCOL.psum_int8(x, line, "data").numpy(),
        model=TCOL.psum_int8(x, mesh, "model").numpy(),
        noisy=TCOL.psum_int8(x, line, "data", generator=gen).numpy(),
        bf16=TCOL.psum_int8(x.to(torch.bfloat16), line, "data"),
        pipeline=pipeline_apply(
            _stage, torch.from_numpy(data["pipe_x"]),
            torch.from_numpy(data["pipe_w"][pipe.rank][None]), pipe,
            n_micro=4, axis="pipe").numpy(),
        stats=dict(line.stats))
    return out


@pytest.fixture(scope="module")
def ranks():
    return MESH.run_ranks(_rank, 4, timeout=240)


def test_psum_int8_equals_the_reference_bit_for_bit(ranks):
    want = np.asarray(JAX["psum"], dtype=np.float32)
    for r in ranks:
        np.testing.assert_array_equal(r["line"], want[r["rank"]])
        # over both axes of the (2, 2) mesh: the same four ranks' sum
        np.testing.assert_array_equal(r["both"], want[r["rank"]])
    # the int8 payload: 1000 values padded to 4 blocks of 256, int32 on
    # the wire, and one f32 scale a block
    st = ranks[0]["stats"]
    assert st["all_reduce_calls"] == 6            # max + sum, 3 calls
    assert st["all_reduce_bytes"] == 3 * (1024 * 4 + 4 * 4)


def test_psum_int8_within_the_reference_tests_bound(ranks):
    x = G.collective_inputs()["x"]
    want = x.sum(0)
    for r in ranks:
        for k in ("both", "line", "noisy"):
            err = np.abs(r[k] - want).max() / np.abs(want).max()
            assert err < 0.02, (k, err)
        # over 'model' alone: the two ranks of the rank's row
        w = x[[r["rank"] // 2 * 2, r["rank"] // 2 * 2 + 1]].sum(0)
        assert np.abs(r["model"] - w).max() / np.abs(w).max() < 0.02
        assert r["bf16"].dtype == torch.bfloat16
        assert (np.abs(r["bf16"].float().numpy() - want).max()
                / np.abs(want).max()) < 0.02
    # stochastic rounding draws from each rank's generator: the ranks'
    # results agree (the sum is shared), and differ from round-to-nearest
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["noisy"], ranks[0]["noisy"])
    assert not np.array_equal(ranks[0]["noisy"], ranks[0]["line"])


def test_quantize_int8_equals_the_reference():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.distributed import collectives as JCOL
    rng = np.random.default_rng(1)
    for shape, dt in (((1000,), np.float32), ((3, 256), np.float32),
                      ((7, 5, 11), np.float32), ((513,), "bf16")):
        x = (rng.standard_normal(shape) * 5).astype(np.float32)
        x[..., 0] = 0.0
        tx = torch.from_numpy(x)
        jx = jnp.asarray(x)
        if dt == "bf16":
            tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
        q_t, s_t, n_t = TCOL.quantize_int8(tx)
        q_j, s_j = jax.jit(lambda v: JCOL.quantize_int8(v)[:2])(jx)
        assert n_t == x.size
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        back_t = TCOL.dequantize_int8(q_t, s_t, n_t, shape)
        back_j = jax.jit(lambda q, s: JCOL.dequantize_int8(
            q, s, x.size, shape))(q_j, s_j)
        np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
    # stochastic rounding: reproducible from its generator, unbiased
    x = torch.full((256 * 64,), 0.3)
    x[0] = 127.0                      # scale 1: y = 0.3 in every block
    draw = lambda s: TCOL.quantize_int8(
        x, torch.Generator().manual_seed(s))[0]
    assert torch.equal(draw(1), draw(1)) and not torch.equal(draw(1), draw(2))
    frac = float(draw(1).float().reshape(-1)[1:256].mean())
    assert abs(frac - 0.3) < 0.1


def test_error_feedback_equals_the_reference():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.distributed import collectives as JCOL
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    res = {"a": rng.standard_normal((4, 3)).astype(np.float32),
           "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    deq = {"a": rng.standard_normal((4, 3)).astype(np.float32),
           "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    t = lambda tree: {k: t(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in tree.items()}
    j = lambda tree: {k: j(v) if isinstance(v, dict) else jnp.asarray(v)
                      for k, v in tree.items()}
    zt, zj = TCOL.ErrorFeedback.init(t(grads)), JCOL.ErrorFeedback.init(
        j(grads))
    gp_t, fn_t = TCOL.ErrorFeedback.apply(t(grads), t(res))
    gp_j, fn_j = JCOL.ErrorFeedback.apply(j(grads), j(res))
    for got, want in ((zt, zj), (gp_t, gp_j), (fn_t(t(deq)), fn_j(j(deq)))):
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
        np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                      np.asarray(want["b"]["c"]))
        assert got["a"].dtype == torch.float32


def test_pipeline_within_the_reference_tests_bounds(ranks):
    data = G.collective_inputs()
    want = torch.from_numpy(data["pipe_x"])
    for s in range(4):
        want = _stage(torch.from_numpy(data["pipe_w"][s]), want)
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"], want.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(r["pipeline"], np.asarray(
            JAX["pipeline"], dtype=np.float32), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_stage, torch.zeros(6, 2), torch.zeros(1, 2, 2),
                       MESH.AbstractMesh((4,), ("pipe",), rank=0), n_micro=4)
