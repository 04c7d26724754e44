"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's ``train/optimizer.py`` as ``jax.jit`` compiles it, on the same
parameters, gradients and state, over bf16 and f32 leaves and steps
through the warmup and the decay.

Exact: the learning rate at every step, the step, the initial state's
shapes and dtypes, and, with clipping inactive, the parameters and both
moments bit for bit.  Not exact: the global norm, whose last reduce XLA
lets LLVM reassociate (the port sums each leaf in f64: within 1e-5
relative); with clipping active the clip
scale then differs in its last bits, so the moments are held within 1e-5
of each leaf's largest and the parameters within one unit of their
dtype.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.train import optimizer as JO  # noqa: E402
from repro_torch.core.f32order import fma_f32  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

# a tree of the LM's kinds of leaves: stacked (G, d, f) bf16 matrices, a
# 2-D f32 router, bf16 norms, f32 vectors, a small odd-shaped leaf
SPEC = {"blocks": {"w": ((4, 64, 96), "bf16"), "router": ((128, 40), "f32"),
                   "ln": ((4, 70), "bf16"), "A_log": ((4, 8), "f32")},
        "embed": ((300, 33), "bf16"), "norm": ((5,), "bf16"),
        "bias": ((300,), "f32")}
CONFIGS = [dict(lr=1e-3, warmup_steps=3, total_steps=8),
           dict(lr=3e-4, warmup_steps=2, total_steps=5, weight_decay=0.0),
           dict(lr=1e-2, warmup_steps=4, total_steps=100, b1=0.8, b2=0.99,
                min_lr_ratio=0.0)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(spec, rng, scale):
    if isinstance(spec, dict):
        return {k: _draw(v, rng, scale) for k, v in spec.items()}
    shape, dt = spec
    x = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dt == "bf16" else x


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _bits(tree):
    """{path: uint bit patterns} of a torch or JAX tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
            return
        if torch.is_tensor(node):
            t = node.detach().cpu()
            a = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                 else t.numpy())
        else:
            a = np.asarray(node)
            a = a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a
        out[path] = a
    walk(tree, "")
    return out


def _run(cfg_kw, grad_scale, steps, seed=0):
    """Yields (reference outputs, port outputs) after each of ``steps``
    updates from the same parameters and gradients; the port donates
    every other step (so a yielded state is current until the next)."""
    rng = np.random.default_rng(seed)
    cfg_j = JO.AdamWConfig(**cfg_kw)
    cfg_t = TO.AdamWConfig(**cfg_kw)
    p0 = _draw(SPEC, rng, 0.05)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    sj = JO.init_state(pj)
    pt = _torch(p0)
    st = TO.init_state(pt)
    upd = jax.jit(lambda p, g, s: JO.update(cfg_j, p, g, s))
    for i in range(steps):
        g = _draw(SPEC, rng, grad_scale)
        pj, sj, mj = upd(pj, jax.tree_util.tree_map(jnp.asarray, g), sj)
        pt, st, mt = TO.update(cfg_t, pt, _torch(g), st, donate=i % 2 == 0)
        yield (pj, sj, mj), (pt, st, mt)


@pytest.mark.parametrize("cfg_kw", CONFIGS, ids=["short", "no-decay",
                                                 "long"])
def test_update_equals_jax_bit_for_bit_without_clipping(cfg_kw):
    for (pj, sj, mj), (pt, st, mt) in _run(dict(cfg_kw, grad_clip=1e9),
                                           0.01, 8):
        assert int(st.step) == int(sj.step)
        assert st.step.dtype == torch.int32
        assert float(mt["lr"]) == float(mj["lr"])
        for name, a, b in (("params", pt, pj), ("m", st.m, sj.m),
                           ("v", st.v, sj.v)):
            got, want = _bits(a), _bits(b)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name}{k}")
        gj, gt = float(mj["grad_norm"]), float(mt["grad_norm"])
        assert abs(gt - gj) <= 1e-5 * gj


def test_update_with_clipping_within_the_norm_s_rounding():
    """grad_clip 1 with gradients of norm ~50: lr and step exact, the
    norm within 1e-5, the moments within 1e-5 of each leaf's largest
    (a moment that cancels keeps the absolute error), every parameter
    within one unit of its dtype (most equal)."""
    for (pj, sj, mj), (pt, st, mt) in _run(dict(CONFIGS[0], grad_clip=1.0),
                                           0.3, 6, seed=1):
        assert int(st.step) == int(sj.step)
        assert float(mt["lr"]) == float(mj["lr"])
        gj, gt = float(mj["grad_norm"]), float(mt["grad_norm"])
        assert gj > 1.0 and abs(gt - gj) <= 1e-5 * gj
        for a, b in ((st.m, sj.m), (st.v, sj.v)):
            for k, want in _bits(b).items():
                got = _bits(a)[k]
                np.testing.assert_allclose(
                    got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                    err_msg=k)
        flat_t = {k: v for k, v in _bits(pt).items()}
        for k, want in _bits(pj).items():
            got = flat_t[k]
            # one unit in the last place: adjacent bit patterns
            assert np.abs(got.astype(np.int64) - want.astype(np.int64)
                          ).max() <= 1, k
            assert (got == want).mean() >= 0.5, k


@pytest.mark.parametrize("cfg_kw", CONFIGS + [
    dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
    dict(lr=1e-3, warmup_steps=2, total_steps=3)],
    ids=["short", "no-decay", "long", "defaults", "golden"])
def test_schedule_equals_jax_at_every_step(cfg_kw):
    cfg_j, cfg_t = JO.AdamWConfig(**cfg_kw), TO.AdamWConfig(**cfg_kw)
    fn = jax.jit(lambda s: JO._schedule(cfg_j, s))
    stop = min(cfg_kw["total_steps"] + 3, 400)
    steps = list(range(stop))
    if cfg_kw["total_steps"] > 400:
        steps += list(range(cfg_kw["total_steps"] - 300,
                            cfg_kw["total_steps"] + 3))
    for s in steps:
        want = np.asarray(fn(jnp.int32(s)))
        got = TO._schedule(cfg_t, s)
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == want, (s, float(got), float(want))


def test_global_norm_and_clip_within_rounding():
    rng = np.random.default_rng(2)
    g = _draw(SPEC, rng, 0.3)
    gj = jax.tree_util.tree_map(jnp.asarray, g)
    want = float(jax.jit(JO.global_norm)(gj))
    got = TO.global_norm(_torch(g))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= 1e-5 * want
    clipped_t, n_t = TO.clip_by_global_norm(_torch(g), 1.0)
    clipped_j, n_j = jax.jit(lambda t: JO.clip_by_global_norm(t, 1.0))(gj)
    assert abs(float(n_t) - float(n_j)) <= 1e-5 * float(n_j)
    for k, want_k in _bits(clipped_j).items():
        got_k = _bits(clipped_t)[k]
        assert got_k.dtype == want_k.dtype
        assert np.abs(got_k.astype(np.int64) - want_k.astype(np.int64)
                      ).max() <= 64, k
    # inactive clipping leaves every gradient as it is
    same, _ = TO.clip_by_global_norm(_torch(g), 1e9)
    for k, v in _bits(same).items():
        np.testing.assert_array_equal(v, _bits(_torch(g))[k])


def test_init_and_abstract_state_match_jax():
    p = _torch(_draw(SPEC, np.random.default_rng(3), 1.0))
    want = JO.init_state(jax.tree_util.tree_map(
        jnp.asarray, _draw(SPEC, np.random.default_rng(3), 1.0)))
    for st in (TO.init_state(p), TO.abstract_state(p)):
        assert st.step.dtype == torch.int32 and st.step.shape == ()
        for a, b in ((st.m, want.m), (st.v, want.v)):
            flat_t = TO.tree_leaves(a)
            flat_j = jax.tree_util.tree_leaves(b)
            assert [tuple(t.shape) for t in flat_t] == [x.shape
                                                        for x in flat_j]
            assert all(t.dtype == torch.float32 for t in flat_t)
    assert all(t.device.type == "meta"
               for t in TO.tree_leaves(TO.abstract_state(p).m))
    assert all(float(t.abs().sum()) == 0
               for t in TO.tree_leaves(TO.init_state(p).v))


def test_donated_update_writes_in_place_and_equals_a_fresh_one():
    rng = np.random.default_rng(4)
    p0, g = _draw(SPEC, rng, 0.1), _draw(SPEC, rng, 0.1)
    cfg = TO.AdamWConfig(**CONFIGS[0])
    pa, pb = _torch(p0), _torch(p0)
    sa, sb = TO.init_state(pa), TO.init_state(pb)
    leaves = TO.tree_leaves(pa) + TO.tree_leaves(sa.m) + [sa.step]
    old = [t.data_ptr() for t in leaves]
    na, ta, _ = TO.update(cfg, pa, _torch(g), sa, donate=True)
    nb, tb, _ = TO.update(cfg, pb, _torch(g), sb, donate=False)
    new = TO.tree_leaves(na) + TO.tree_leaves(ta.m) + [ta.step]
    assert [t.data_ptr() for t in new] == old
    assert int(sb.step) == 0 and int(tb.step) == int(ta.step) == 1
    for x, y in zip(TO.tree_leaves((na, ta.m, ta.v)),
                    TO.tree_leaves((nb, tb.m, tb.v))):
        assert torch.equal(x, y)


def test_update_in_slices_equals_update_whole(monkeypatch):
    """Slicing a leaf along its first axis changes no bit."""
    rng = np.random.default_rng(5)
    p0, g = _draw(SPEC, rng, 0.1), _draw(SPEC, rng, 0.1)
    cfg = TO.AdamWConfig(**CONFIGS[0])
    whole = TO.update(cfg, _torch(p0), _torch(g), TO.init_state(_torch(p0)))
    monkeypatch.setattr(TO, "CHUNK", 1000)
    sliced = TO.update(cfg, _torch(p0), _torch(g), TO.init_state(_torch(p0)))
    for x, y in zip(TO.tree_leaves((whole[0], whole[1].m, whole[1].v)),
                    TO.tree_leaves((sliced[0], sliced[1].m, sliced[1].v))):
        assert torch.equal(x, y)


def test_fused_multiply_add_and_square_root_are_correctly_rounded():
    g = torch.Generator().manual_seed(6)
    a, b = torch.randn(5000, generator=g), torch.randn(5000, generator=g)
    c = -(a * b)                              # unfused: exactly 0
    assert torch.equal(TO._fma(c, a, b), fma_f32(c, a, b))
    assert (TO._fma(c, a, b) != 0).any()
    x = torch.rand(5000, generator=g) * 1e3
    want = np.sqrt(x.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(TO._sqrt(x).numpy(), want)
