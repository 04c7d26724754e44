"""The LM training substrate's host side, port against the JAX package,
exact: the token stream's batches and state, the step monitor's events
under a fake clock, and checkpoints in the reference's on-disk format
(the ``.npy`` files of a tree equal byte for byte, restores across the
packages in both directions, a step without ``COMMIT`` ignored,
corruption raising, ``keep``).
"""
import dataclasses
import hashlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.data import tokens as JT  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro.train import monitor as JMON  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.data import tokens as TT  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import monitor as TMON  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402


# --------------------------------------------------------------------------- #
# The token stream
# --------------------------------------------------------------------------- #
@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_ctx", [0, 3])
def test_token_stream_batches_equal_reference(n_ctx):
    kw = dict(vocab=512, batch=4, seq=33, seed=7, n_ctx=n_ctx, d_model=16)
    tj, tt = JT.TokenStream(**kw), TT.TokenStream(**kw)
    for _ in range(5):
        bj, bt = tj.next_batch(), tt.next_batch()
        assert sorted(bj) == sorted(bt) == sorted(
            ["tokens", "labels"] + (["ctx"] if n_ctx else []))
        for k in bj:
            assert bt[k].dtype == bj[k].dtype and bt[k].shape == bj[k].shape
            np.testing.assert_array_equal(bt[k], bj[k])
        assert tt.state.as_dict() == tj.state.as_dict()


def test_token_stream_resumes_from_its_state():
    a = TT.TokenStream(256, 2, 16, seed=3)
    for _ in range(3):
        a.next_batch()
    saved = json.loads(json.dumps(a.state.as_dict()))
    b = TT.TokenStream(256, 2, 16, seed=99)
    b.state = TT.TokenStreamState.from_dict(saved)
    j = JT.TokenStream(256, 2, 16, seed=3, start_step=3)
    for _ in range(2):
        x, y, z = a.next_batch(), b.next_batch(), j.next_batch()
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["tokens"], z["tokens"])
    assert dataclasses.asdict(b.state) == dataclasses.asdict(j.state)


# --------------------------------------------------------------------------- #
# The step monitor, driven by a fake clock
# --------------------------------------------------------------------------- #
def test_monitor_events_equal_reference_under_a_fake_clock(monkeypatch):
    # step times: compile steps, a steady run, two stragglers, a recovery
    steps = [3.0, 1.0, 0.9, 0.1, 0.1, 0.11, 0.3, 0.1, 0.09, 0.5, 0.12, 0.1]
    out = {}
    for name, mod in (("jax", JMON), ("port", TMON)):
        clock = iter(np.cumsum([0.0] + [x for s in steps for x in (s, 0.0)]))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        seen = []
        mon = mod.StepMonitor(on_straggler=seen.append)
        dts = []
        for _ in steps:
            mon.start()
            dts.append(mon.stop())
        out[name] = dict(dts=dts, ema=mon.ema, history=mon.history,
                         events=[dataclasses.asdict(e) for e in mon.events],
                         seen=[dataclasses.asdict(e) for e in seen],
                         tps=mon.tokens_per_sec(1024))
    assert out["port"] == out["jax"]
    assert [e["step"] for e in out["port"]["events"]] == [7, 10]
    assert TMON.StepMonitor().tokens_per_sec(1024) == 0.0


# --------------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------------- #
SPEC = {"blocks": {"w": ((2, 8, 12), "bf16"), "router": ((8, 4), "f32")},
        "embed": ((16, 8), "bf16"), "norm": ((8,), "bf16")}
_UPDATE = jax.jit(lambda p, g, s: JO.update(
    JO.AdamWConfig(warmup_steps=2, total_steps=10), p, g, s))


def _trees(seed=0):
    """The same (params, AdamWState) as the reference's tree and the
    port's, one update in (so the moments and the step are not zero)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(v) for k, v in spec.items()}
        x = rng.normal(0, 1, spec[0]).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if spec[1] == "bf16" else x

    p, g = draw(SPEC), draw(SPEC)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pj, sj, _ = _UPDATE(pj, jax.tree_util.tree_map(jnp.asarray, g),
                        JO.init_state(pj))
    return (pj, sj), _port(pj, sj)


def _port(pj, sj):
    def t(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    conv = lambda tree: jax.tree_util.tree_map(t, tree)
    return conv(pj), TO.AdamWState(step=t(sj.step), m=conv(sj.m),
                                   v=conv(sj.v))


def _abstract(tree):
    return TO.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                             device="meta"), tree)


def _abstract_state(pt):
    return (_abstract(pt[0]), TO.abstract_state(pt[0]))


def _equal(got, want_port):
    lg, lw = TO.tree_leaves(got), TO.tree_leaves(want_port)
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_files_equal_reference_byte_for_byte(tmp_path):
    tj, tt = _trees()
    dj = JC.save(tmp_path / "jax", 3, tj, data_state={"seed": 1, "step": 3})
    dt = TC.save(tmp_path / "port", 3, tt, data_state={"seed": 1, "step": 3})
    mj = json.loads((dj / "manifest.json").read_text())
    mt = json.loads((dt / "manifest.json").read_text())
    assert mt == mj               # paths, shapes, dtypes, files, sha256
    assert [e["path"] for e in mt["leaves"]][:3] == [
        "0/blocks/router", "0/blocks/w", "0/embed"]
    assert "1/.step" in [e["path"] for e in mt["leaves"]]
    for e in mt["leaves"]:
        assert ((dt / e["file"]).read_bytes()
                == (dj / e["file"]).read_bytes()), e["path"]
        assert hashlib.sha256((dt / e["file"]).read_bytes()).hexdigest() \
            == e["sha256"]
    assert sorted(p.name for p in dt.iterdir()) == sorted(
        p.name for p in dj.iterdir())


def test_port_restores_a_reference_checkpoint(tmp_path):
    tj, tt = _trees(1)
    JC.save(tmp_path, 5, tj, data_state={"seed": 0, "step": 5},
            extra={"note": "x"})
    tree, step, ds, extra = TC.restore(tmp_path, _abstract_state(tt),
                                       device="cpu")
    assert (step, ds, extra) == (5, {"seed": 0, "step": 5}, {"note": "x"})
    assert isinstance(tree[1], TO.AdamWState)
    _equal(tree, tt)


def test_reference_restores_a_port_checkpoint(tmp_path):
    tj, tt = _trees(2)
    TC.save(tmp_path, 7, tt, data_state={"seed": 2, "step": 7})
    abs_j = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tj)
    tree, step, ds, _ = JC.restore(tmp_path, abs_j)
    assert (step, ds) == (7, {"seed": 2, "step": 7})
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(tj)):
        assert a.dtype == b.dtype
        assert a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_checkpoint_without_commit_is_ignored_and_keep_bounds_it(tmp_path):
    _, tt = _trees(3)
    for s in (1, 2, 3, 4):
        TC.save(tmp_path, s, tt, keep=3)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_000000002", "step_000000003", "step_000000004"]
    (tmp_path / "step_000000004" / "COMMIT").unlink()
    assert TC.latest_step(tmp_path) == JC.latest_step(tmp_path) == 3
    (tmp_path / ".tmp_step_000000009_1").mkdir()
    TC.save(tmp_path, 5, tt, keep=3)
    assert not list(tmp_path.glob(".tmp_step_*"))
    assert TC.latest_step(tmp_path) == 5
    assert TC.latest_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        TC.restore(tmp_path / "missing", _abstract_state(tt), device="cpu")


def test_checkpoint_corruption_raises(tmp_path):
    _, tt = _trees(4)
    d = TC.save(tmp_path, 1, tt)
    f = d / "arr_00001.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        TC.restore(tmp_path, _abstract_state(tt), device="cpu")
    tree, _, _, _ = TC.restore(tmp_path, _abstract_state(tt), validate=False,
                               device="cpu")
    assert not torch.equal(TO.tree_leaves(tree)[1], TO.tree_leaves(tt)[1])
    bad = (_abstract(tt[0]), TO.abstract_state(TO.tree_map(
        lambda x: torch.empty((3,), dtype=x.dtype, device="meta"), tt[0])))
    with pytest.raises(ValueError, match="shape"):
        TC.restore(tmp_path, bad, device="cpu", validate=False)
