"""The PyTorch port's float modes (``ms_float``, ``rh2``) against the JAX
package: the f32 evaluation orders of ``core/f32order.py``, the float
detection and quantization, the cheap phase, ``map_chunk`` and the
launcher, and the backend plan stage by stage.  Tolerance: exact.

The reference is the JAX code as its chunk program compiles it (under
``jax.jit``, on the CPU): XLA fixes the order of its f32 sums, emits rsqrt
as RSQRTPS plus two Newton steps, and contracts multiply-adds, and the port
evaluates the same sequence of f32 operations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import events as jev                          # noqa: E402
from repro.core import pipeline as jpipe                      # noqa: E402
from repro.core import quantization as jquant                 # noqa: E402
from repro.core import stages as jstages                      # noqa: E402
from repro.core.index import index_arrays as jax_index_arrays  # noqa: E402
from repro.launch import map_reads as jax_map_reads           # noqa: E402
from repro_torch.core import MarsConfig, events, f32order     # noqa: E402
from repro_torch.core import map_chunk, pipeline, quantization  # noqa: E402
from repro_torch.core import stages                           # noqa: E402
from repro_torch.core.index import index_arrays, index_from_numpy  # noqa: E402
from repro_torch.launch import map_reads                      # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
FIELDS = ("t_start", "score", "mapped", "n_events")
FLOAT_MODES = ("ms_float", "rh2")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _cpu_name():
    import platform
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


@pytest.fixture(scope="module")
def rsqrtps_host():
    """The premise of float parity: this CPU's RSQRTPS (under XLA's
    ``jax.lax.rsqrt``) returns the codes of ``f32order._RSQRTPS_STEPS``,
    read on an Intel core.  Other x86 cores (AMD's among them) may return
    other bits; the port's float modes then cannot equal the reference on
    this host, and the tests say so instead of showing parity diffs."""
    cells = np.arange(2048, dtype=np.uint32)
    exp = np.where(cells < 1024, 127, 128).astype(np.uint32)
    x = ((exp << 23) | ((cells % 1024) << 13)).view(np.float32)
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x)).view(np.uint32)
    got = f32order.rsqrt(torch.from_numpy(x)).numpy().view(np.uint32)
    if (got != want).any():
        pytest.fail(f"this CPU ({_cpu_name()}) computes rsqrt with an "
                    f"RSQRTPS whose codes differ from f32order's table "
                    f"(read on an Intel core) at {int((got != want).sum())}"
                    f" of {cells.size} cells: float-mode parity with the "
                    f"JAX package needs such a host", pytrace=False)


def test_host_rsqrtps_is_the_tables(rsqrtps_host):
    """Fails, naming the CPU, where the float-parity premise is false."""


@pytest.fixture(scope="module")
def s(small_ref, small_reads, rsqrtps_host):
    """The conftest reference and reads, with a 2^10-bucket index."""
    cfg_j = JaxConfig(hash_bits=10)
    cfg_t = MarsConfig(hash_bits=10)
    jidx = jax_build_index(small_ref.events_concat, small_ref.n_events,
                           cfg_j)
    tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                            jidx.n_ref_events, cfg_t)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, sig=small_reads.signals[:8],
                jarr=jax_index_arrays(jidx), tarr=index_arrays(tidx, "cpu"))


# --------------------------------------------------------------------------- #
# f32 evaluation orders
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [8192, 5000, 4097, 2049, 1024, 1000, 300,
                               257, 65, 16, 5])
def test_prefix_sum_is_xlas_blocked_scan(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((32, n)) * 3).astype(np.float32)
    want = jax.jit(jax.vmap(jnp.cumsum))(x)
    _eq(f32order.prefix_sum(torch.from_numpy(x)), want, f"n={n}")
    # not the sequential scan: the order is what makes it exact
    if n >= 300:
        seq = np.cumsum(x, axis=1, dtype=np.float32)
        assert (seq != np.asarray(want)).any()


@pytest.mark.parametrize("n", [40_000, 12_345, 4096, 1025, 193, 192, 100,
                               96, 33, 32, 7])
def test_tree_sum_is_xlas_windowed_reduction(n):
    rng = np.random.default_rng(100 + n)
    x = (rng.standard_normal((64, n)) * 3).astype(np.float32)
    _eq(f32order.tree_sum(torch.from_numpy(x)),
        jax.jit(jax.vmap(jnp.sum))(x), f"n={n}")


def test_rsqrt_is_xlas_approximation_and_newton_steps(rsqrtps_host):
    """Every RSQRTPS table cell of [1, 4) at 128 mantissas each, random
    bit patterns over all exponents, and the special values."""
    rng = np.random.default_rng(7)
    cells = np.arange(2048, dtype=np.uint32)
    base = np.where(cells < 1024, 127 << 23, 128 << 23).astype(np.uint32)
    low = rng.integers(0, 1 << 13, size=(2048, 128), dtype=np.uint32)
    bits = (base[:, None] | ((cells % 1024)[:, None] << 13) | low).ravel()
    rand = rng.integers(0, 1 << 32, size=1 << 16, dtype=np.uint64)
    special = np.array([0.0, -0.0, 1e-40, -1e-40, -1.0, np.inf, -np.inf,
                        1.17549435e-38, 3.4e38, 1e-6], np.float32)
    x = np.concatenate([bits.view(np.float32),
                        rand.astype(np.uint32).view(np.float32),
                        np.tile(special, 8)])
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    got = f32order.rsqrt(torch.from_numpy(x)).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:4], got[~same][:4], want[~same][:4])


# --------------------------------------------------------------------------- #
# Detection and quantization
# --------------------------------------------------------------------------- #
def _normalized(sig):
    return np.array(jax.jit(jev.robust_normalize)(jnp.asarray(sig)))


@pytest.mark.parametrize("w", [3, 4, 5])
def test_tstat_float(s, w):
    x = _normalized(s["sig"])
    xq = np.array(jev.dequantize_fixed(jev.quantize_signal_fixed(x, 8), 8))
    for inp in (x, xq):
        want = jax.jit(jax.vmap(lambda r: jev.tstat_float(r, w)))(inp)
        _eq(events.tstat_float(torch.from_numpy(inp), w), want, f"w={w}")


def test_segment_means_reference_float():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 500)).astype(np.float32)
    b = rng.random((16, 500)) < 0.2
    want = jax.jit(jax.vmap(
        lambda r, c: jev.segment_means_reference(r, c, 480, 64)))(x, b)
    got = events.segment_means_reference(torch.from_numpy(x),
                                         torch.from_numpy(b), 480, 64)
    for g, w, n in zip(got, want, ("means", "n_events", "counts")):
        _eq(g, w, n)


@pytest.mark.parametrize("mode", FLOAT_MODES)
def test_detect_events_float(s, mode):
    cfg_j, cfg_t = s["cfg_j"].with_mode(mode), s["cfg_t"].with_mode(mode)
    want = jax.jit(lambda x: jev.detect_events_batch(x, cfg_j))(
        jnp.asarray(s["sig"]))
    got = events.detect_events(torch.from_numpy(s["sig"]), cfg_t)
    for g, w, n in zip(got, want, ("means", "n_events", "counts")):
        _eq(g, w, n)


@pytest.mark.parametrize("mode", FLOAT_MODES)
def test_quantize_events_float(s, mode):
    cfg_j, cfg_t = s["cfg_j"].with_mode(mode), s["cfg_t"].with_mode(mode)
    rng = np.random.default_rng(11)
    ev = (rng.standard_normal((32, 192)) * 2 + 0.3).astype(np.float32)
    valid = np.arange(192)[None] < rng.integers(0, 193, size=(32, 1))
    want = jax.jit(jax.vmap(lambda e, v: jquant.quantize_events(
        e, v, cfg_j)))(ev, valid)
    _eq(quantization.quantize_events(torch.from_numpy(ev),
                                     torch.from_numpy(valid), cfg_t), want)


# --------------------------------------------------------------------------- #
# Cheap phase, chunk program, launcher
# --------------------------------------------------------------------------- #
def _eq_cheap(got, want):
    for g, w, n in zip(got[:3], want[:3], ("q_pos", "t_pos", "hit_valid")):
        _eq(g, w, n)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _eq(got[3][k], want[3][k], f"counter {k}")


@pytest.mark.parametrize("mode", FLOAT_MODES)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_cheap_phase_float(s, mode, use_kernels):
    cfg_j, cfg_t = s["cfg_j"].with_mode(mode), s["cfg_t"].with_mode(mode)
    plan_j = jstages.resolve_plan(cfg_j, jstages.REFERENCE)
    want = jax.jit(lambda x: jpipe.cheap_phase(x, s["jarr"], cfg_j, plan_j))(
        jnp.asarray(s["sig"]))
    plan_t = stages.resolve_plan(
        cfg_t, stages.KERNELS if use_kernels else stages.REFERENCE)
    _eq_cheap(pipeline.cheap_phase(torch.from_numpy(s["sig"]), s["tarr"],
                                   cfg_t, plan_t), want)


@pytest.mark.parametrize("mode", FLOAT_MODES)
def test_map_chunk_float(s, mode):
    """Every MapOutput field and counter; pad rows masked (n_valid)."""
    cfg_j, cfg_t = s["cfg_j"].with_mode(mode), s["cfg_t"].with_mode(mode)
    want = jpipe.map_chunk(jnp.asarray(s["sig"]), s["jarr"], cfg_j,
                           use_kernels=False, n_valid=7)
    got = map_chunk(torch.from_numpy(s["sig"]), s["tarr"], cfg_t,
                    use_kernels=True, n_valid=7)
    for f in FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)
    assert set(got.counters) == set(stages.CHUNK_COUNTER_SCHEMA)
    for k in stages.CHUNK_COUNTER_SCHEMA:
        assert int(got.counters[k]) == int(want.counters[k]), k
    assert int(got.counters["n_anchors_postvote"]) > 0


@pytest.mark.parametrize("mode", FLOAT_MODES)
def test_map_reads_launcher_float_matches_jax(tmp_path, capsys, mode,
                                              rsqrtps_host):
    """The same accuracy line and PAF as the JAX launcher, 64 D1 reads."""
    def launch(main, tag, extra=()):
        paf = tmp_path / f"{tag}.paf"
        main(["--dataset", "D1", "--reads", "64", "--mode", mode,
              "--workdir", str(tmp_path / tag), "--out", str(paf), *extra])
        acc = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("[accuracy]")]
        return acc, paf.read_text()
    want = launch(jax_map_reads.main, "jax")
    got = launch(map_reads.main, "torch", ("--use-kernels", "--device",
                                           "cpu"))
    assert got[0] and got == want


# --------------------------------------------------------------------------- #
# Backend plans
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode,over", [("ms_fixed", {}), ("ms_float", {}),
                                       ("rh2", {}),
                                       ("ms_fixed", {"tstat_window": 13})])
def test_resolve_plan_matches_jax(mode, over):
    """Stage by stage, the kernels plan resolves as the JAX ``pallas``
    plan: detect only under event_detect's gate, query always, sort and
    dp always, the fused kernel only under cheap_fused's gate; quantize,
    seed, vote and finalize stay on the reference in both."""
    cfg_j = JaxConfig(hash_bits=10).with_mode(mode).replace(**over)
    cfg_t = MarsConfig(hash_bits=10).with_mode(mode).replace(**over)
    plan_j = jstages.resolve_plan(cfg_j, jstages.PALLAS)
    plan_t = stages.resolve_plan(cfg_t, stages.KERNELS)
    name = {jstages.PALLAS: stages.KERNELS,
            jstages.REFERENCE: stages.REFERENCE}
    assert plan_t == tuple((s, name[b]) for s, b in plan_j)
    assert all(dict(plan_j)[k] == jstages.REFERENCE
               for k in ("quantize", "seed", "vote", "finalize"))
    fused_j = jstages.fused_cheap_backend(plan_j, cfg_j)
    fused_t = stages.fused_cheap_backend(plan_t, cfg_t)
    assert (fused_t is not None) == (fused_j is not None)
    assert fused_t is None or fused_t.name == stages.KERNELS
