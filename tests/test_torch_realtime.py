"""The port's early-termination mapping (``core/realtime.py``) against the
JAX package's: ``map_realtime`` in all three modes through both port plans
(on the CPU: the kernel wrappers take their plain versions) equals the JAX
package's reference plan on the same reads — decisions, scores, samples
consumed and ladder stage — and ``stage_cfg`` equals the reference's field
by field.  Tolerance: exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import realtime as jrt                        # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core import MarsConfig                       # noqa: E402
from repro_torch.core import realtime                         # noqa: E402
from repro_torch.core.index import index_from_numpy           # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
MODES = ("ms_fixed", "ms_float", "rh2")
FIELDS = ("t_start", "score", "mapped", "samples_used", "stage_of")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    ref = simulate.make_reference(8_000, seed=7)
    reads = simulate.sample_reads(ref, 14, signal_len=1024, seed=8,
                                  junk_frac=0.2)
    junk = np.random.default_rng(12).normal(100, 15, (3, 1024))
    sig = np.concatenate([reads.signals, junk.astype(np.float32)])
    return ref, sig, {}


def _jax_run(data, mode):
    ref, sig, cache = data
    if mode not in cache:
        cfg_j = JaxConfig(hash_bits=12).with_mode(mode)
        jidx = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
        cfg_t = MarsConfig(hash_bits=12).with_mode(mode)
        tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                                jidx.n_ref_events, cfg_t)
        cache[mode] = (tidx, cfg_t,
                       jrt.map_realtime(sig, jidx, cfg_j, chunk=8))
    return cache[mode]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_map_realtime_equals_jax(data, mode, use_kernels):
    tidx, cfg_t, want = _jax_run(data, mode)
    got = realtime.map_realtime(data[1], tidx, cfg_t, chunk=8,
                                use_kernels=use_kernels, device="cpu")
    assert isinstance(got, realtime.RealtimeResult)
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.mean_fraction_used == want.mean_fraction_used
    # the ladder did decide early for some reads and ran others to the end
    assert (got.stage_of >= 0).any() and (got.samples_used == 1024).any()


@pytest.mark.parametrize("length", [64, 160, 256, 512, 768, 1000, 1024,
                                    2048])
@pytest.mark.parametrize("mode", MODES)
def test_stage_cfg_equals_jax(mode, length):
    base_j = JaxConfig(hash_bits=12, max_events=150).with_mode(mode)
    base_t = MarsConfig(hash_bits=12, max_events=150).with_mode(mode)
    for bj, bt in ((base_j, base_t),
                   (JaxConfig().with_mode(mode), MarsConfig().with_mode(mode))):
        want = dataclasses.asdict(jrt.stage_cfg(bj, length))
        got = dataclasses.asdict(realtime.stage_cfg(bt, length))
        assert got == want
        assert got["signal_len"] == length


def test_stage_cfg_shapes_of_the_default_ladder():
    """The shapes the serving ladder runs the kernels at."""
    cfg = MarsConfig()
    got = [(c.signal_len, c.max_events) for c in
           (realtime.stage_cfg(cfg, L) for L in (256, 512, 768, 1024))]
    assert got == [(256, 51), (512, 102), (768, 153), (1024, 192)]


def test_map_realtime_checks_its_ladder(data):
    tidx, cfg_t, _ = _jax_run(data, "ms_fixed")
    with pytest.raises(AssertionError):
        realtime.map_realtime(data[1], tidx, cfg_t, stages=(256, 512),
                              device="cpu")
