"""The kernel packages' entry points under the JAX package's names
(``sort_batch``, ``sort1d``, ``sort_ref``, ``dp_read``, ``cheap_fused_ref``,
``event_detect_ref``), each held bit for bit against the JAX function of
that name on seeded inputs; the Pallas ones run in interpret mode on the
CPU, as the JAX package's own kernel tests run them, and the float
detection under jit, as the JAX pipeline compiles it.  On the CPU the
port's wrappers take their kernels' plain versions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core.index import build_index as jax_build_index   # noqa: E402
from repro.core.index import index_arrays as jax_index_arrays  # noqa: E402
from repro.kernels.bitonic_sort import ops as jsort           # noqa: E402
from repro.kernels.bitonic_sort import ref as jsort_ref       # noqa: E402
from repro.kernels.chain_dp import ops as jdp                 # noqa: E402
from repro.kernels.cheap_fused import ref as jfused_ref       # noqa: E402
from repro.kernels.event_detect import ref as jdetect_ref     # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core import MarsConfig                       # noqa: E402
from repro_torch.core.index import index_arrays, index_from_numpy  # noqa: E402
from repro_torch.kernels import bitonic_sort, chain_dp        # noqa: E402
from repro_torch.kernels.bitonic_sort import ref as sort_ref  # noqa: E402
from repro_torch.kernels.cheap_fused import ref as fused_ref  # noqa: E402
from repro_torch.kernels.event_detect import ref as detect_ref  # noqa: E402

INT_MAX = 0x7FFFFFFF
PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        msg, got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _keys(rng, shape):
    k = rng.integers(-(1 << 31), 1 << 31, size=shape,
                     dtype=np.int64).astype(np.int32)
    k[..., rng.random(shape[-1]) < 0.3] = INT_MAX
    k[..., :4] = k[..., 4:8]                      # duplicates
    return k


@pytest.mark.parametrize("B,L", [(3, 100), (2, 512), (1, 3072)])
def test_sort_batch_equals_jax(B, L):
    k = _keys(np.random.default_rng(B * L), (B, L))
    _eq(bitonic_sort.sort_batch(torch.from_numpy(k)),
        jsort.sort_batch(jnp.asarray(k)), "sort_batch")


@pytest.mark.parametrize("L", [1, 130, 4096])
def test_sort1d_equals_jax(L):
    k = _keys(np.random.default_rng(L), (max(L, 8),))[:L]
    _eq(bitonic_sort.sort1d(torch.from_numpy(k)),
        jsort.sort1d(jnp.asarray(k)), "sort1d")


@pytest.mark.parametrize("shape", [(9,), (2, 33), (2, 3, 16)])
def test_sort_ref_equals_jax(shape):
    k = _keys(np.random.default_rng(len(shape)), shape)
    _eq(sort_ref.sort_ref(torch.from_numpy(k)),
        jsort_ref.sort_ref(jnp.asarray(k)), "sort_ref")


@pytest.mark.parametrize("A,band", [(64, 32), (128, 16)])
def test_dp_read_equals_jax(A, band):
    rng = np.random.default_rng(A + band)
    t = np.sort(rng.integers(0, 4000, size=A)).astype(np.int32)
    q = rng.integers(0, 180, size=A).astype(np.int32)
    order = np.lexsort((q, t))
    q, t = q[order], t[order]
    v = rng.random(A) < 0.8
    cfg_j = JaxConfig(max_anchors=A, chain_band=band)
    cfg_t = MarsConfig(max_anchors=A, chain_band=band)
    wf, wd = jdp.dp_read(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v),
                         cfg_j)
    gf, gd = chain_dp.dp_read(*(torch.from_numpy(x) for x in (q, t, v)),
                              cfg_t)
    _eq(gf, wf, "f")
    _eq(gd, wd, "diag0")
    # vmap-safe in the reference: the per-read view of a batch
    jf, _ = jax.vmap(lambda a, b, c: jdp.dp_read(a, b, c, cfg_j))(
        jnp.asarray(q[None]), jnp.asarray(t[None]), jnp.asarray(v[None]))
    _eq(gf, jf[0], "f vs vmapped")


@pytest.fixture(scope="module")
def mapping():
    cfg_j = JaxConfig(hash_bits=12).with_mode("ms_fixed")
    cfg_t = MarsConfig(hash_bits=12).with_mode("ms_fixed")
    ref = simulate.make_reference(6_000, seed=9)
    reads = simulate.sample_reads(ref, 5, signal_len=cfg_t.signal_len,
                                  seed=10, junk_frac=0.3)
    jidx = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
    tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                            jidx.n_ref_events, cfg_t)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, sig=reads.signals,
                jarr=jax_index_arrays(jidx), tarr=index_arrays(tidx, "cpu"))


def test_cheap_fused_ref_equals_jax(mapping):
    m = mapping
    want = jfused_ref.cheap_fused_ref(jnp.asarray(m["sig"]), m["jarr"],
                                      m["cfg_j"])
    got = fused_ref.cheap_fused_ref(torch.from_numpy(m["sig"]), m["tarr"],
                                    m["cfg_t"])
    for name, g, w in zip(("q_pos", "t_pos", "hit_valid"), got[:3],
                          want[:3]):
        _eq(g, w, name)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _eq(got[3][k], want[3][k], f"counter {k}")


@pytest.mark.parametrize("mode", ["ms_fixed", "ms_float", "rh2"])
def test_event_detect_ref_equals_jax(mapping, mode):
    sig = mapping["sig"]
    cfg_j = JaxConfig().with_mode(mode)
    cfg_t = MarsConfig().with_mode(mode)
    # as the reference's pipeline runs it, under jit (op by op, XLA fuses
    # the float modes' normalization differently: the port's parity rule)
    wm, wn = jax.jit(lambda x: jdetect_ref.event_detect_ref(x, cfg_j))(
        jnp.asarray(sig))
    gm, gn = detect_ref.event_detect_ref(torch.from_numpy(sig), cfg_t)
    _eq(gn, wn, "n_events")
    _eq(gm, wm, "means")
