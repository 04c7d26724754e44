"""The PyTorch port's offline side against the JAX package: index planes,
simulated reads and seed keys are identical (exact)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import hashing as jax_hashing                 # noqa: E402
from repro.signal import simulate as jax_simulate             # noqa: E402
from repro_torch.core import MarsConfig, build_index          # noqa: E402
from repro_torch.core import hashing, index as tindex         # noqa: E402
from repro_torch.signal import datasets, simulate             # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")


@pytest.fixture(scope="module")
def ref():
    return simulate.make_reference(6_000, seed=9)


@pytest.mark.parametrize("radius", [0, 2])
def test_build_index_planes_identical(ref, radius):
    cfg_j = JaxConfig(hash_bits=12, minimizer_radius=radius)
    cfg_t = MarsConfig(hash_bits=12, minimizer_radius=radius)
    want = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
    got = build_index(ref.events_concat, ref.n_events, cfg_t)
    for name in PLANES:
        w, g = getattr(want, name), getattr(got, name)
        assert w.dtype == g.dtype, name
        assert w.tobytes() == g.tobytes(), name
    assert want.entries_packed.tobytes() == got.entries_packed.tobytes()
    assert (got.n_entries, got.n_ref_events, got.nbytes) == (
        want.n_entries, want.n_ref_events, want.nbytes)


def test_index_from_numpy_and_arrays(ref):
    cfg_j, cfg_t = JaxConfig(hash_bits=12), MarsConfig(hash_bits=12)
    want = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
    got = tindex.index_from_numpy(
        *(getattr(want, n) for n in PLANES), want.n_ref_events, cfg_t)
    assert got.entries_packed.tobytes() == want.entries_packed.tobytes()
    arrays = tindex.index_arrays(got, "cpu")
    assert set(arrays) == {"bucket_start", "entries_packed"}
    assert arrays["bucket_start"].dtype == torch.int32
    assert tuple(arrays["bucket_start"].shape) == (cfg_t.n_buckets + 1,)
    assert tuple(arrays["entries_packed"].shape) == (2, want.n_entries)
    np.testing.assert_array_equal(arrays["entries_packed"].numpy(),
                                  want.entries_packed)


def test_simulated_reads_identical():
    want_ref = jax_simulate.make_reference(4_000, seed=5)
    got_ref = simulate.make_reference(4_000, seed=5)
    np.testing.assert_array_equal(got_ref.events_concat,
                                  want_ref.events_concat)
    want = jax_simulate.sample_reads(want_ref, 12, signal_len=1024, seed=6,
                                     junk_frac=0.25)
    got = simulate.sample_reads(got_ref, 12, signal_len=1024, seed=6,
                                junk_frac=0.25)
    for f in ("signals", "true_pos", "true_strand", "n_bases", "mappable"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("radius", [0, 2])
def test_pack_seeds_identical(radius):
    cfg_j = JaxConfig(minimizer_radius=radius)
    cfg_t = MarsConfig(minimizer_radius=radius)
    rng = np.random.default_rng(radius + 1)
    R, E = 5, cfg_t.max_events
    sym = rng.integers(0, cfg_t.quant_levels, size=(R, E)).astype(np.int32)
    n_ev = np.array([0, 3, 7, 100, E], np.int32)

    def jax_one(s, n):
        k, v = jax_hashing.pack_seeds(s, n, cfg_j)
        return k, jax_hashing.minimizer_mask(k, v, radius)
    wk, wv = jax.vmap(jax_one)(jnp.asarray(sym), jnp.asarray(n_ev))
    gk, gv = hashing.pack_seeds(torch.from_numpy(sym), torch.from_numpy(n_ev),
                                cfg_t)
    gv = hashing.minimizer_mask(gk, gv, radius)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk).astype(np.int64))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_mix32_matches_numpy_twin():
    x = np.random.default_rng(0).integers(0, 2**32, size=4096,
                                          dtype=np.uint64)
    got = hashing.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, hashing.mix32_np(x).astype(np.int64))


def test_build_index_guards():
    cfg = MarsConfig(hash_bits=12)
    with pytest.raises(ValueError, match="double genome"):
        build_index(np.zeros(1 << tindex.T_BITS, np.float32), 1 << 22, cfg)
    with pytest.raises(ValueError, match="max_events"):
        build_index(np.zeros(64, np.float32), 32, cfg.replace(max_events=300))
    with pytest.raises(ValueError, match="does not fit"):
        tindex.pack_entries(np.zeros(2, np.uint32), np.zeros(2, np.int32),
                            np.array([1, cfg.n_buckets], np.int32), cfg)


def test_dataset_configs_match():
    from repro.signal import datasets as jax_datasets
    for key, spec in datasets.DATASETS.items():
        want = jax_datasets.config_for(jax_datasets.DATASETS[key])
        got = datasets.config_for(spec)
        assert got.__dict__ == want.__dict__, key
