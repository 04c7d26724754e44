"""The port's clipping gathers (``kernels/pluto_lookup``; on the CPU their
plain version) against the JAX ``pluto_lookup`` kernels in interpret mode:
1-D tables and (W, N) packed rows, sizes that are not multiples of the TPU
blocks (BQ = 256 queries, BT = 512 entries), out-of-range indices,
multi-dimensional indices and other integer dtypes.  Tolerance: exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels.pluto_lookup import ops as jax_ops         # noqa: E402
from repro_torch import kernels as K                          # noqa: E402
from repro_torch.core import seeding                          # noqa: E402
from repro_torch.kernels.pluto_lookup import ops              # noqa: E402


def _both(table, idx):
    want = np.asarray(jax_ops.lookup(jnp.asarray(table), jnp.asarray(idx)))
    got = ops.lookup(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("n,q", [(16, 5), (100, 37), (512, 256),
                                 (1000, 513), (1025, 300), (4096, 1)])
def test_lookup_1d(n, q):
    rng = np.random.default_rng(n * 1000 + q)
    table = rng.integers(-2**31, 2**31, size=n,
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(-3, n + 3, size=q).astype(np.int32)
    assert _both(table, idx).shape == (q,)


@pytest.mark.parametrize("n,q,w", [(16, 5, 2), (700, 513, 2), (1000, 77, 3),
                                   (2048, 300, 1)])
def test_lookup_packed_rows(n, q, w):
    rng = np.random.default_rng(n + q + w)
    table = rng.integers(-2**31, 2**31, size=(w, n),
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(-4, n + 4, size=q).astype(np.int32)
    assert _both(table, idx).shape == (w, q)
    idx2 = rng.integers(-4, n + 4, size=(3, 4, 5)).astype(np.int32)
    assert _both(table, idx2).shape == (w, 3, 4, 5)


def test_lookup_2d_indices_and_int16_table():
    rng = np.random.default_rng(1)
    table = rng.integers(-2**15, 2**15, size=300).astype(np.int16)
    idx = rng.integers(-10, 310, size=(4, 33)).astype(np.int32)
    assert _both(table, idx).shape == (4, 33)


def test_query_index_with_lookup_equals_default_gather():
    """``seeding.query_index``'s two gathers through the wrapper: the
    stacked (2, R, E) bucket offsets and the (2, R, E, H) entry rows."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(np.sort(rng.integers(0, 5000, size=1025))
                             .astype(np.int32))
    rows = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, 5000),
                                         dtype=np.int64).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 1024, size=(3, 192))
                         .astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 5100, size=(3, 192, 16))
                           .astype(np.int32))
    for tab, i in ((table, torch.stack([b, b + 1])), (rows, idx)):
        assert torch.equal(ops.lookup(tab, i), seeding._take_clip(tab, i))


def test_lookup_rejects_and_counts_no_cpu_launch():
    K.reset_launches()
    with pytest.raises(ValueError):
        ops.lookup(torch.zeros((2, 2, 2), dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.lookup(torch.zeros((0,), dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.lookup(torch.zeros(4), torch.zeros(3, dtype=torch.int32))
    # 64-bit values would not survive the kernel's int32 words: refused on
    # every device, so the CPU and the card never answer differently
    for table, idx in ((torch.arange(4), torch.zeros(3, dtype=torch.int32)),
                       (torch.arange(4, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int64))):
        with pytest.raises(TypeError, match="at most 32 bits"):
            ops.lookup(table, idx)
    ops.lookup(torch.arange(4, dtype=torch.int32),
               torch.zeros(3, dtype=torch.int32))
    assert K.LAUNCHES["pluto_lookup"] == K.LAUNCHES["pluto_lookup_rows"] == 0
