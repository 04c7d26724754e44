"""The PyTorch port's chaining phase against the JAX package: the sort and
DP plain versions against the JAX Pallas kernels (interpret mode), and
every branch of ``chain_phase`` / ``_chain_outputs``.  Tolerance: exact."""
import fractions

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import chaining as jchain                     # noqa: E402
from repro.core import pipeline as jpipe                      # noqa: E402
from repro.core import stages as jstages                      # noqa: E402
from repro.kernels.bitonic_sort import ops as jsort_ops       # noqa: E402
from repro.kernels.bitonic_sort.bitonic_sort import bitonic_sort  # noqa: E402
from repro.kernels.chain_dp import ops as jdp_ops             # noqa: E402
from repro_torch.core import MarsConfig, chaining, pipeline, stages  # noqa: E402
from repro_torch.kernels.bitonic_sort import ops as sort_ops  # noqa: E402
from repro_torch.kernels.bitonic_sort.ref import sort_rows_ref  # noqa: E402
from repro_torch.kernels.chain_dp import ops as dp_ops        # noqa: E402
from repro_torch.kernels.chain_dp.ref import chain_dp_ref     # noqa: E402

INT_MAX = 0x7FFFFFFF


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


def _rows(rng, B, L):
    k = rng.integers(0, 1 << 31, size=(B, L), dtype=np.int64).astype(np.int32)
    k[:, rng.random(L) < 0.3] = INT_MAX           # invalid-anchor sentinels
    k[:, :4] = k[:, 4:8]                          # duplicates
    return k


@pytest.mark.parametrize("L", [128, 4096])
def test_sort_plain_equals_jax_bitonic(L):
    k = _rows(np.random.default_rng(L), 2, L)
    _eq(sort_rows_ref(torch.from_numpy(k)), bitonic_sort(jnp.asarray(k)))


@pytest.mark.parametrize("L", [37, 64, 3072])
def test_sort_wrapper_equals_jax_sort_batch(L):
    k = _rows(np.random.default_rng(L), 3, L)
    _eq(sort_ops.sort_rows(torch.from_numpy(k)),
        jsort_ops.sort_batch(jnp.asarray(k)))


def test_sort_wrapper_rejects_long_rows_and_bad_dtype():
    """Rows past one kernel block no longer raise: they take the counted
    ``torch.sort`` route, as ``sort_batch`` takes ``jnp.sort``.  A wrong
    dtype still raises."""
    from repro_torch import kernels as K
    K.reset_launches()
    k = _rows(np.random.default_rng(8193), 2, 8193)
    _eq(sort_ops.sort_rows(torch.from_numpy(k)),
        jsort_ops.sort_batch(jnp.asarray(k)))
    assert K.LAUNCHES["sort_rows_library"] == 1
    with pytest.raises(TypeError):
        sort_ops.sort_rows(torch.zeros((1, 8), dtype=torch.int64))


def _anchors(rng, R, A, t_range=4000, q_range=180, p_valid=0.8):
    t = np.sort(rng.integers(0, t_range, size=(R, A))).astype(np.int32)
    q = rng.integers(0, q_range, size=(R, A)).astype(np.int32)
    order = np.lexsort((q, t), axis=-1)
    t = np.take_along_axis(t, order, -1)
    q = np.take_along_axis(q, order, -1)
    v = rng.random((R, A)) < p_valid
    return q, t, v


@pytest.mark.parametrize("R,A,B", [(2, 64, 32), (3, 128, 32), (1, 512, 32),
                                   (2, 64, 8), (2, 128, 16)])
def test_chain_dp_plain_equals_jax_kernel(R, A, B):
    cfg_j = JaxConfig(max_anchors=A, chain_band=B)
    cfg_t = MarsConfig(max_anchors=A, chain_band=B)
    q, t, v = _anchors(np.random.default_rng(R * A + B), R, A)
    if R > 1:
        v[-1] = False                               # an all-invalid row
    wf, wd = jdp_ops.chain_dp(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v),
                              cfg_j)
    args = [torch.from_numpy(x) for x in (q, t, v)]
    gf, gd = dp_ops.chain_dp(*args, cfg_t)          # CPU -> plain version
    _eq(gf, wf, "f")
    _eq(gd, wd, "diag0")
    rf, rd = jax.vmap(lambda a, b, c: jchain.chain_dp(a, b, c, cfg_j))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(v))
    _eq(chain_dp_ref(*args, cfg_t)[0], rf, "f vs jax reference")
    _eq(gd, rd, "diag0 vs jax reference")


def _round_f32(x: fractions.Fraction) -> np.float32:
    """The f32 nearest to the exact rational x (ties to even)."""
    c = np.float32(float(x))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        d = abs(fractions.Fraction(float(cand)) - x)
        key = (d, int(np.array(cand).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(11)
    a = (rng.normal(size=3000) * 10).astype(np.float32)
    b = (-rng.random(3000)).astype(np.float32)
    c = rng.integers(0, 200, 3000).astype(np.float32)
    got = chaining.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(fractions.Fraction(float(x))
                                + fractions.Fraction(float(y))
                                * fractions.Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


def _chain_inputs(counts, seed=0, E=192, H=16):
    """(q_pos, t_pos, hit_valid, cnt) with counts[r] valid anchors in read r,
    half of them on one colinear run so chains form."""
    rng = np.random.default_rng(seed)
    R = len(counts)
    q = np.broadcast_to(np.arange(E, dtype=np.int32)[None, :, None],
                        (R, E, H)).copy()
    t = rng.integers(0, 30_000, size=(R, E, H)).astype(np.int32)
    v = np.zeros((R, E, H), bool)
    for r, c in enumerate(counts):
        slots = rng.choice(E * H, size=c, replace=False)
        v.reshape(R, -1)[r, slots] = True
        run = slots[: c // 2]
        e = run // H
        t.reshape(R, -1)[r, run] = 5_000 + 40 * r + e + rng.integers(0, 3, e.size)
    return q, t, v, v.sum((1, 2)).astype(np.int32)


def _cfgs(**kw):
    return JaxConfig(**kw), MarsConfig(**kw)


def _prims(cfg_j, cfg_t):
    jp = jstages.chain_primitives(
        jstages.resolve_plan(cfg_j, jstages.REFERENCE), cfg_j)
    tp = stages.chain_primitives(
        stages.resolve_plan(cfg_t, stages.KERNELS), cfg_t)
    return jp, tp


@pytest.mark.parametrize("counts,width", [([0, 5, 40, 64], 64),
                                          ([3, 100, 128, 0], 128),
                                          ([700, 300, 2, 0], None)])
@pytest.mark.parametrize("select", ["count", "topk"])
def test_chain_phase_each_width(counts, width, select):
    cfg_j, cfg_t = _cfgs(anchor_select=select)
    q, t, v, cnt = _chain_inputs(counts, seed=len(select) + max(counts))
    widths = pipeline._chain_widths(cfg_t, q.shape[1] * q.shape[2])
    assert next((w for w in widths if max(counts) <= w), None) == width
    jp, tp = _prims(cfg_j, cfg_t)
    want = jpipe.chain_phase(*(jnp.asarray(x) for x in (q, t, v, cnt)),
                             cfg_j, jp)
    got = pipeline.chain_phase(*(torch.from_numpy(x) for x in (q, t, v, cnt)),
                               cfg_t, tp)
    for g, w, n in zip(got, want, ("t_start", "score", "mapped")):
        _eq(g, w, n)
    assert bool(np.asarray(want[2]).any()), "no read mapped: weak test"


@pytest.mark.parametrize("counts,route", [
    ([0, 0, 0, 0], ("empty", 0, 0)),                # all empty
    ([0, 50, 0, 0], ("compact", 1, 64)),            # compacted
    ([9, 50, 0, 200], ("compact", 3, 192 * 16)),    # compacted, full
    ([9, 50, 7, 20], ("full", 4, 64))])             # capacity fallback
def test_chain_outputs_gate(counts, route):
    cfg_j, cfg_t = _cfgs()
    q, t, v, cnt = _chain_inputs(counts, seed=sum(counts))
    jp, tp = _prims(cfg_j, cfg_t)
    want = jpipe._chain_outputs(*(jnp.asarray(x) for x in (q, t, v, cnt)),
                                cfg_j, jp)
    pipeline.CHAIN_ROUTES.clear()
    got = pipeline._chain_outputs(
        *(torch.from_numpy(x) for x in (q, t, v, cnt)), cfg_t, tp)
    assert pipeline.CHAIN_ROUTES == {route: 1}
    for g, w, n in zip(got, want, ("t_start", "score", "mapped")):
        _eq(g, w, n)


def test_empty_chain_result_and_selectors():
    cfg_j, cfg_t = _cfgs()
    we, ge = jchain.empty_chain_result(cfg_j), chaining.empty_chain_result(
        cfg_t)
    assert int(we.t_start) == ge.t_start
    assert np.float32(we.score) == np.float32(ge.score)
    assert float(we.score2) == ge.score2 and bool(we.mapped) == ge.mapped
    q, t, v, _ = _chain_inputs([30, 60], seed=4)
    key = chaining.pack_anchor_keys(*(torch.from_numpy(x) for x in (q, t, v)))
    wkey = jax.vmap(jchain.pack_anchor_keys)(jnp.asarray(q), jnp.asarray(t),
                                             jnp.asarray(v))
    _eq(key, wkey, "packed keys")
    for name in ("count", "topk"):
        got = torch.sort(chaining._SELECTORS[name](key, 64), dim=1).values
        want = jnp.sort(jax.vmap(
            lambda k: jchain._SELECTORS[name](k, 64))(wkey), axis=1)
        _eq(got, want, name)
    for g, w in zip(chaining.decode_anchor_keys(key),
                    jax.vmap(jchain.decode_anchor_keys)(wkey)):
        _eq(g, w)


@pytest.mark.parametrize("width", [None, 64])
def test_sort_anchors_equals_jax(width):
    """The per-read sort stage: full sort truncated to max_anchors, or the
    select-then-sort fast path at one ladder width."""
    cfg_j, cfg_t = _cfgs()
    q, t, v, _ = _chain_inputs([20, 64, 0], seed=5)
    want = jax.vmap(lambda a, b, c: jchain.sort_anchors(
        a, b, c, cfg_j, width=width))(*(jnp.asarray(x) for x in (q, t, v)))
    got = chaining.sort_anchors(*(torch.from_numpy(x) for x in (q, t, v)),
                                cfg_t, sorter=sort_ops.sort_rows,
                                width=width)
    for g, w, n in zip(got, want, ("sq", "st", "sv")):
        _eq(g, w, n)


# --------------------------------------------------------------------------- #
# The split recurrence of the chain_dp kernel (csrc/chain_dp.cu)
# --------------------------------------------------------------------------- #
INT_MIN = -(1 << 31)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's int32 image of an f32: ordered as the floats are,
    -0.0 taken as +0.0."""
    i = x.view(torch.int32)
    i = torch.where(i == INT_MIN, torch.zeros_like(i), i)
    return i ^ ((i >> 31) & INT_MAX)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & INT_MAX)).view(torch.float32)


def _split_dp(q, t, valid, cfg):
    """A model of the kernel's step: the band's older slots (all but the
    newest) reduced ahead through the int32 order image (the max, then the
    least age rank among the slots that reach it), then the newest slot's
    candidate merged by a STRICT ``>``.  Returns (f, diag0, ties): ties
    counts the steps that extend a chain (best > 0) where slots with
    different diag0 reach the best, split by whether the newest slot is one
    of them."""
    N, A = q.shape
    B = cfg.chain_band
    lane = torch.arange(B)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)     # noqa: E731
    ngc, nsc, w = f32(-cfg.gap_cost), f32(-cfg.skip_cost), f32(
        cfg.anchor_score)
    neg, half_neg, zero = f32(chaining.NEG), f32(chaining.NEG / 2), f32(0.0)
    bf = torch.full((N, B), chaining.NEG, dtype=torch.float32)
    bd = torch.zeros((N, B), dtype=torch.int32)
    bt = torch.full((N, B), chaining._SENT, dtype=torch.int32)
    bq = torch.full((N, B), chaining._SENT, dtype=torch.int32)
    f_out = torch.empty((N, A), dtype=torch.float32)
    d_out = torch.empty((N, A), dtype=torch.int32)
    ties = {"older": 0, "newest": 0}
    for i in range(A):
        ti, qi, vi = t[:, i:i + 1], q[:, i:i + 1], valid[:, i:i + 1]
        dt, dq = ti - bt, qi - bq
        ok = (dt > 0) & (dq > 0) & (dt <= cfg.max_gap) & (dq <= cfg.max_gap)
        gap = torch.abs(dt - dq).to(torch.float32)
        skip = torch.minimum(dt, dq).to(torch.float32)
        cand = chaining.fma_f32(chaining.fma_f32(bf, ngc, gap), nsc, skip)
        cand = torch.where(ok & (bf > half_neg), cand, neg)
        k = (lane - i) % B                        # age rank, 0 = oldest
        key = torch.where(k == B - 1, torch.full_like(k, INT_MIN, dtype=
                                                      torch.int32),
                          _order_key(cand))
        kmax = key.max(1, keepdim=True).values
        kbest = torch.where(key == kmax, k, B).min(1, keepdim=True).values
        best = _from_key(kmax.contiguous())
        dbest = torch.gather(bd, 1, (kbest + i) % B)
        s = (i - 1) % B                           # anchor i - 1, rank B - 1
        take = cand[:, s:s + 1] > best
        best = torch.where(take, cand[:, s:s + 1], best)
        dbest = torch.where(take, bd[:, s:s + 1], dbest)
        reach = (cand == best) & (best > zero)
        spread = reach.any(1) & (torch.where(reach, bd, INT_MAX).min(1).values
                                 != torch.where(reach, bd, INT_MIN).max(1)
                                 .values)
        newest = reach[:, (i - 1) % B]
        ties["older"] += int((spread & ~newest).sum())
        ties["newest"] += int((spread & newest).sum())
        fi = torch.where(vi, w + torch.maximum(best, zero), neg)
        di = torch.where(best > zero, dbest, ti - qi)
        f_out[:, i:i + 1], d_out[:, i:i + 1] = fi, di
        s = i % B
        bf[:, s:s + 1], bd[:, s:s + 1] = fi, di
        bt[:, s:s + 1], bq[:, s:s + 1] = ti, qi
    return f_out, d_out, ties


@pytest.mark.parametrize("seed", [13, 14, 15])
def test_split_dp_recurrence_equals_plain_and_jax(seed):
    """The kernel's evaluation order (csrc/chain_dp.cu) on tie-heavy
    anchors, bit-equal to chaining.chain_dp and to the JAX Pallas kernel in
    interpret mode."""
    from repro_torch.kernels.fixtures import tie_anchors
    cfg_j, cfg_t = _cfgs(max_anchors=96)
    q, t, v = tie_anchors(np.random.default_rng(seed), 4, 96,
                          max_gap=cfg_t.max_gap)
    v[2] = False                                  # an all-invalid row
    args = [torch.from_numpy(x) for x in (q, t, v)]
    f, dg, ties = _split_dp(*args, cfg_t)
    assert ties["older"] > 10 and ties["newest"] > 10, ties
    pf, pd = chaining.chain_dp(*args, cfg_t)
    _eq(f.view(torch.int32), pf.view(torch.int32).numpy(), "f vs plain")
    _eq(dg, pd.numpy(), "diag0 vs plain")
    wf, wd = jdp_ops.chain_dp(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v),
                              cfg_j)
    _eq(f, wf, "f vs jax kernel")
    _eq(dg, wd, "diag0 vs jax kernel")
