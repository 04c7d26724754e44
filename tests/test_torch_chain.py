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
# The split recurrence of the chain_dp kernels (csrc/chain_dp.cu)
# --------------------------------------------------------------------------- #
INT_MIN = -(1 << 31)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """The shipped kernel's int32 image of an f32: ordered as the floats
    are, -0.0 taken as +0.0."""
    i = x.view(torch.int32)
    i = torch.where(i == INT_MIN, torch.zeros_like(i), i)
    return i ^ ((i >> 31) & INT_MAX)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & INT_MAX)).view(torch.float32)


def _band_sets(B: int) -> int:
    """Sets of 32 slots the band kernel keeps beside R0 at band B: none up
    to B = 33, else ceil((B - 1) / 32)."""
    return 0 if B <= 33 else -(-(B - 1) // 32)


def _split_dp(q, t, valid, cfg):
    """A model of the DP kernels' evaluation order, lane by lane.  One warp
    a read.  Set 0 (R0) holds in lane l the newest anchor j with
    j % 32 == l, written in place at step j; set k > 0 holds what R0 held k
    blocks of 32 anchors back (rotated in at each block's end; in the
    lanes R0 has not overwritten yet in this block, set 1 repeats R0's
    slot, with the same distance back, so either may win).  Step i's
    chain merges the newest anchor's candidate by a STRICT ``>`` into the
    older slots' best, which step i - 1 reduced beside its own chain: each
    lane scans its sets oldest first keeping the first best key, the warp
    takes the best key and, among the lanes reaching it, the slot farthest
    back (the oldest).  A slot more than B - 1 anchors back from step
    i - 1 is out of the band.

    At chain_band 32 (the shipped kernel, one set) the key is the order
    image, the out-of-band slot is capped at INT_MIN, and the winner's
    lane hands over its diag0.  At any other band (the band kernel, at
    B = min(chain_band, A)) a slot holds f as -inf where f <= NEG/2, a lane
    takes a slot only where its candidate is in reach (dt, dq in
    [1, max_gap]) and in the band, the key is the candidate's bits, only a
    positive best counts, and the winner's diag0 comes from the warp's
    ring of every anchor's diag0, by the winner's index (from the
    winner's lane where R0 is the only set: the same value).  Returns
    (f, diag0)."""
    N, A = q.shape
    shipped = cfg.chain_band == 32
    B = 32 if shipped else min(cfg.chain_band, A)
    S = 0 if shipped else _band_sets(B)
    mg = cfg.max_gap
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)     # noqa: E731
    ngc, nsc, w = f32(-cfg.gap_cost), f32(-cfg.skip_cost), f32(
        cfg.anchor_score)
    neg, half_neg, zero = f32(chaining.NEG), f32(chaining.NEG / 2), f32(0.0)
    inf = f32(float("inf"))

    def candidate(bf, dt, dq):
        """The candidate, and whether the slot is in reach: the band
        kernel's gap and skip are those of 2**23 + dt - 1 and
        2**23 + dq - 1, exact wherever in reach."""
        ok = (dt > 0) & (dq > 0) & (dt <= mg) & (dq <= mg)
        if shipped or mg >= 1 << 23:
            gap = torch.abs(dt - dq).to(torch.float32)
            skip = torch.minimum(dt, dq).to(torch.float32)
        else:
            m = torch.tensor(0x4AFFFFFF, dtype=torch.int32)
            mt, mq = (m + dt).view(torch.float32), (m + dq).view(torch.float32)
            gap = torch.abs(mt - mq)
            skip = torch.minimum(mt, mq) - f32(8388607.0)
        cand = chaining.fma_f32(chaining.fma_f32(bf, ngc, gap), nsc, skip)
        return cand, ok

    shape = (N, S + 1, 32)
    bf = torch.full(shape, chaining.NEG if shipped else -float("inf"),
                    dtype=torch.float32)
    bd = torch.zeros(shape, dtype=torch.int32)
    bt = torch.full(shape, chaining._SENT, dtype=torch.int32)
    bq = torch.full(shape, chaining._SENT, dtype=torch.int32)
    lane = torch.arange(32, dtype=torch.int32)
    older_f = torch.full((N,), chaining.NEG if shipped else 0.0)
    older_d = torch.zeros(N, dtype=torch.int32)
    new_f = torch.full((N,), chaining.NEG)
    new_d = torch.zeros(N, dtype=torch.int32)
    new_t = torch.full((N,), chaining._SENT, dtype=torch.int32)
    new_q = new_t.clone()
    f_out = torch.empty((N, A), dtype=torch.float32)
    d_out = torch.empty((N, A), dtype=torch.int32)
    for i in range(A):
        s = i % 32
        ti, qi, vi = t[:, i], q[:, i], valid[:, i]
        if i + 1 < A:
            # off the chain: step i + 1's older slots, before anchor i lands
            tn, qn = t[:, i + 1, None], q[:, i + 1, None]
            y = lane - s
            yb = y + (B - 1)
            x0 = ~y & 31
            lk = torch.full((N, 32), INT_MIN, dtype=torch.int32)
            ld = torch.zeros((N, 32), dtype=torch.int32)
            lb = torch.zeros((N, 32), dtype=torch.int32)
            for k in range(S, -1, -1):
                if k == 0:
                    in_band, back = x0 < B - 1, x0 + 1
                else:
                    in_band, back = yb >= 32 * k, 32 * k - y
                cand, ok = candidate(bf[:, k], tn - bt[:, k], qn - bq[:, k])
                if shipped:
                    cand = torch.where(ok & (bf[:, k] > half_neg), cand, neg)
                    key = torch.where(in_band, _order_key(cand), INT_MIN)
                    take = key > lk
                else:
                    key = cand.view(torch.int32)
                    take = ok & in_band & (key > lk)
                lk = torch.where(take, key, lk)
                ld = torch.where(take, bd[:, k], ld)
                lb = torch.where(take, back, lb)
            kmax = lk.max(1, keepdim=True).values
            bmax = torch.where(lk == kmax, lb, 0).max(1).values
            kmax = kmax[:, 0].contiguous()
            if shipped:
                next_f = _from_key(kmax)
                next_d = ld.gather(1, ((s - bmax) & 31)[:, None].long())[:, 0]
            else:
                next_f = torch.where(kmax > 0, kmax.view(torch.float32), zero)
                win = (i - bmax).clamp(0, A - 1).long()
                next_d = d_out.gather(1, win[:, None])[:, 0]
        # on the chain, step i
        cand, ok = candidate(new_f, ti - new_t, qi - new_q)
        cand = torch.where(ok & (new_f > half_neg), cand, neg)
        take = cand > older_f
        best = torch.where(take, cand, older_f)
        dbest = torch.where(take, new_d, older_d)
        fi = torch.where(vi, w + torch.maximum(best, zero), neg)
        di = torch.where(best > zero, dbest, ti - qi)
        f_out[:, i], d_out[:, i] = fi, di
        bf[:, 0, s] = fi if shipped else torch.where(fi > half_neg, fi, -inf)
        bd[:, 0, s], bt[:, 0, s], bq[:, 0, s] = di, ti, qi
        new_f, new_d, new_t, new_q = fi, di, ti, qi
        if i + 1 < A:
            older_f, older_d = next_f, next_d
        if s == 31:                               # the block's end
            for x in (bf, bd, bt, bq):
                x[:, 1:] = x[:, :-1].clone()
    return f_out, d_out


def _tie_kinds(q, t, valid, f, d, B, cfg):
    """Steps that extend a chain (best > 0) where band slots with different
    diag0 reach the best, by kind: the newest slot among them or not
    (``newest``, ``older``), and two of them 32k anchors apart, in one lane
    of the kernels (``lane``)."""
    N, A = q.shape
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)     # noqa: E731
    ngc, nsc = f32(-cfg.gap_cost), f32(-cfg.skip_cost)

    def pad(x, v):
        return torch.cat([torch.full((N, B), v, dtype=x.dtype), x], 1)
    fp, dp = pad(f, chaining.NEG), pad(d, 0)
    tp, qp = pad(t, chaining._SENT), pad(q, chaining._SENT)
    kinds = {"older": 0, "newest": 0, "lane": 0}
    for i in range(A):
        fw, dw = fp[:, i:i + B], dp[:, i:i + B]
        dt, dq = t[:, i:i + 1] - tp[:, i:i + B], q[:, i:i + 1] - qp[:, i:i + B]
        ok = (dt > 0) & (dq > 0) & (dt <= cfg.max_gap) & (dq <= cfg.max_gap)
        cand = chaining.fma_f32(chaining.fma_f32(
            fw, ngc, torch.abs(dt - dq).to(torch.float32)), nsc,
            torch.minimum(dt, dq).to(torch.float32))
        cand = torch.where(ok & (fw > chaining.NEG / 2), cand, chaining.NEG)
        best = cand.max(1, keepdim=True).values
        reach = (cand == best) & (best > 0)
        spread = reach.any(1) & (torch.where(reach, dw, INT_MAX).min(1).values
                                 != torch.where(reach, dw, INT_MIN).max(1)
                                 .values)
        per_lane = torch.zeros((N, 32)).index_add_(
            1, torch.arange(i - B, i) % 32, reach.to(torch.float32))
        kinds["older"] += int((spread & ~reach[:, -1]).sum())
        kinds["newest"] += int((spread & reach[:, -1]).sum())
        kinds["lane"] += int((spread & (per_lane >= 2).any(1)).sum())
    return kinds


def _check_split_dp(q, t, v, A, B):
    """The model at chain_band B, bit-equal to chaining.chain_dp and to the
    JAX Pallas kernel in interpret mode; returns its tie kinds."""
    cfg_j, cfg_t = _cfgs(max_anchors=A, chain_band=B)
    args = [torch.from_numpy(x) for x in (q, t, v)]
    f, dg = _split_dp(*args, cfg_t)
    pf, pd = chaining.chain_dp(*args, cfg_t)
    _eq(f.view(torch.int32), pf.view(torch.int32).numpy(), "f vs plain")
    _eq(dg, pd.numpy(), "diag0 vs plain")
    wf, wd = jdp_ops.chain_dp(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v),
                              cfg_j)
    _eq(f, wf, "f vs jax kernel")
    _eq(dg, wd, "diag0 vs jax kernel")
    return _tie_kinds(*args, f, dg, B if B == 32 else min(B, A), cfg_t)


@pytest.mark.parametrize("seed", [13, 14, 15])
def test_split_dp_recurrence_equals_plain_and_jax(seed):
    """The shipped kernel's evaluation order (chain_band 32) on tie-heavy
    anchors, bit-equal to chaining.chain_dp and to the JAX Pallas kernel in
    interpret mode."""
    from repro_torch.kernels.fixtures import tie_anchors
    q, t, v = tie_anchors(np.random.default_rng(seed), 4, 96, max_gap=128)
    v[2] = False                                  # an all-invalid row
    ties = _check_split_dp(q, t, v, 96, 32)
    assert ties["older"] > 10 and ties["newest"] > 10, ties


# (band, anchors): A just past B, and A < B, where the wrapper clamps the
# band to A
BAND_CASES = [(1, 40), (16, 20), (31, 33), (33, 70), (64, 70), (65, 97),
              (128, 150), (300, 330), (33, 20), (64, 40), (300, 200)]


@pytest.mark.parametrize("fixture", ["ties", "lane_ties"])
@pytest.mark.parametrize("B,A", BAND_CASES)
def test_split_dp_band_recurrence_equals_plain_and_jax(B, A, fixture):
    """The band kernel's evaluation order (any chain_band but 32: R0 and the
    rotated sets, the out-of-band slots, the split) on
    tie-heavy anchors and on ties between slots of one lane, bit-equal to
    chaining.chain_dp and to the JAX Pallas kernel in interpret mode."""
    from repro_torch.kernels.fixtures import lane_tie_anchors, tie_anchors
    if fixture == "ties":
        q, t, v = tie_anchors(np.random.default_rng(B * A), 4, A,
                              max_gap=128)
        v[2] = False                              # an all-invalid row
    else:
        q, t, v = lane_tie_anchors(3, A)
    ties = _check_split_dp(q, t, v, A, B)
    band = min(B, A)
    if fixture == "ties":
        assert ties["newest"] > 0 or band < 2, ties
        assert ties["older"] > 0 or band < 4, ties
    elif band >= 33:
        assert ties["lane"] > 0 and ties["newest"] > 0, ties


@pytest.mark.parametrize("B,A", [(64, 70), (128, 150), (300, 330)])
def test_split_dp_band_lane_ties_among_older_slots(B, A):
    """Ties between two older slots of one lane (the newest slot out of
    reach): the lane's oldest-first scan decides them."""
    from repro_torch.kernels.fixtures import lane_tie_anchors
    ties = _check_split_dp(*lane_tie_anchors(3, A, lag=3), A, B)
    assert ties["lane"] > 0 and ties["newest"] == 0, ties


@pytest.mark.parametrize("B,A", [(1, 40), (16, 60), (33, 120), (64, 200),
                                 (300, 700)])
def test_split_dp_band_edge(B, A):
    """A predecessor B - 1, B and B + 1 anchors back, every slot between
    invalid: the band's last slot extends the chain, the one past it
    (still held in the kernel's sets) must not."""
    from repro_torch.kernels.fixtures import band_edge_anchors
    q, t, v = band_edge_anchors(3, A, B)
    _check_split_dp(q, t, v, A, B)
    f, _ = chaining.chain_dp(*(torch.from_numpy(x) for x in (q, t, v)),
                             _cfgs(max_anchors=A, chain_band=B)[1])
    ext = f > MarsConfig().anchor_score
    assert ext[:2].any(1).all() and not ext[2].any()
