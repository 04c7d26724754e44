"""The PyTorch port's cheap phase (detect .. vote) against the JAX package,
stage by stage and as the fused kernel's plain path.  Tolerance: exact,
for every output plane and every counter (f32 means included)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import events as jev                          # noqa: E402
from repro.core import hashing as jhash                       # noqa: E402
from repro.core import pipeline as jpipe                      # noqa: E402
from repro.core import quantization as jquant                 # noqa: E402
from repro.core import seeding as jseed                       # noqa: E402
from repro.core import stages as jstages                      # noqa: E402
from repro.core import vote as jvote                          # noqa: E402
from repro.core.index import index_arrays as jax_index_arrays  # noqa: E402
from repro.kernels.cheap_fused import cheap_fused as jax_cheap_fused  # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core import MarsConfig, events, hashing      # noqa: E402
from repro_torch.core import pipeline, quantization, seeding  # noqa: E402
from repro_torch.core import stages, vote                     # noqa: E402
from repro_torch.core.index import index_arrays, index_from_numpy  # noqa: E402
from repro_torch.kernels.cheap_fused import ops as cf_ops     # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(radius=0, n_reads=6):
    cfg_j = JaxConfig(hash_bits=12, minimizer_radius=radius).with_mode(
        "ms_fixed")
    cfg_t = MarsConfig(hash_bits=12, minimizer_radius=radius).with_mode(
        "ms_fixed")
    ref = simulate.make_reference(6_000, seed=9)
    reads = simulate.sample_reads(ref, n_reads, signal_len=cfg_t.signal_len,
                                  seed=10, junk_frac=0.3)
    jidx = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
    tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                            jidx.n_ref_events, cfg_t)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, sig=reads.signals,
                jarr=jax_index_arrays(jidx), tarr=index_arrays(tidx, "cpu"))


@pytest.fixture(scope="module")
def s():
    return _setup()


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _eq_cheap(got, want):
    gq, gt, gv, gc = got
    wq, wt, wv, wc = want
    _eq(gq, wq, "q_pos")
    _eq(gt, wt, "t_pos")
    _eq(gv, wv, "hit_valid")
    assert set(gc) == set(wc)
    for k in wc:
        _eq(gc[k], wc[k], f"counter {k}")


# The reference as its chunk program compiles it: jit contracts
# 1.4826*mad + eps into one fused multiply-add (op-by-op dispatch does not).
_jit_normalize = jax.jit(jev.robust_normalize)


def test_normalize_and_early_quantize(s):
    x = torch.from_numpy(s["sig"])
    got = events.robust_normalize(x)
    want = _jit_normalize(jnp.asarray(s["sig"]))
    _eq(got, want, "robust_normalize")
    _eq(events.quantize_signal_fixed(got, 8),
        jev.quantize_signal_fixed(want, 8), "quantize_signal_fixed")


def test_normalize_random_rows():
    """Many rows of odd and even length: the one-sort median/MAD path."""
    rng = np.random.default_rng(3)
    for S in (1024, 999):
        sig = (rng.normal(size=(64, S)) * 3 + 1).astype(np.float32)
        _eq(events.robust_normalize(torch.from_numpy(sig)),
            _jit_normalize(jnp.asarray(sig)), f"S={S}")


def test_detect(s):
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    want = jev.detect_events_batch(jnp.asarray(s["sig"]), cfg_j)
    got = events.detect_events(torch.from_numpy(s["sig"]), cfg_t)
    for g, w, n in zip(got, want, ("means", "n_events", "counts")):
        _eq(g, w, n)
    xq = events.early_quantize(torch.from_numpy(s["sig"]), cfg_t)
    wb = jax.vmap(lambda r: jev.boundary_mask_fixed(r, cfg_j))(
        jnp.asarray(xq.numpy().astype(np.int16)))
    _eq(events.boundary_mask_fixed(xq, cfg_t), wb, "boundary mask")


def test_quantize(s):
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    means, n_ev, _ = events.detect_events(torch.from_numpy(s["sig"]), cfg_t)
    valid = torch.arange(cfg_t.max_events) < n_ev[:, None]
    got = quantization.quantize_events(means, valid, cfg_t)
    want = jax.vmap(lambda e, v: jquant.quantize_events(e, v, cfg_j))(
        jnp.asarray(means.numpy()), jnp.asarray(valid.numpy()))
    _eq(got, want, "symbols")


def _symbols(s):
    cfg_t = s["cfg_t"]
    means, n_ev, _ = events.detect_events(torch.from_numpy(s["sig"]), cfg_t)
    valid = torch.arange(cfg_t.max_events) < n_ev[:, None]
    return quantization.quantize_events(means, valid, cfg_t), n_ev


def test_seed_query_vote(s):
    """seed -> query -> vote, each stage fed the same inputs in both."""
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    sym, n_ev = _symbols(s)
    keys, valid = hashing.pack_seeds(sym, n_ev, cfg_t)

    def jseed_one(sy, n):
        k, v = jhash.pack_seeds(sy, n, cfg_j)
        return k, jhash.minimizer_mask(k, v, cfg_j.minimizer_radius)
    wk, wv = jax.vmap(jseed_one)(jnp.asarray(sym.numpy()),
                                 jnp.asarray(n_ev.numpy()))
    _eq(keys, np.asarray(wk).astype(np.int64), "keys")
    _eq(valid, wv, "seed_valid")

    t_pos, hit, qc = seeding.query_index(keys, valid, s["tarr"], cfg_t)
    wt, wh, wqc = jseed.query_index(wk, wv, s["jarr"], cfg_j)
    _eq(t_pos, wt, "t_pos")
    _eq(hit, wh, "hit_valid")
    assert set(qc) == set(wqc)
    for k in wqc:
        _eq(qc[k], wqc[k], k)

    q_pos = torch.arange(cfg_t.max_events, dtype=torch.int32)[
        None, :, None].expand(t_pos.shape)
    keep, vc = vote.vote_filter(q_pos, t_pos, hit, cfg_t)
    wkeep, wvc = jvote.vote_filter(jnp.asarray(q_pos.numpy()), wt, wh, cfg_j)
    _eq(keep, wkeep, "keep")
    assert set(vc) == set(wvc)
    for k in wvc:
        _eq(vc[k], wvc[k], k)


@pytest.mark.parametrize("use_vote", [True, False])
def test_vote_clip_guard(use_vote):
    """Projected starts below -DIAG_SHIFT land in bin 0 and are counted."""
    cfg_j = JaxConfig(thresh_voting=2, use_vote_filter=use_vote)
    cfg_t = MarsConfig(thresh_voting=2, use_vote_filter=use_vote)
    rng = np.random.default_rng(7)
    R, E, H = 3, 24, 4
    q = np.broadcast_to(np.arange(E, dtype=np.int32)[None, :, None],
                        (R, E, H)).copy()
    t = rng.integers(-(1 << 21), 3000, size=(R, E, H)).astype(np.int32)
    t[0, :, :2] = 500 + q[0, :, :2]        # a colinear run that survives
    v = rng.random((R, E, H)) < 0.7
    keep, vc = vote.vote_filter(torch.from_numpy(q), torch.from_numpy(t),
                                torch.from_numpy(v), cfg_t)
    wkeep, wvc = jvote.vote_filter(jnp.asarray(q), jnp.asarray(t),
                                   jnp.asarray(v), cfg_j)
    _eq(keep, wkeep, "keep")
    for k in wvc:
        _eq(vc[k], wvc[k], k)
    if use_vote:
        assert int(vc["n_votes_clipped"].sum()) > 0


def test_fused_plain_path_equals_jax_kernel_and_reference(s):
    """The port's cheap_fused (CPU -> its plain version) == the JAX
    cheap_fused kernel (interpret mode) == JAX cheap_phase, reference plan:
    q_pos, t_pos, hit_valid and all nine COUNTER_COLS."""
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    got = cf_ops.cheap_fused(torch.from_numpy(s["sig"]), s["tarr"], cfg_t)
    want_kernel = jax_cheap_fused(jnp.asarray(s["sig"]), s["jarr"], cfg_j)
    _eq_cheap(got, want_kernel)
    plan = jstages.resolve_plan(cfg_j, jstages.REFERENCE)
    want_ref = jpipe.cheap_phase(jnp.asarray(s["sig"]), s["jarr"], cfg_j,
                                 plan)
    _eq_cheap(got, want_ref)
    assert set(got[3]) == set(cf_ops.COUNTER_COLS)


def test_fused_minimizer_radius():
    s2 = _setup(radius=2, n_reads=4)
    got = cf_ops.cheap_fused(torch.from_numpy(s2["sig"]), s2["tarr"],
                             s2["cfg_t"])
    want = jax_cheap_fused(jnp.asarray(s2["sig"]), s2["jarr"], s2["cfg_j"])
    _eq_cheap(got, want)


@pytest.mark.parametrize("over", [dict(thresh_freq=1),
                                  dict(use_vote_filter=False),
                                  dict(use_freq_filter=False,
                                       thresh_voting=2)])
def test_cheap_phase_config_variants(s, over):
    """Filter switches and thresholds: the per-stage path and the fused
    plain path both equal JAX cheap_phase (reference plan)."""
    cfg_j, cfg_t = s["cfg_j"].replace(**over), s["cfg_t"].replace(**over)
    x = torch.from_numpy(s["sig"])
    plan_j = jstages.resolve_plan(cfg_j, jstages.REFERENCE)
    want = jpipe.cheap_phase(jnp.asarray(s["sig"]), s["jarr"], cfg_j, plan_j)
    plan_t = stages.resolve_plan(cfg_t, stages.KERNELS)
    _eq_cheap(pipeline.cheap_phase(x, s["tarr"], cfg_t, plan_t), want)
    _eq_cheap(pipeline.cheap_phase(x, s["tarr"], cfg_t, plan_t,
                                   use_fused=False), want)


def test_fused_rows_plain_version_shapes(s):
    cfg_t = s["cfg_t"]
    xq = events.early_quantize(torch.from_numpy(s["sig"]), cfg_t)
    t_pos, keep, cnt = cf_ops.cheap_fused_rows(
        xq, s["tarr"]["bucket_start"], s["tarr"]["entries_packed"], cfg_t)
    EH = cfg_t.max_events * cfg_t.max_hits_per_seed
    assert t_pos.shape == keep.shape == (xq.shape[0], EH)
    assert cnt.shape == (xq.shape[0], len(cf_ops.COUNTER_COLS))
    assert t_pos.dtype == keep.dtype == cnt.dtype == torch.int32


def test_supports_gate_and_unported_modes(s):
    plan = stages.resolve_plan(s["cfg_t"], stages.KERNELS)
    assert stages.fused_cheap_backend(plan, s["cfg_t"]) is not None
    wide = s["cfg_t"].replace(tstat_window=13)
    assert stages.fused_cheap_backend(
        stages.resolve_plan(wide, stages.KERNELS), wide) is None
    xq = torch.zeros((1, wide.signal_len), dtype=torch.int32)
    with pytest.raises(ValueError):
        cf_ops.cheap_fused_rows(xq, s["tarr"]["bucket_start"],
                                s["tarr"]["entries_packed"], wide)
    for mode in ("ms_float", "rh2"):
        # the float modes run the per-stage program with the reference
        # detect (parity: tests/test_torch_float.py)
        cfg = s["cfg_t"].with_mode(mode)
        plan = stages.resolve_plan(cfg, stages.KERNELS)
        assert stages.fused_cheap_backend(plan, cfg) is None
        assert dict(plan)["detect"] == stages.REFERENCE
        out = pipeline.cheap_phase(torch.from_numpy(s["sig"]), s["tarr"],
                                   cfg, plan)
        assert out[1].shape == (len(s["sig"]), cfg.max_events,
                                cfg.max_hits_per_seed)
    # the kernels have no dwell scan: min_dwell > 1 resolves detect and the
    # fused kernel to the reference, which runs the reference's dwell scan
    dwell = s["cfg_t"].replace(min_dwell=2)
    plan = stages.resolve_plan(dwell, stages.KERNELS)
    assert dict(plan)["detect"] == stages.REFERENCE
    assert stages.fused_cheap_backend(plan, dwell) is None
    with pytest.raises(ValueError, match="min_dwell"):
        cf_ops.cheap_fused_rows(xq, s["tarr"]["bucket_start"],
                                s["tarr"]["entries_packed"], dwell)
    kept = events._peak_pick(torch.ones(1, 8), torch.ones(1, 8, dtype=bool),
                             dwell.replace(peak_window=0))
    assert kept.tolist() == [[True, False] * 4]


# --------------------------------------------------------------------------- #
# min_dwell > 1: the reference's sequential dwell scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("min_dwell,peak_window", [(2, 0), (3, 0), (3, 1),
                                                   (5, 3)])
def test_boundary_mask_min_dwell(s, min_dwell, peak_window):
    """The greedy left-to-right dwell scan equals the reference's
    ``lax.scan`` on every read, and does drop boundaries here."""
    cfg_j = s["cfg_j"].replace(min_dwell=min_dwell, peak_window=peak_window)
    cfg_t = s["cfg_t"].replace(min_dwell=min_dwell, peak_window=peak_window)
    xq = events.early_quantize(torch.from_numpy(s["sig"]), cfg_t)
    want = jax.jit(jax.vmap(lambda r: jev.boundary_mask_fixed(r, cfg_j)))(
        jnp.asarray(xq.numpy().astype(np.int16)))
    got = events.boundary_mask_fixed(xq, cfg_t)
    _eq(got, want, "boundary mask")
    loose = events.boundary_mask_fixed(xq, cfg_t.replace(min_dwell=1))
    assert int(loose.sum()) > int(got.sum())


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("min_dwell", [2, 3])
def test_map_chunk_min_dwell_equals_jax_reference(s, min_dwell, use_kernels):
    """Both port plans at min_dwell > 1 equal the JAX reference plan: every
    MapOutput field and counter (peak window 0, so the scan decides every
    boundary's spacing)."""
    cfg_j = s["cfg_j"].replace(min_dwell=min_dwell, peak_window=0)
    cfg_t = s["cfg_t"].replace(min_dwell=min_dwell, peak_window=0)
    want = jpipe.map_chunk(jnp.asarray(s["sig"]), s["jarr"], cfg_j,
                           use_kernels=False, n_valid=5)
    got = pipeline.map_chunk(torch.from_numpy(s["sig"]), s["tarr"], cfg_t,
                             use_kernels=use_kernels, n_valid=5)
    for f in ("t_start", "score", "mapped", "n_events"):
        _eq(getattr(got, f), getattr(want, f), f)
    assert set(got.counters) == set(want.counters)
    for k in want.counters:
        assert int(got.counters[k]) == int(want.counters[k]), k
