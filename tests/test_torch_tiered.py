"""The PyTorch port's out-of-core tiered index against the JAX package's:
``TieredIndex`` / ``tier_index`` / ``build_index_streaming`` /
``tile_checksum``, ``HotTileCache`` (paging, eviction, replicas, the
traffic pre-pass and its reuse, the fault-injected page-in),
``Mapper(backend="tiered")``, ``driver.stream_map(prefetch=...)``,
``ServeDriver`` over a tiered mapper and ``serve_rsga --fault-plan``.

Each case gives the JAX function (the reference package on the CPU) and
the port's (on the CPU) the same numpy inputs: the JAX tests' setup,
``MarsConfig(hash_bits=12)``, an 8,000-base reference, 24 reads with junk
0.25, chunks of 8.  Planes, CRCs, every ``MapOutput`` field, the chunk
counters, the cache telemetry (hits, misses, paged bytes, replica loads,
the traffic histogram, the final slot map), the serving state and the
fault accounting (retries, corruptions, virtual time, the clock) must be
equal.  Tolerance: exact.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp                                       # noqa: E402

import repro.core as J                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro.core import index as jindex                        # noqa: E402
from repro.core import pipeline as jpipeline                  # noqa: E402
from repro.core import tiered as jtiered                      # noqa: E402
from repro.launch import serve_rsga as jax_serve_rsga         # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core import events as tevents                # noqa: E402
from repro_torch.core import index as tindex                  # noqa: E402
from repro_torch.core import pipeline as tpipeline            # noqa: E402
from repro_torch.core import tiered as ttiered                # noqa: E402
from repro_torch.launch import serve_rsga                     # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
FIELDS = ("t_start", "score", "mapped", "n_events")
CHUNK = 8
PKGS = {"jax": types.SimpleNamespace(core=J, index=jindex, tiered=jtiered,
                                     launch=jax_serve_rsga),
        "torch": types.SimpleNamespace(core=T, index=tindex, tiered=ttiered,
                                       launch=serve_rsga)}


@pytest.fixture(scope="module")
def setup():
    ref = simulate.make_reference(8_000, seed=5)
    reads = simulate.sample_reads(ref, 24, signal_len=1024, seed=6,
                                  junk_frac=0.25)
    out = {}
    for mode in ("ms_fixed", "ms_float", "rh2"):
        cfg_j = J.MarsConfig(hash_bits=12).with_mode(mode)
        cfg_t = T.MarsConfig(hash_bits=12).with_mode(mode)
        jidx = J.build_index(ref.events_concat, ref.n_events, cfg_j)
        tidx = tindex.index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                                       jidx.n_ref_events, cfg_t)
        out[mode] = dict(cfg_j=cfg_j, cfg_t=cfg_t, jidx=jidx, tidx=tidx)
    return ref, reads, out


def _mapper(setup, pkg, mode="ms_fixed", **kw):
    d = setup[2][mode]
    if pkg == "jax":
        return J.Mapper(d["jidx"], d["cfg_j"], **kw)
    return T.Mapper(d["tidx"], d["cfg_t"], device="cpu", **kw)


def _host(out):
    """A MapOutput as numpy fields and int counters."""
    return ({f: np.asarray(getattr(out, f)) for f in FIELDS},
            {k: int(v) for k, v in out.counters.items()})


def _telemetry(cache):
    return dict(
        hits=cache.hits, misses=cache.misses, paged_bytes=cache.paged_bytes,
        n_chunks=cache.n_chunks, retries=cache.retries,
        corruptions=cache.corruptions, vtime_penalty=cache.vtime_penalty,
        replica_loads=cache.replica_loads,
        replica_bytes=cache.replica_bytes, hit_rate=cache.hit_rate,
        cache_nbytes=cache.cache_nbytes,
        tile_traffic=cache.tile_traffic().tolist(),
        slot_tile=cache._slot_tile.tolist(),
        slot_last=cache._slot_last.tolist(),
        slot_touch=cache._slot_touch.tolist())


def _map(setup, pkg, mode="ms_fixed", signals=None, **kw):
    """One map_signals run: (outputs or the exception raised, telemetry)."""
    m = _mapper(setup, pkg, mode, **kw)
    try:
        res = _host(m.map_signals(setup[1].signals if signals is None
                                  else signals, chunk=CHUNK))
    except Exception as e:                 # compared with the other side's
        res = (type(e).__name__, str(e))
    return res, (None if m.cache is None else _telemetry(m.cache))


def _cache(pkg, tiered, **kw):
    """A HotTileCache of either package (the port's on the CPU)."""
    if pkg == "torch":
        kw["device"] = "cpu"
    return PKGS[pkg].tiered.HotTileCache(tiered, **kw)


_JAX_RUNS = {}


def _jax_map(setup, mode="ms_fixed", **kw):
    key = (mode, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _map(setup, "jax", mode, **kw)
    return _JAX_RUNS[key]


def _assert_equal(got, want):
    (g, gt), (w, wt) = got, want
    if isinstance(w[0], str):
        assert g == w                      # the same exception, same text
    else:
        for f in FIELDS:
            assert g[0][f].dtype == w[0][f].dtype, f
            np.testing.assert_array_equal(g[0][f], w[0][f], err_msg=f)
        assert g[1] == w[1]
    assert gt == wt


@pytest.fixture(scope="module")
def resident(setup):
    return {mode: _host(_mapper(setup, "torch", mode).map_signals(
                setup[1].signals, chunk=CHUNK))
            for mode in ("ms_fixed", "ms_float", "rh2")}


def _check(setup, resident, mode="ms_fixed", **kw):
    """The port's tiered run equals the JAX package's (outputs, counters,
    telemetry) and the port's resident-index run."""
    got = _map(setup, "torch", mode, **kw)
    _assert_equal(got, _jax_map(setup, mode, **kw))
    for f in FIELDS:
        np.testing.assert_array_equal(got[0][0][f], resident[mode][0][f])
    assert got[0][1] == resident[mode][1]
    return got[1]


# --------------------------------------------------------------------------- #
# The tiered index and its builders
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_tiles", [1, 4, 16])
@pytest.mark.parametrize("chunk_events", [1 << 9, 1 << 12, 1 << 20])
def test_streaming_build_equals_jax(setup, n_tiles, chunk_events):
    """The port's streaming build and its ``tier_index`` give the JAX
    package's tiles byte for byte, with its CRCs, for any block size."""
    ref, _, per = setup
    d = per["ms_fixed"]
    want = jindex.tier_index(d["jidx"], n_tiles)
    for got in (tindex.build_index_streaming(
                    ref.events_concat, ref.n_events, d["cfg_t"], n_tiles,
                    chunk_events=chunk_events),
                tindex.tier_index(d["tidx"], n_tiles)):
        for name in ("tile_bucket_start", "tile_entries_packed",
                     "tile_n_entries", "tile_checksums"):
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert got.n_entries == want.n_entries == d["jidx"].n_entries
        assert (got.n_tiles, got.buckets_per_tile, got.emax,
                got.tile_nbytes, got.nbytes) == (
            want.n_tiles, want.buckets_per_tile, want.emax,
            want.tile_nbytes, want.nbytes)
        assert [got.checksum(t) for t in range(n_tiles)] == \
            [want.checksum(t) for t in range(n_tiles)]


def test_global_planes_and_checksums_equal_jax(setup):
    ref, _, per = setup
    d = per["ms_fixed"]
    got = tindex.build_index_streaming(ref.events_concat, ref.n_events,
                                       d["cfg_t"], 8, chunk_events=1 << 10)
    want = jindex.build_index_streaming(ref.events_concat, ref.n_events,
                                        d["cfg_j"], 8, chunk_events=1 << 10)
    for g, w in zip(got.global_planes(), want.global_planes()):
        np.testing.assert_array_equal(g, w)
    bs, packed = got.global_planes()
    np.testing.assert_array_equal(bs, d["jidx"].bucket_start)
    np.testing.assert_array_equal(packed, d["jidx"].entries_packed)
    # a hand-built instance computes its CRCs on first use
    bare = dataclasses.replace(got, tile_checksums=None)
    assert [bare.checksum(t) for t in range(8)] == got.tile_checksums.tolist()
    # one flipped bit changes the CRC
    ent = np.array(got.tile_entries_packed[0], copy=True)
    assert tindex.tile_checksum(got.tile_bucket_start[0], ent) == \
        jindex.tile_checksum(got.tile_bucket_start[0], ent) == \
        got.checksum(0)
    ent.reshape(-1)[7] ^= 1 << 13
    assert tindex.tile_checksum(got.tile_bucket_start[0], ent) != \
        got.checksum(0)


def test_partition_index_equals_jax(setup):
    d = setup[2]["ms_fixed"]
    for n in (1, 2, 8):
        got = tindex.partition_index(d["tidx"], n)
        want = jindex.partition_index(d["jidx"], n)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_streaming_build_memmap(setup, resident, tmp_path):
    """``mmap_path`` keeps the padded entry plane in a memory-mapped file:
    the same bytes, and a tiered Mapper over it maps as the resident
    index does."""
    ref, reads, per = setup
    d = per["ms_fixed"]
    ti = tindex.build_index_streaming(ref.events_concat, ref.n_events,
                                      d["cfg_t"], 8, chunk_events=1 << 10,
                                      mmap_path=tmp_path / "tiles.npy")
    assert isinstance(ti.tile_entries_packed, np.memmap)
    np.testing.assert_array_equal(
        np.asarray(ti.tile_entries_packed),
        np.asarray(jindex.tier_index(d["jidx"], 8).tile_entries_packed))
    m = T.Mapper(ti, d["cfg_t"], backend="tiered", cache_slots=4,
                 device="cpu")
    assert m.cache.tiered is ti
    got = _host(m.map_signals(reads.signals, chunk=CHUNK))
    for f in FIELDS:
        np.testing.assert_array_equal(got[0][f], resident["ms_fixed"][0][f])
    assert got[1] == resident["ms_fixed"][1]


# --------------------------------------------------------------------------- #
# The tiered Mapper
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tiles,slots", [(1, 1), (8, 4), (16, 1), (16, 16)])
def test_tiered_mapper_equals_jax(setup, resident, tiles, slots):
    """Every (tile count, cache size), including the cache-of-1 thrash
    regime where every chunk takes the transient wide view."""
    tel = _check(setup, resident, backend="tiered", tiles=tiles,
                 cache_slots=slots)
    ti = tindex.tier_index(setup[2]["ms_fixed"]["tidx"], tiles)
    assert tel["n_chunks"] == 3 and tel["misses"] >= 1
    assert tel["paged_bytes"] == tel["misses"] * ti.tile_nbytes


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_eviction_equals_jax(setup, resident, seed):
    """The seeded random policy draws the JAX package's victims."""
    _check(setup, resident, backend="tiered", tiles=16, cache_slots=4,
           cache_policy="random", cache_seed=seed)


@pytest.mark.parametrize("slots,replicas,policy", [
    (1, 1, "lru"), (2, 3, "lru"), (4, 5, "lru"), (16, 16, "lru"),
    (2, 3, "random")])
def test_replicas_equal_jax(setup, resident, slots, replicas, policy):
    """Hot-tile replicas: the same replica set, loads and routing."""
    tel = _check(setup, resident, backend="tiered", tiles=16,
                 cache_slots=slots, cache_replicas=replicas,
                 cache_policy=policy, cache_seed=1)
    assert tel["replica_loads"] >= 1


@pytest.mark.parametrize("reuse", [True, False])
def test_reuse_prepass_equals_jax(setup, resident, reuse):
    _check(setup, resident, backend="tiered", tiles=8, cache_slots=4,
           reuse_prepass=reuse)


@pytest.mark.parametrize("mode", ["ms_float", "rh2"])
def test_tiered_float_modes_equal_jax(setup, resident, mode):
    """The float modes: the tiered plan's reference detection binds the
    reference segment sum (the tiered backend registers none)."""
    _check(setup, resident, mode, backend="tiered", tiles=8, cache_slots=2)


def test_tiered_plan_equals_jax(setup):
    """Only the query takes the tiered backend, in both packages: the
    tiered plan launches no hand-written kernel."""
    for mode in ("ms_fixed", "ms_float"):
        d = setup[2][mode]
        tplan = dict(T.stages.resolve_plan(d["cfg_t"], "tiered"))
        jplan = dict(J.stages.resolve_plan(d["cfg_j"], "tiered"))
        assert tplan == {s: "tiered" if s == "query" else "reference"
                         for s in T.stages.STAGE_ORDER}
        assert jplan == tplan
        assert set(jplan.values()) == {"reference", "tiered"}
        plan = T.stages.resolve_plan(d["cfg_t"], "tiered")
        assert T.stages.plan_index_kind(plan) == "tiered"
        assert J.stages.plan_index_kind(J.stages.resolve_plan(
            d["cfg_j"], "tiered")) == "tiered"
        assert T.stages.fused_cheap_backend(plan, d["cfg_t"]) is None
        prims = T.stages.cheap_primitives(plan, d["cfg_t"])
        assert prims.fused is None and prims.gather is None
        assert prims.detector.keywords["segment_sum"] is \
            tevents.segment_sum_in_order
    assert T.stages.DEBUG_COUNTER_SCHEMA == J.stages.DEBUG_COUNTER_SCHEMA
    assert T.stages.CHUNK_COUNTER_SCHEMA == J.stages.CHUNK_COUNTER_SCHEMA


@pytest.mark.parametrize("tiles,slots,reuse", [(8, 4, True), (16, 1, True),
                                               (8, 4, False)])
def test_prepared_view_and_cheap_phase_equal_jax(setup, tiles, slots,
                                                 reuse):
    """The view ``HotTileCache.prepare`` builds (slot planes, tile->slot
    map, chunk stats, and the pre-pass planes ``PREPASS_KEYS`` when reuse
    is on) and the cheap phase over it, debug counters included, equal
    the JAX package's."""
    _, reads, per = setup
    d = per["ms_fixed"]
    sig = reads.signals[:CHUNK]
    kw = dict(backend="tiered", tiles=tiles, cache_slots=slots,
              reuse_prepass=reuse)
    mj, mt = _mapper(setup, "jax", **kw), _mapper(setup, "torch", **kw)
    for _ in range(2):                     # cold, then warm
        vj = mj.cache.prepare(sig, d["cfg_j"], mj.plan)
        vt = mt.cache.prepare(sig, d["cfg_t"], mt.plan)
        assert set(vt) == set(vj)
        assert all(k in vt for k in ttiered.PREPASS_KEYS) == reuse
        for k in vj:
            w = np.asarray(vj[k])
            g = vt[k].numpy()
            if k == "t_pre_keys":
                assert w.dtype == np.uint32 and g.dtype == np.int64
                w = w.astype(np.int64)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        cj = jpipeline.cheap_phase(jnp.asarray(sig), vj, d["cfg_j"],
                                   mj.plan)
        ct = tpipeline.cheap_phase(torch.from_numpy(sig), vt, d["cfg_t"],
                                   mt.plan)
        for name, g, w in zip(("q_pos", "t_pos", "hit_valid"), ct[:3],
                              cj[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        assert set(ct[3]) == set(cj[3]) >= set(ttiered._STATS_COUNTERS)
        for k in cj[3]:
            np.testing.assert_array_equal(
                ct[3][k].numpy().astype(np.int64),
                np.asarray(cj[3][k]).astype(np.int64), err_msg=k)
    assert _telemetry(mt.cache) == _telemetry(mj.cache)


def test_overflow_view_and_full_eviction_equal_jax(setup):
    """needed == n_slots + 1 overflows into a transient view padded to the
    next power of two, leaving the persistent slots alone; two chunks each
    needing every slot with disjoint tiles evict and reload every slot."""
    d = setup[2]["ms_fixed"]
    views = {}
    for pkg, idx in (("jax", d["jidx"]), ("torch", d["tidx"])):
        p = PKGS[pkg]
        c = _cache(pkg, p.index.tier_index(idx, 8), n_slots=4)
        before = c._slot_tile.copy()
        hist = np.zeros(8, np.int64)
        hist[:5] = 1
        wide = c._overflow_view(np.arange(5), hist)
        np.testing.assert_array_equal(c._slot_tile, before)
        c._serial += 1
        h1 = np.zeros(8, np.int64)
        h1[:4] = 1
        c._ensure_resident(np.arange(4), h1)
        assert sorted(int(t) for t in c._slot_tile) == [0, 1, 2, 3]
        c._serial += 1
        h2 = np.zeros(8, np.int64)
        h2[4:] = 3
        view = c._ensure_resident(np.arange(4, 8), h2)
        assert sorted(int(t) for t in c._slot_tile) == [4, 5, 6, 7]
        views[pkg] = ({k: np.asarray(v) for k, v in wide.items()},
                      {k: np.asarray(v) for k, v in view.items()},
                      _telemetry(c))
    gw, gv, gt = views["torch"]
    ww, wv, wt = views["jax"]
    assert gw["t_bucket_start"].shape[0] == 8
    assert (gw["t_tile_slot"][:5] >= 0).all()
    assert (gw["t_tile_slot"][5:] == -1).all()
    assert gv["t_cache_stats"][1] == 4
    for g, w in ((gw, ww), (gv, wv)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert gt == wt


@pytest.mark.parametrize("policy,seed,replicas", [
    ("lru", 0, 0), ("lru", 1, 2), ("random", 2, 0), ("random", 3, 2)])
def test_eviction_sequence_equals_jax(setup, policy, seed, replicas):
    """Forty chunks' worth of tile traffic (1-5 of 16 tiles a chunk, random
    seed counts) through ``_prepare``'s host steps: every victim, replica
    refresh, view and counter equals the JAX package's, step by step.
    (The mapping cases touch nearly every tile a chunk, so they overflow
    and never pick a victim.)"""
    d = setup[2]["ms_fixed"]
    caches = {pkg: _cache(pkg, PKGS[pkg].index.tier_index(idx, 16),
                          n_slots=4, policy=policy, seed=seed,
                          replicas=replicas)
              for pkg, idx in (("jax", d["jidx"]), ("torch", d["tidx"]))}
    rng = np.random.default_rng(seed)
    for step in range(40):
        k = int(rng.integers(1, 6))
        hist = np.zeros(16, np.int64)
        hist[rng.choice(16, size=k, replace=False)] = rng.integers(1, 50, k)
        needed = np.nonzero(hist > 0)[0]
        views = {}
        for pkg, c in caches.items():
            c._serial += 1
            c.n_chunks += 1
            c._tile_traffic += hist
            c._refresh_replicas()
            v = (c._ensure_resident(needed, hist) if needed.size <= c.n_slots
                 else c._overflow_view(needed, hist))
            views[pkg] = {key: np.asarray(val) for key, val in v.items()}
        for key in views["jax"]:
            np.testing.assert_array_equal(views["torch"][key],
                                          views["jax"][key],
                                          err_msg=f"step {step} {key}")
        assert _telemetry(caches["torch"]) == _telemetry(caches["jax"])
    assert caches["torch"].hits > 0 and caches["torch"].misses > 0


def test_counter_schema_unchanged_and_stats_debug_only(setup):
    out = _mapper(setup, "torch", backend="tiered", tiles=8,
                  cache_slots=4).map_signals(setup[1].signals[:8], chunk=8)
    assert set(out.counters) == set(T.stages.CHUNK_COUNTER_SCHEMA)
    for k in ttiered._STATS_COUNTERS:
        assert k in T.stages.DEBUG_COUNTER_SCHEMA
        assert k not in T.stages.CHUNK_COUNTER_SCHEMA


def test_tiered_plan_refuses_resident_arrays(setup):
    """A tiered plan handed the resident arrays (no HotTileCache view)
    raises, as the JAX package's does; never a silent wrong answer."""
    _, reads, per = setup
    d = per["ms_fixed"]
    arrays = tindex.index_arrays(d["tidx"], "cpu")
    plan = T.stages.resolve_plan(d["cfg_t"], "tiered")
    with pytest.raises(ValueError, match="HotTileCache"):
        T.map_chunk(torch.from_numpy(reads.signals[:8]), arrays, d["cfg_t"],
                    plan=plan)


def test_tiered_path_defaults_to_cuda_and_raises_without_it(setup,
                                                           monkeypatch):
    """No card and no ``device="cpu"``: the tiered Mapper and the
    launcher's --fault-plan path raise; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = setup[2]["ms_fixed"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Mapper(d["tidx"], d["cfg_t"], backend="tiered")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttiered.HotTileCache(tindex.tier_index(d["tidx"], 8), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_rsga.main(["--dataset", "D1", "--streams", "1",
                         "--reads-per-stream", "2", "--fault-plan", "0"])


def test_with_cfg_shares_the_cache(setup):
    m = _mapper(setup, "torch", backend="tiered", tiles=8, cache_slots=4)
    m2 = m.with_cfg(m.cfg.replace(signal_len=512))
    assert m2.cache is m.cache and m2.arrays is None
    assert dict(m2.plan)["query"] == "tiered"
    with pytest.raises(ValueError, match="hash_bits"):
        m.with_cfg(m.cfg.replace(hash_bits=10))


# --------------------------------------------------------------------------- #
# Validation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(n_slots=0), dict(n_slots=4, policy="fifo"),
    dict(n_slots=4, max_retries=-1), dict(n_slots=4, backoff_base=-1.0),
    dict(n_slots=4, replicas=-1)], ids=lambda kw: "-".join(kw))
def test_cache_validation_equals_jax(setup, kw):
    d = setup[2]["ms_fixed"]
    msgs = []
    for pkg, idx in (("jax", d["jidx"]), ("torch", d["tidx"])):
        p = PKGS[pkg]
        with pytest.raises(ValueError) as e:
            _cache(pkg, p.index.tier_index(idx, 8), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_non_power_of_two_tiles_raise(setup):
    ref, _, per = setup
    d = per["ms_fixed"]
    with pytest.raises(ValueError, match="power of two"):
        tindex.partition_index(d["tidx"], 3)
    with pytest.raises(ValueError, match="power of two"):
        tindex.tier_index(d["tidx"], 6)
    for n in (0, 3):
        with pytest.raises(ValueError, match="power of two"):
            tindex.build_index_streaming(ref.events_concat, ref.n_events,
                                         d["cfg_t"], n)
    with pytest.raises(ValueError, match="power of two"):
        T.Mapper(d["tidx"], d["cfg_t"], backend="tiered", tiles=6,
                 device="cpu")
    with pytest.raises(ValueError, match="replicas"):
        T.Mapper(d["tidx"], d["cfg_t"], backend="tiered", tiles=8,
                 cache_replicas=-1, device="cpu")


# --------------------------------------------------------------------------- #
# Faults
# --------------------------------------------------------------------------- #
def test_zero_fault_plan_is_disabled(setup, resident):
    p = T.FaultPlan(seed=123)
    assert not p.enabled
    assert T.FaultPlan(seed=1, p_corrupt=0.1).enabled
    assert T.FaultPlan(sticky_corrupt_tiles={3}).enabled
    assert T.FaultPlan(prefetch_error_serials=[0]).enabled
    assert not T.FaultPlan(failed_drive=2).enabled
    m = _mapper(setup, "torch", backend="tiered", tiles=8, cache_slots=4,
                fault_plan=T.FaultPlan(seed=9))
    assert m.cache._inj is None
    tel = _check(setup, resident, backend="tiered", tiles=8, cache_slots=4,
                 fault_plan=T.FaultPlan(seed=9))
    assert tel["retries"] == tel["corruptions"] == 0
    assert tel["vtime_penalty"] == 0.0


def test_fault_plan_only_on_tiered_backend(setup):
    d = setup[2]["ms_fixed"]
    with pytest.raises(ValueError, match="tiered"):
        T.Mapper(d["tidx"], d["cfg_t"], device="cpu",
                 fault_plan=T.FaultPlan(seed=1, p_corrupt=0.5))


FAULT_CASES = {
    "retry_heals": (dict(seed=2, p_read_error=0.5),
                    dict(cache_retries=64, cache_backoff=0.25)),
    "latency_only_costs_time": (dict(seed=3, p_latency=1.0,
                                     latency_units=4.0), {}),
    "corruption_heals": (dict(seed=4, p_corrupt=0.3),
                         dict(cache_retries=16)),
    "sticky_corruption_raises": (dict(seed=1,
                                      sticky_corrupt_tiles=range(8)), {}),
    "initial_prefetch_raises": (dict(seed=1, prefetch_error_serials={0}),
                                {}),
    "later_prefetch_raises": (dict(seed=1, prefetch_error_serials={2}), {}),
}


def _fault_run(setup, pkg, plan_kw, kw, tiles=8, slots=4):
    fp = PKGS[pkg].core.FaultPlan(**plan_kw)
    kw = dict(kw, backend="tiered", tiles=tiles, cache_slots=slots,
              fault_plan=fp)
    if pkg == "jax":
        return _jax_map(setup, **kw)
    return _map(setup, "torch", **kw)


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_fault_runs_equal_jax(setup, resident, case):
    """Each fault plan heals to the resident outputs or raises, exactly as
    the JAX package's run does: the same outputs or the same exception,
    and the same retries, corruptions and virtual time lost."""
    plan_kw, kw = FAULT_CASES[case]
    got = _fault_run(setup, "torch", plan_kw, kw)
    _assert_equal(got, _fault_run(setup, "jax", plan_kw, kw))
    (res, tel) = got
    if case.endswith("raises"):
        assert isinstance(res[0], str)
        want = ("TileReadError" if case.startswith("sticky")
                else "InjectedPrefetchError")
        assert res[0] == want
    else:
        assert res[1] == resident["ms_fixed"][1]
        assert tel["vtime_penalty"] > 0.0
    if case == "retry_heals":
        assert tel["retries"] > 0
    if case == "corruption_heals":
        assert tel["corruptions"] > 0 and tel["retries"] > 0
    if case == "latency_only_costs_time":
        assert tel["retries"] == 0
    if case.startswith("sticky"):
        assert tel["corruptions"] > 0


@pytest.mark.parametrize("i", range(10))
def test_fault_sweep_equals_jax(setup, i):
    """The seeded plans of ``sample_fault_plans``: each heals or raises as
    the JAX package's run does (no silent wrong answer on either side)."""
    plan = dataclasses.asdict(T.sample_fault_plans(10, seed=0)[i])
    assert plan == dataclasses.asdict(J.sample_fault_plans(10, seed=0)[i])
    _assert_equal(_fault_run(setup, "torch", plan, {}),
                  _fault_run(setup, "jax", plan, {}))


def test_failed_pagein_leaves_persistent_slots_unchanged(setup):
    """A page-in that exhausts its retries raises BEFORE touching device
    state: the slot map and the device planes are as they were, and the
    accounting equals the JAX package's."""
    d = setup[2]["ms_fixed"]
    tels = []
    for pkg, idx in (("jax", d["jidx"]), ("torch", d["tidx"])):
        p = PKGS[pkg]
        c = _cache(
            pkg, p.index.tier_index(idx, 8), n_slots=4,
            faults=p.core.FaultPlan(seed=1, sticky_corrupt_tiles={5}))
        h1 = np.zeros(8, np.int64)
        h1[:3] = 1
        c._serial += 1
        c._ensure_resident(np.arange(3), h1)
        slots = c._slot_tile.copy()
        planes = (np.asarray(c._dev_bstart).copy(),
                  np.asarray(c._dev_ent).copy())
        h2 = np.zeros(8, np.int64)
        h2[5] = 1
        c._serial += 1
        with pytest.raises(p.core.TileReadError):
            c._ensure_resident(np.asarray([5]), h2)
        np.testing.assert_array_equal(c._slot_tile, slots)
        np.testing.assert_array_equal(np.asarray(c._dev_bstart), planes[0])
        np.testing.assert_array_equal(np.asarray(c._dev_ent), planes[1])
        tels.append(_telemetry(c))
    assert tels[0] == tels[1]


def test_failed_prefetch_does_not_leak_memoization(setup):
    d = setup[2]["ms_fixed"]
    m = _mapper(setup, "torch", backend="tiered", tiles=8, cache_slots=4,
                fault_plan=T.FaultPlan(seed=1, prefetch_error_serials={0}))
    sig = setup[1].signals[:8]
    with pytest.raises(T.InjectedPrefetchError):
        m.cache.prefetch(sig, d["cfg_t"], m.plan)
    assert not m.cache._ready and not m.cache._keep
    m.cache.prefetch(sig, d["cfg_t"], m.plan)     # serial 1 succeeds
    assert id(sig) in m.cache._ready
    m.cache.prefetch(sig, d["cfg_t"], m.plan)     # memoized: no re-page
    assert m.cache.n_chunks == 1
    view = m.cache.prepare(sig, d["cfg_t"], m.plan)
    assert not m.cache._ready and not m.cache._keep
    assert "t_pre_keys" in view and m.cache.n_chunks == 1


# --------------------------------------------------------------------------- #
# driver.stream_map(prefetch=...)
# --------------------------------------------------------------------------- #
def _pull_order(pkg, prefetch, fail_at=None):
    """The order in which stream_map pulls chunks, dispatches, prefetches
    and yields, over a chunk source that records its pulls."""
    log = []

    def chunks():
        for ci in range(4):
            log.append(("pull", ci))
            yield ci, 2, np.full((2, 3), ci, np.float32)

    def map_fn(sig, nv):
        log.append(("dispatch", int(sig[0, 0])))
        ci = int(sig[0, 0])
        return J.MapOutput(np.full(2, ci, np.int32),
                           np.full(2, ci, np.float32), np.ones(2, bool),
                           np.full(2, ci, np.int32),
                           {"n_reads": np.int32(nv)})

    def pre(sig, nv):
        log.append(("prefetch", int(sig[0, 0])))
        if int(sig[0, 0]) == fail_at:
            raise RuntimeError(f"boom at {fail_at}")

    drv = PKGS[pkg].core.driver
    if pkg == "torch":
        map_fn_t = map_fn

        def map_fn(sig, nv):
            out = map_fn_t(sig, nv)
            return T.MapOutput(*(torch.from_numpy(np.asarray(x))
                                 for x in out[:4]),
                               {"n_reads": torch.tensor(nv)})
    try:
        for ci, nv, out in drv.stream_map(
                map_fn, chunks(), prefetch=pre if prefetch else None):
            log.append(("yield", ci))
    except RuntimeError as e:
        log.append(("raise", str(e)))
    return log


@pytest.mark.parametrize("prefetch,fail_at", [(False, None), (True, None),
                                              (True, 0), (True, 2)])
def test_stream_map_order_equals_jax(prefetch, fail_at):
    """Without ``prefetch`` a chunk is pulled only after the previous one
    was dispatched; with it the loop reads one chunk ahead, and a prefetch
    failure drains the dispatched chunks before it is raised at the end."""
    got = _pull_order("torch", prefetch, fail_at)
    assert got == _pull_order("jax", prefetch, fail_at)
    if fail_at == 2:
        assert got[-1] == ("raise", "boom at 2")
        assert [e for e in got if e[0] == "yield"] == [("yield", 0),
                                                       ("yield", 1)]


def test_stream_map_prefetch_exception_drains_inflight(setup, resident):
    """A prefetch exception does not abandon dispatched work: chunks 0 and
    1 are yielded (equal to the resident run), then the failure
    surfaces."""
    m = _mapper(setup, "torch", backend="tiered", tiles=8, cache_slots=4)
    calls = []

    def prefetch(sig, nv):
        calls.append(nv)
        if len(calls) == 3:
            raise RuntimeError("boom at prefetch 3")

    got = []
    with pytest.raises(RuntimeError, match="boom at prefetch 3"):
        for item in T.driver.stream_map(
                m.chunk_fn(), T.driver.array_chunks(setup[1].signals, 8),
                prefetch=prefetch):
            got.append(item)
    assert [ci for ci, _, _ in got] == [0, 1]
    np.testing.assert_array_equal(
        np.concatenate([o.mapped for _, _, o in got]),
        resident["ms_fixed"][0]["mapped"][:16])


# --------------------------------------------------------------------------- #
# Serving over the tiered index
# --------------------------------------------------------------------------- #
def _serve_state(sd):
    return dict(
        streams={sid: dataclasses.asdict(st)
                 for sid, st in sd._streams.items()},
        report={k: dataclasses.asdict(v) for k, v in sd.report().items()},
        events=list(sd.events), clock=sd.clock, counters=dict(sd.counters),
        n_chunks=sd.n_chunks, n_pad_rows=sd.n_pad_rows, stages=sd.stages)


def _interleaved(p, m, sig):
    """An adversarial interleaving: reads of three streams in a random
    order (chunk composition must not change what a read maps to)."""
    rng = np.random.default_rng(0)
    owner = rng.integers(0, 3, 16)
    sd = m.serve(chunk=CHUNK)
    for r in rng.permutation(16):
        sd.submit(f"s{owner[r]}", sig[int(r)])
    sd.drain()
    return sd


def _ladder(p, m, sig):
    """The early-termination ladder: every stage's chunk program shares the
    one tile cache (``Mapper.with_cfg``)."""
    sd = p.core.ServeDriver(m, chunk=CHUNK, early_term=True)
    sd.serve_trace(p.launch.build_trace(sig, 3, 8, arrival_rate=5.6,
                                        seed=0))
    return sd


def _backoff(p, m, sig):
    sd = m.serve(chunk=CHUNK)
    sd.submit("s", sig)
    sd.drain()
    return sd


SERVE_CASES = {
    "tiered_1_slot": (_interleaved, dict(backend="tiered", tiles=8,
                                         cache_slots=1)),
    "tiered_replicas": (_interleaved, dict(backend="tiered", tiles=16,
                                           cache_slots=2,
                                           cache_replicas=3)),
    "replicated": (_interleaved, {}),
    "tiered_ladder": (_ladder, dict(backend="tiered", tiles=16,
                                    cache_slots=4)),
    "retry_backoff_clock": (_backoff, dict(backend="tiered", tiles=8,
                                           cache_slots=4, cache_retries=64,
                                           cache_backoff=0.5)),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_driver_equals_jax(setup, case):
    """``ServeDriver`` over a tiered (or the replicated) mapper: stream
    states and reports, events, the virtual clock (storage backoff
    included), counters and cache telemetry equal the JAX package's."""
    drive, kw = SERVE_CASES[case]
    runs = {}
    for pkg in ("jax", "torch"):
        p = PKGS[pkg]
        kw_p = dict(kw)
        if case == "retry_backoff_clock":
            kw_p["fault_plan"] = p.core.FaultPlan(seed=2, p_read_error=0.5)
        m = _mapper(setup, pkg, **kw_p)
        sd = drive(p, m, setup[1].signals)
        runs[pkg] = (sd, m)
    (gsd, gm), (wsd, wm) = runs["torch"], runs["jax"]
    np.testing.assert_equal(_serve_state(gsd), _serve_state(wsd))
    for sid in wsd.stream_ids():
        g, w = gsd.results(sid), wsd.results(sid)
        for f in ("t_start", "score", "mapped", "n_events"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert set(gsd.counters) == set(T.stages.CHUNK_COUNTER_SCHEMA)
    if gm.cache is None:
        assert wm.cache is None
    else:
        assert _telemetry(gm.cache) == _telemetry(wm.cache)
    if case == "retry_backoff_clock":
        ok = _backoff(PKGS["torch"], _mapper(setup, "torch", **{
            k: v for k, v in kw.items() if not k.startswith("cache_r")
            and k != "cache_backoff"}), setup[1].signals)
        assert gm.cache.vtime_penalty > 0.0 and gsd.clock > ok.clock
        np.testing.assert_array_equal(gsd.results("s").mapped,
                                      ok.results("s").mapped)


# --------------------------------------------------------------------------- #
# The launcher's --fault-plan path
# --------------------------------------------------------------------------- #
def _lines(text):
    """The launcher's lines without host-clock times: [setup] dropped, the
    [serve] line from its wall clause on."""
    out = []
    for line in text.splitlines():
        if line.startswith("[setup]"):
            continue
        if line.startswith("[serve]"):
            line = "[serve] " + line.split("); ", 1)[1]
        out.append(line)
    return out


def test_launcher_fault_plan_equals_jax(capsys):
    """``serve_rsga --fault-plan`` serves through the tiered index with the
    seeded plan at page-in and prints the JAX launcher's [serve],
    [storage], [model] and [skew] lines."""
    argv = ["--dataset", "D1", "--streams", "4", "--reads-per-stream", "8",
            "--fault-plan", "0", "--tiles", "8", "--cache-slots", "4",
            "--cache-replicas", "2"]
    want = jax_serve_rsga.main(argv)
    want_out = capsys.readouterr().out
    got = serve_rsga.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    lines = _lines(got_out)
    assert lines == _lines(want_out)
    for tag in ("[serve]", "[storage]", "[model]", "[skew]"):
        assert any(line.startswith(tag) for line in lines), tag
    np.testing.assert_equal({k: dataclasses.asdict(v)
                             for k, v in got.items()},
                            {k: dataclasses.asdict(v)
                             for k, v in want.items()})
