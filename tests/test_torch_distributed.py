"""The PyTorch port's multi-device mapper against the JAX package's single
device: ``map_chunk_sharded`` / ``sharded_chunk_fn``, the ``query:ring``
and ``query:a2a`` partitioned-index backends, ``make_distributed_mapper``,
``Mapper(mesh=...)`` under ``ServeDriver`` and the realtime ladder, the
tiered cache's pre-pass reuse under a mesh, ``repartition_index``, and the
two kernel wrappers' repaired inputs (``sort_rows`` past 8192 keys).

The ranks are gloo process groups on the CPU, spawned once for the module
(``launch/mesh.run_ranks``): a (2, 2) ('data', 'model') mesh of 4 ranks
runs every case of the JAX package's distributed tests that takes that
mesh, and a (2, 2, 2) ('pod', 'data', 'model') mesh of 8 ranks the
``make_distributed_mapper`` case.  The ranks import torch and repro_torch
only (this module imports the JAX package inside its fixtures); they get
the numpy inputs the JAX oracles get and return numpy results, which every
rank must give alike.  The inputs are the JAX tests': a 50,000-base
reference (seed 3), ``MarsConfig(hash_bits=14)``, 16 reads (seed 4); the
pre-pass case's 20,000 bases at ``hash_bits=12``.  Tolerance: exact, on
every ``MapOutput`` field and every ``CHUNK_COUNTER_SCHEMA`` counter.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
FIELDS = ("t_start", "score", "mapped", "n_events")
PLANS = ("reference", "kernels", "ring", "a2a")
SERVE_BACKENDS = ("reference", "ring", "a2a", "tiered")
CHUNK = 8
MESH4 = ((2, 2), ("data", "model"))
MESH8 = ((2, 2, 2), ("pod", "data", "model"))


# --------------------------------------------------------------------------- #
# Rank side (torch and repro_torch only)
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


def _index(planes, mode="ms_fixed", **cfg_kw):
    from repro_torch.core import MarsConfig
    from repro_torch.core.index import index_from_numpy
    cfg = MarsConfig(**cfg_kw).with_mode(mode)
    return cfg, index_from_numpy(*planes, cfg)


def _host(out):
    return ({f: np.asarray(getattr(out, f).cpu() if torch.is_tensor(
                getattr(out, f)) else getattr(out, f)) for f in FIELDS},
            {k: int(v) for k, v in out.counters.items()})


def _interleave(seed):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, 3, 16)
    order = rng.permutation(16)
    return order, {f"s{k}": [int(r) for r in order if owner[r] == k]
                   for k in range(3)}


def _serve(mapper, signals, seed, **kw):
    """One ServeDriver run over a seeded interleaving of 3 streams."""
    from repro_torch.core import ServeDriver
    order, streams = _interleave(seed)
    sd = ServeDriver(mapper, chunk=CHUNK, **kw)
    for r in order:
        sid = next(s for s, rows in streams.items() if int(r) in rows)
        sd.submit(sid, signals[int(r)])
    sd.drain()
    res = {}
    for sid, rows in streams.items():
        if rows:
            got = sd.results(sid)
            res[sid] = dict({f: np.asarray(getattr(got, f)) for f in FIELDS},
                            samples_used=np.asarray(
                                sd.stream(sid).samples_used))
    return dict(counters=dict(sd.counters), streams=res)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def ranks_2x2(inp):
    """Every case on the (2, 2) mesh; returns this rank's numpy results."""
    from repro_torch.core import Mapper, stages
    from repro_torch.core.index import index_arrays, partition_index
    from repro_torch.core.pipeline import map_chunk_sharded
    from repro_torch.distributed.sharding import local_partition
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(*MESH4, device="cpu")
    sig = inp["signals"]
    out = dict(rank=mesh.rank, coords=mesh.coords, backend=mesh.backend,
               chunks={}, serve={}, prepass={})
    # (1) every plan, compaction on and off, with and without pad rows
    for compaction in (True, False):
        cfg, idx = _index(inp["planes"], hash_bits=14,
                          chain_compaction=compaction)
        for name in PLANS:
            plan = stages.resolve_plan(cfg, name)
            arrays = (local_partition(partition_index(idx, 2), mesh)
                      if stages.plan_index_kind(plan) == "partitioned"
                      else index_arrays(idx, "cpu"))
            for nv in (16, 14):
                out["chunks"][(name, compaction, nv)] = _host(
                    map_chunk_sharded(sig, arrays, cfg, mesh, plan=plan,
                                      n_valid=nv))
    cfg, idx = _index(inp["planes"], hash_bits=14)
    out["mapper_ring"] = _host(Mapper(idx, cfg, backend="ring", mesh=mesh)
                               .map_signals(sig[:14], chunk=CHUNK))
    # (3) serving over a mesh Mapper, early termination off and on
    ladder = (cfg.signal_len // 2, cfg.signal_len)
    for backend in SERVE_BACKENDS:
        mapper = Mapper(idx, cfg, backend=backend, mesh=mesh)
        for seed in (0, 1, 2):
            out["serve"][(backend, seed, False)] = _serve(mapper, sig, seed)
            out["serve"][(backend, seed, True)] = _serve(
                mapper, sig, seed, early_term=True, prefix_stages=ladder)
    from repro_torch.core.realtime import map_realtime
    out["realtime"] = {}
    for backend in SERVE_BACKENDS:
        rt = map_realtime(sig, idx, cfg, stages=ladder, chunk=CHUNK,
                          backend=backend, mesh=mesh)
        out["realtime"][backend] = {f: np.asarray(getattr(rt, f)) for f in (
            "t_start", "score", "mapped", "samples_used", "stage_of")}
    # (4) the tiered pre-pass's planes, reused or not, under the mesh
    cfg12, idx12 = _index(inp["planes12"], hash_bits=12)
    for reuse in (True, False):
        m = Mapper(idx12, cfg12, backend="tiered", tiles=8, cache_slots=4,
                   mesh=mesh, reuse_prepass=reuse)
        assert m.cache.reuse_prepass == reuse and m.cache.device == mesh.device
        out["prepass"][reuse] = _host(m.chunk_fn()(inp["signals12"], 16))
    # (6) what the sharded path refuses
    out["errors"] = dict(
        rows=_error(lambda: map_chunk_sharded(
            sig[:6], index_arrays(idx, "cpu"), cfg, mesh)),
        nccl=_error(lambda: make_mesh(*MESH4, device="cpu",
                                      backend="nccl")),
        replicated_to_ring=_error(lambda: map_chunk_sharded(
            sig, index_arrays(idx, "cpu"), cfg, mesh,
            plan=stages.resolve_plan(cfg, "ring"))),
        whole_partitions=_error(lambda: map_chunk_sharded(
            sig, {k: torch.from_numpy(v)
                  for k, v in partition_index(idx, 2).items()}, cfg, mesh,
            plan=stages.resolve_plan(cfg, "a2a"))))
    out["stats"] = dict(mesh.stats)
    return out


def ranks_2x2x2(inp):
    """``make_distributed_mapper`` on the (2, 2, 2) mesh."""
    from repro_torch.core import distributed as D
    from repro_torch.distributed.sharding import shard
    from repro_torch.launch.mesh import axis_size, dp_axes, make_mesh, tp_axis
    torch.set_num_threads(1)
    mesh = make_mesh(*MESH8, device="cpu")
    helpers = (dp_axes(mesh), tp_axis(mesh), axis_size(mesh, dp_axes(mesh)),
               axis_size(mesh, "model"), axis_size(mesh, None))
    cfg, idx = _index(inp["planes"], hash_bits=14)
    _, part_layout = D.input_shardings(mesh)
    parts = {k: shard(v, mesh, part_layout[k])
             for k, v in D.partition_index(idx, mesh.shape["model"]).items()}
    res = {}
    for sched in ("ring", "a2a"):
        t, s, m, counters = D.make_distributed_mapper(cfg, mesh, sched)(
            inp["signals"], parts)
        res[sched] = ({"t_start": t.numpy(), "score": s.numpy(),
                       "mapped": m.numpy()},
                      {k: int(v) for k, v in counters.items()})
    return dict(rank=mesh.rank, coords=mesh.coords, res=res, helpers=helpers)


# --------------------------------------------------------------------------- #
# Parent side: the JAX oracles, one spawn of each mesh
# --------------------------------------------------------------------------- #
def _jax_host(out):
    return ({f: np.asarray(getattr(out, f)) for f in FIELDS
             if getattr(out, f, None) is not None},
            {k: int(v) for k, v in out.counters.items()})


@pytest.fixture(scope="module")
def oracle():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as J
    from repro.core.index import index_arrays
    from repro.core.pipeline import map_chunk
    from repro.core.realtime import map_realtime
    from repro.signal import simulate

    ref = simulate.make_reference(50_000, seed=3)
    cfg = J.MarsConfig(hash_bits=14).with_mode("ms_fixed")
    reads = simulate.sample_reads(ref, 16, signal_len=cfg.signal_len, seed=4,
                                  junk_frac=0.25)
    reads10 = simulate.sample_reads(ref, 16, signal_len=cfg.signal_len,
                                    seed=4, junk_frac=0.1)
    idx = J.build_index(ref.events_concat, ref.n_events, cfg)
    arrays = {k: jnp.asarray(v) for k, v in index_arrays(idx).items()}
    chunks = {}
    for compaction in (True, False):
        c = cfg.replace(chain_compaction=compaction)
        for nv in (16, 14):
            chunks[(compaction, nv)] = _jax_host(map_chunk(
                jnp.asarray(reads.signals), arrays, c, n_valid=nv))
    solo = J.Mapper(idx, cfg)
    ladder = (cfg.signal_len // 2, cfg.signal_len)
    rt = map_realtime(reads.signals, idx, cfg, stages=ladder, chunk=CHUNK)
    serve = {}
    for seed in (0, 1, 2):
        _, streams = _interleave(seed)
        flat = [r for rows in streams.values() for r in rows]
        serve[seed] = dict(
            counters={k: int(v) for k, v in solo.map_signals(
                reads.signals[np.asarray(flat)], chunk=CHUNK).counters.items()},
            streams={sid: _jax_host(solo.map_signals(
                reads.signals[np.asarray(rows)], chunk=CHUNK))[0]
                for sid, rows in streams.items() if rows})

    ref12 = simulate.make_reference(20_000, seed=3)
    cfg12 = J.MarsConfig(hash_bits=12).with_mode("ms_fixed")
    reads12 = simulate.sample_reads(ref12, 16, signal_len=cfg12.signal_len,
                                    seed=4, junk_frac=0.3)
    idx12 = J.build_index(ref12.events_concat, ref12.n_events, cfg12)
    prepass = _jax_host(J.Mapper(idx12, cfg12, backend="tiered", tiles=8,
                                 cache_slots=4).chunk_fn()(reads12.signals,
                                                           16))
    planes = (*(getattr(idx, n) for n in PLANES), idx.n_ref_events)
    planes12 = (*(getattr(idx12, n) for n in PLANES), idx12.n_ref_events)
    return dict(
        inputs=dict(signals=reads.signals, planes=planes,
                    signals12=reads12.signals, planes12=planes12),
        signals10=reads10.signals,
        chunks=chunks, chunk10=_jax_host(map_chunk(
            jnp.asarray(reads10.signals), arrays, cfg)),
        mapper14=_jax_host(J.driver.collect(J.driver.stream_map(
            solo.chunk_fn(), J.driver.array_chunks(reads.signals[:14],
                                                   CHUNK)))),
        serve=serve, rt=rt, prepass=prepass)


@pytest.fixture(scope="module")
def mesh4(oracle):
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(ranks_2x2, 4, oracle["inputs"], timeout=240)


@pytest.fixture(scope="module")
def mesh8(oracle):
    from repro_torch.launch.mesh import run_ranks
    inp = dict(oracle["inputs"], signals=oracle["signals10"])
    return run_ranks(ranks_2x2x2, 8, inp, timeout=240)


def _equal(got, want, tag):
    for f, w in want[0].items():
        np.testing.assert_array_equal(got[0][f], w, err_msg=f"{tag} {f}")
    assert got[1] == want[1], (tag, got[1], want[1])


def test_ranks_sit_row_major_on_a_gloo_mesh(mesh4, mesh8):
    for runs, shape, axes in ((mesh4, *MESH4), (mesh8, *MESH8)):
        assert [r["rank"] for r in runs] == list(range(len(runs)))
        for r in runs:
            assert tuple(r["coords"][a] for a in axes) == tuple(
                np.unravel_index(r["rank"], shape))
    assert {r["backend"] for r in mesh4} == {"gloo"}


def test_mesh_axis_helpers(mesh8):
    """``dp_axes`` / ``tp_axis`` / ``axis_size`` as the JAX package's
    ``launch/mesh.py`` defines them, on the (2, 2, 2) mesh."""
    for r in mesh8:
        assert r["helpers"] == (("pod", "data"), "model", 4, 2, 1)


@pytest.mark.parametrize("nv", [16, 14])
@pytest.mark.parametrize("compaction", [True, False])
@pytest.mark.parametrize("plan", PLANS)
def test_sharded_chunk_equals_jax_map_chunk(mesh4, oracle, plan, compaction,
                                            nv):
    """``test_distributed_stages.py``'s grid: every plan over the (2, 2)
    mesh equals single-device ``map_chunk`` on every rank."""
    want = oracle["chunks"][(compaction, nv)]
    for r in mesh4:
        _equal(r["chunks"][(plan, compaction, nv)], want,
               (plan, compaction, nv, r["rank"]))


def test_mapper_ring_streams_equal_jax_driver(mesh4, oracle):
    for r in mesh4:
        _equal(r["mapper_ring"], oracle["mapper14"], r["rank"])


@pytest.mark.parametrize("sched", ["ring", "a2a"])
def test_distributed_mapper_on_three_axes_equals_jax(mesh8, oracle, sched):
    """``test_mars_distributed.py``: the wrapper over a (2, 2, 2) mesh."""
    for r in mesh8:
        got = r["res"][sched]
        assert set(got[1]) == set(oracle["chunk10"][1])
        _equal(got, ({f: oracle["chunk10"][0][f] for f in got[0]},
                     oracle["chunk10"][1]), (sched, r["rank"]))


@pytest.mark.parametrize("early_term", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", SERVE_BACKENDS)
def test_served_streams_equal_jax_single_device(mesh4, oracle, backend, seed,
                                               early_term):
    """``test_distributed_serve.py``'s first test: per-stream results (and,
    early termination off, the counter totals) equal the JAX package's
    single-device ``map_signals``; on, its ``map_realtime``."""
    _, streams = _interleave(seed)
    rt = oracle["rt"]
    for r in mesh4:
        got = r["serve"][(backend, seed, early_term)]
        tag = (backend, seed, early_term, r["rank"])
        if not early_term:
            assert got["counters"] == oracle["serve"][seed]["counters"], tag
        for sid, rows in streams.items():
            if not rows:
                continue
            g = got["streams"][sid]
            if early_term:
                sel = np.asarray(rows)
                want = dict(t_start=rt.t_start[sel], score=rt.score[sel],
                            mapped=rt.mapped[sel],
                            samples_used=rt.samples_used[sel])
            else:
                want = oracle["serve"][seed]["streams"][sid]
            for f, w in want.items():
                np.testing.assert_array_equal(g[f], w, err_msg=str(tag))


@pytest.mark.parametrize("backend", SERVE_BACKENDS)
def test_map_realtime_over_mesh_equals_jax(mesh4, oracle, backend):
    rt = oracle["rt"]
    for r in mesh4:
        for f, g in r["realtime"][backend].items():
            np.testing.assert_array_equal(g, getattr(rt, f),
                                          err_msg=f"{backend} {f}")


@pytest.mark.parametrize("reuse", [True, False])
def test_tiered_prepass_reuse_under_mesh_equals_jax(mesh4, oracle, reuse):
    for r in mesh4:
        _equal(r["prepass"][reuse], oracle["prepass"], (reuse, r["rank"]))


@pytest.mark.parametrize("case,match", [
    ("rows", "chunk of 6 reads does not shard over 4 devices"),
    ("nccl", "needs a card per rank"),
    ("replicated_to_ring", "partitioned query backend needs index keys"),
    ("whole_partitions", "ONE resident partition per rank"),
])
def test_sharded_path_refuses(mesh4, case, match):
    for r in mesh4:
        assert r["errors"][case] is not None and match in r["errors"][case]


def test_collectives_moved_bytes_and_staged_none_on_the_cpu(mesh4):
    for r in mesh4:
        s = r["stats"]
        for kind in ("all_gather", "all_reduce", "ring", "all_to_all"):
            assert s[f"{kind}_calls"] > 0 and s[f"{kind}_bytes"] > 0, kind
        assert "staged_bytes" not in s


# --------------------------------------------------------------------------- #
# Single-process checks
# --------------------------------------------------------------------------- #
def test_partitioned_plan_rejected_by_map_chunk():
    from repro_torch.core import MarsConfig, stages
    from repro_torch.core.pipeline import map_chunk
    cfg = MarsConfig(hash_bits=14)
    for name in ("ring", "a2a"):
        plan = stages.resolve_plan(cfg, name)
        assert dict(plan)["query"] == name
        assert stages.plan_index_kind(plan) == "partitioned"
        assert all(b == stages.REFERENCE for s, b in plan if s != "query")
        with pytest.raises(ValueError, match="partitioned"):
            map_chunk(torch.zeros((4, cfg.signal_len)), {}, cfg, plan=plan)


def test_partitioned_mapper_needs_a_mesh_with_a_model_axis():
    from repro_torch.core import MarsConfig, Mapper, build_index
    from repro_torch.signal import simulate
    cfg = MarsConfig(hash_bits=10)
    ref = simulate.make_reference(3_000, seed=2)
    idx = build_index(ref.events_concat, ref.n_events, cfg)
    with pytest.raises(ValueError, match="pass a mesh with one"):
        Mapper(idx, cfg, backend="a2a", device="cpu")


def _threads():
    return torch.get_num_threads()


def test_run_ranks_gives_each_rank_its_share_of_the_cores():
    """Ranks spawned on one host split its cores: torch's default of a
    thread a core in every rank would oversubscribe them."""
    import os
    from repro_torch.launch.mesh import run_ranks
    share = max(1, (os.cpu_count() or 1) // 2)
    assert all(1 <= t <= share for t in run_ranks(_threads, 2, timeout=120))


def test_nccl_on_a_shared_card_raises_before_spawning():
    from repro_torch.launch.mesh import run_ranks
    with pytest.raises(ValueError, match="one card per rank"):
        run_ranks(ranks_2x2, 4, {}, backend="nccl")


def test_no_duplicated_per_read_program():
    """The port's core/distributed.py holds no second per-read program:
    the schedules are registered ``query`` backends of the shared chunk
    program."""
    import repro_torch.core.distributed as D
    from repro_torch.core import stages
    src = inspect.getsource(D)
    for name in ("vote_filter", "chain_phase", "_chunk_program",
                 "best_chain", "detect_events"):
        assert name not in src, name
    for name in ("ring", "a2a"):
        b = stages._REGISTRY[("query", name)]
        assert b.index_kind == "partitioned" and b.primitive is None
        assert b.fn is not None


@pytest.fixture(scope="module")
def faults_setup():
    pytest.importorskip("jax")
    import repro.core as J
    from repro.signal import simulate
    ref = simulate.make_reference(8_000, seed=5)
    cfg = J.MarsConfig(hash_bits=12).with_mode("ms_fixed")
    jidx = J.build_index(ref.events_concat, ref.n_events, cfg)
    _, tidx = _index((*(getattr(jidx, n) for n in PLANES),
                      jidx.n_ref_events), hash_bits=12)
    return jidx, tidx


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_repartition_index_equals_jax(faults_setup, n_parts):
    """``test_faults.py``'s rebalance oracle, against the JAX function: the
    folded planes and the remap table for every failed drive."""
    from repro.core.index import repartition_index as jrepartition
    from repro_torch.core.index import partition_index, repartition_index
    jidx, tidx = faults_setup
    fresh = partition_index(tidx, n_parts // 2)
    for failed in range(n_parts):
        parts, remap = repartition_index(tidx, n_parts, failed)
        jparts, jremap = jrepartition(jidx, n_parts, failed)
        assert remap == jremap
        for k in fresh:
            np.testing.assert_array_equal(parts[k], jparts[k])
            np.testing.assert_array_equal(parts[k], fresh[k])
        live = partition_index(tidx, n_parts)
        again, _ = repartition_index(tidx, n_parts, failed, parts=live)
        for k in fresh:
            np.testing.assert_array_equal(again[k], fresh[k])


@pytest.mark.parametrize("n_parts,failed", [(3, 0), (1, 0), (4, 4)])
def test_repartition_index_refuses_what_jax_refuses(faults_setup, n_parts,
                                                    failed):
    from repro.core.index import repartition_index as jrepartition
    from repro_torch.core.index import repartition_index
    jidx, tidx = faults_setup
    with pytest.raises(ValueError) as want:
        jrepartition(jidx, n_parts, failed)
    with pytest.raises(ValueError) as got:
        repartition_index(tidx, n_parts, failed)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("L", [8193, 16384])
def test_sort_rows_past_one_block_equals_jax_sort_batch(L):
    """Repair of the sort wrapper: rows that pad past 8192 keys take the
    counted ``torch.sort`` route, as ``sort_batch`` takes ``jnp.sort``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.bitonic_sort import ops as jsort
    from repro_torch import kernels as K
    from repro_torch.kernels.bitonic_sort import ops
    from repro_torch.kernels.fixtures import edge_rows
    keys = edge_rows(np.random.default_rng(L), 6, L)
    K.reset_launches()
    got = ops.sort_rows(torch.from_numpy(keys))
    assert K.LAUNCHES["sort_rows_library"] == 1
    assert K.LAUNCHES["bitonic_sort"] == 0
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsort.sort_batch(
                                      jnp.asarray(keys))))
