"""The port's stage engine against the JAX package's: the registry rules,
the plans (equal under the name map ``pallas`` -> ``kernels``),
``cheap_phase_vmap``, ``map_read``, the whole-graph chunk route
(``chain_compaction`` off, pad rows), the two custom-backend routes (a
state-dict-only sort, a registered vote) and every pre-fast-path
reference, in ms_fixed, ms_float and rh2.  The JAX side runs its reference
plan (its own tests hold its ``pallas`` plan to that), compiled with jit.
On the CPU the port's kernels plan runs the kernels' plain versions.
Tolerance: exact."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import chaining as jchaining                  # noqa: E402
from repro.core import events as jevents                      # noqa: E402
from repro.core import pipeline as jpipe                      # noqa: E402
from repro.core import seeding as jseeding                    # noqa: E402
from repro.core import stages as jstages                      # noqa: E402
from repro.core import vote as jvote                          # noqa: E402
from repro.core.index import index_arrays as jax_index_arrays  # noqa: E402
from repro.core.index import index_arrays_unpacked as jax_unpacked  # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core import (MarsConfig, chaining, events,   # noqa: E402
                              map_chunk, map_read, pipeline, seeding,
                              stages, vote)
from repro_torch.core.index import (index_arrays,             # noqa: E402
                                    index_arrays_unpacked, index_from_numpy)
from repro_torch.signal import simulate as tsimulate          # noqa: E402

MODES = ("ms_fixed", "ms_float", "rh2")
PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
FIELDS = ("t_start", "score", "mapped", "n_events")
NAME = {jstages.PALLAS: stages.KERNELS}
R = 12                 # reads a chunk: mapped reads, junk, a pad row or two


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """Per mode: both configs, one reference of 12,000 bases, R reads (a
    quarter junk, so rows differ in event and anchor counts), the JAX
    index and the port's over the same planes."""
    ref = simulate.make_reference(12_000, seed=21)
    out = {}
    for mode in MODES:
        cfg_j = JaxConfig(hash_bits=12).with_mode(mode)
        cfg_t = MarsConfig(hash_bits=12).with_mode(mode)
        reads = simulate.sample_reads(ref, R, signal_len=cfg_t.signal_len,
                                      seed=22, junk_frac=0.25)
        jidx = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
        tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                                jidx.n_ref_events, cfg_t)
        jarr = {k: jnp.asarray(v) for k, v in jax_index_arrays(jidx).items()}
        out[mode] = dict(cfg_j=cfg_j, cfg_t=cfg_t, sig=reads.signals,
                         jidx=jidx, tidx=tidx, jarr=jarr,
                         tarr=index_arrays(tidx, "cpu"))
    return out


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    assert got.dtype == want.dtype or msg.startswith("keys"), (
        msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _eq_counters(got, want, msg=""):
    assert set(got) == set(want), (msg, set(got) ^ set(want))
    for k in want:
        _eq(got[k], want[k], f"{msg} counter {k}")


def _eq_output(got, want, msg=""):
    for f in FIELDS:
        _eq(getattr(got, f), getattr(want, f), f"{msg} {f}")
    assert set(got.counters) == set(want.counters) == set(
        stages.CHUNK_COUNTER_SCHEMA)
    for k in want.counters:
        assert int(got.counters[k]) == int(want.counters[k]), (msg, k)


_JIT = {}


def _jit(fn, cfg, batched=True, **kw):
    """``fn`` with its config (and ``kw``) bound, over a batch of reads
    when ``batched`` (``jax.vmap``), jit-compiled once per (fn, config)."""
    key = (fn, cfg, batched, tuple(kw))
    if key not in _JIT:
        f = functools.partial(fn, cfg=cfg, **kw)
        _JIT[key] = jax.jit(jax.vmap(f) if batched else f)
    return _JIT[key]


@pytest.fixture(scope="module")
def jax_cheap(data):
    """JAX ``cheap_phase_vmap`` under its reference plan, per mode."""
    out = {}
    for mode, d in data.items():
        cfg = d["cfg_j"]
        plan = jstages.resolve_plan(cfg, jstages.REFERENCE)
        fn = _jit(jpipe.cheap_phase_vmap, cfg, batched=False, plan=plan)
        out[mode] = fn(jnp.asarray(d["sig"]), d["jarr"])
    return out


# --------------------------------------------------------------------------- #
# Registry and plans
# --------------------------------------------------------------------------- #
def test_reference_plan_covers_every_stage():
    assert stages.STAGE_ORDER == jstages.STAGE_ORDER
    assert stages.CHEAP_STAGES == jstages.CHEAP_STAGES
    assert stages.CHAIN_STAGES == jstages.CHAIN_STAGES
    plan = stages.resolve_plan(MarsConfig(), stages.REFERENCE)
    assert tuple(s for s, _ in plan) == stages.STAGE_ORDER
    assert all(b == stages.REFERENCE for _, b in plan)
    for s in stages.STAGE_ORDER:
        assert stages.get_backend(s, stages.REFERENCE).primitive is None
        assert stages.REFERENCE in stages.registered_backends(s)


def test_kernels_plan_and_unsupported_fallback():
    plan = dict(stages.resolve_plan(MarsConfig(), stages.KERNELS))
    assert {s for s, b in plan.items() if b == stages.KERNELS} == {
        "detect", "query", "sort", "dp"}
    for s in ("detect", "query", "sort", "dp"):
        b = stages.get_backend(s, stages.KERNELS)
        assert b.fn is not None and b.primitive is not None
    rh2 = dict(stages.resolve_plan(MarsConfig().with_mode("rh2"),
                                   stages.KERNELS))
    assert rh2["detect"] == stages.REFERENCE
    assert rh2["query"] == stages.KERNELS


def test_registration_rules_equal_jax():
    body = lambda st, cfg, index: st                      # noqa: E731
    for mod, cfg in ((stages, MarsConfig()), (jstages, JaxConfig())):
        mod.resolve_plan(cfg, NAME.get(jstages.PALLAS) if mod is stages
                         else jstages.PALLAS)     # loads the fused kernel
        with pytest.raises(ValueError, match="unknown backend"):
            mod.resolve_plan(cfg, "bogus")
        with pytest.raises(ValueError, match="already registered"):
            mod.register_backend("vote", mod.REFERENCE, body)
        with pytest.raises(ValueError, match="unknown stage"):
            mod.register_backend("no_such_stage", "x", body)
        with pytest.raises(ValueError, match="unknown index_kind"):
            mod.register_backend("query", "x", body, index_kind="bogus")
        with pytest.raises(ValueError, match="already registered"):
            mod.register_fused_cheap(list(mod._FUSED_CHEAP)[0], body)
    # replace=True re-registers (here: the same body again)
    ref = stages.get_backend("vote", stages.REFERENCE)
    stages.register_backend("vote", stages.REFERENCE, ref.fn, replace=True)
    assert stages.get_backend("vote", stages.REFERENCE) == ref


def _kernel_support_configs(mod):
    base = mod(hash_bits=12)
    return (base.with_mode("ms_fixed"), base.with_mode("ms_float"),
            base.with_mode("rh2"),
            base.with_mode("ms_fixed").replace(tstat_window=13))


@pytest.mark.parametrize("backend", ["pallas", "ring", "a2a", "tiered"])
@pytest.mark.parametrize("which", range(4))
def test_plan_equals_jax(backend, which):
    """The port's plan is the JAX plan with ``pallas`` named ``kernels``,
    for every config and backend of scripts/kernel_support.py, and the
    fused cheap kernel engages for the same ones."""
    cfg_j = _kernel_support_configs(JaxConfig)[which]
    cfg_t = _kernel_support_configs(MarsConfig)[which]
    plan_j = jstages.resolve_plan(cfg_j, backend)
    plan_t = stages.resolve_plan(cfg_t, NAME.get(backend, backend))
    assert plan_t == tuple((s, NAME.get(b, b)) for s, b in plan_j)
    fj = jstages.fused_cheap_backend(plan_j, cfg_j)
    ft = stages.fused_cheap_backend(plan_t, cfg_t)
    assert (ft is None) == (fj is None)
    assert stages.plan_index_kind(plan_t) == jstages.plan_index_kind(plan_j)
    assert (stages.chain_primitives(plan_t, cfg_t) is None) == (
        jstages.chain_primitives(plan_j, cfg_j) is None)
    assert (stages.cheap_primitives(plan_t, cfg_t) is None) == (
        jstages.cheap_primitives(plan_j, cfg_j) is None)


# --------------------------------------------------------------------------- #
# The per-read routes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", MODES)
def test_cheap_phase_vmap_equals_jax(data, jax_cheap, mode):
    """Both plans' stage bodies (the kernels plan's through the kernels'
    plain versions on the CPU), and the shipped ladder, equal JAX's
    ``cheap_phase_vmap`` in every output and per-read counter."""
    d = data[mode]
    want = jax_cheap[mode]
    x = torch.from_numpy(d["sig"])
    for backend in (stages.REFERENCE, stages.KERNELS):
        plan = stages.resolve_plan(d["cfg_t"], backend)
        for label, got in (
                ("vmap", pipeline.cheap_phase_vmap(x, d["tarr"], d["cfg_t"],
                                                   plan)),
                ("ladder", pipeline.cheap_phase(x, d["tarr"], d["cfg_t"],
                                                plan))):
            msg = f"{mode} {backend} {label}"
            for i, n in enumerate(("q_pos", "t_pos", "hit_valid")):
                _eq(got[i], want[i], f"{msg} {n}")
            _eq_counters(got[3], want[3], msg)


@pytest.mark.parametrize("mode", MODES)
def test_map_read_equals_jax(data, mode):
    """``map_read`` of three reads (a mapped read, another, a junk read)
    under both plans: the ChainResult and the counters of JAX's."""
    d = data[mode]
    cfg_j = d["cfg_j"]
    fn = _jit(jpipe.map_read, cfg_j, batched=False,
              plan=jstages.resolve_plan(cfg_j, jstages.REFERENCE))
    for i in (0, 1, R - 1):
        res_j, cnt_j = fn(jnp.asarray(d["sig"][i]), d["jarr"])
        for backend in (None, stages.KERNELS):
            plan = (None if backend is None
                    else stages.resolve_plan(d["cfg_t"], backend))
            res, cnt = map_read(torch.from_numpy(d["sig"][i]), d["tarr"],
                                d["cfg_t"], plan)
            for f in res_j._fields:
                _eq(getattr(res, f), getattr(res_j, f), f"{mode} {i} {f}")
            _eq_counters(cnt, cnt_j, f"{mode} read {i}")


_GRAPH = {}


def _jax_graph(d):
    """JAX's ``map_chunk`` with ``chain_compaction`` off (its whole-graph
    vmap of ``execute_read``), two pad rows, once per mode."""
    cfg_j = d["cfg_j"].replace(chain_compaction=False)
    if cfg_j not in _GRAPH:
        _GRAPH[cfg_j] = jpipe.map_chunk(jnp.asarray(d["sig"]), d["jarr"],
                                        cfg_j, n_valid=R - 2)
    return _GRAPH[cfg_j]


@pytest.mark.parametrize("mode", MODES)
def test_map_chunk_whole_graph_equals_jax(data, mode):
    """``chain_compaction`` off takes the whole-graph route (every stage
    body over every read, all E*H keys sorted) in both plans; with two pad
    rows it equals JAX's ``map_chunk`` in every field and counter."""
    d = data[mode]
    cfg_t = d["cfg_t"].replace(chain_compaction=False)
    want = _jax_graph(d)
    EH = cfg_t.max_events * cfg_t.max_hits_per_seed
    for use_kernels in (False, True):
        pipeline.CHAIN_ROUTES.clear()
        got = map_chunk(torch.from_numpy(d["sig"]), d["tarr"], cfg_t,
                        use_kernels=use_kernels, n_valid=R - 2)
        assert dict(pipeline.CHAIN_ROUTES) == {("graph", R, EH): 1}
        _eq_output(got, want, f"{mode} kernels={use_kernels}")
    assert not np.asarray(want.mapped)[R - 2:].any()
    assert np.asarray(want.mapped).any()


@pytest.fixture()
def custom_backend(request):
    """Register backend ``name`` of ``stage`` in both packages (a body
    only, no primitive) and take it out again after the test."""
    regs = []

    def register(stage, name, body_t, body_j):
        stages.register_backend(stage, name, body_t)
        jstages.register_backend(stage, name, body_j)
        regs.append((stage, name))
    yield register
    for key in regs:
        del stages._REGISTRY[key]
        del jstages._REGISTRY[key]


def _swap(plan, stage, name):
    return tuple((s, name if s == stage else b) for s, b in plan)


@pytest.mark.parametrize("mode", MODES)
def test_state_dict_only_sort_sends_map_chunk_down_the_whole_graph(
        data, custom_backend, mode):
    """A sort backend without a primitive: ``chain_primitives`` is None in
    both packages, so ``map_chunk`` (compaction on) runs the whole graph,
    as JAX's does; equal to JAX's whole-graph chunk (every JAX plan gives
    the same bits)."""
    d = data[mode]
    custom_backend(
        "sort", "sd_sort",
        lambda st, cfg, index: stages.sort_with(st, cfg, index),
        lambda st, cfg, index: jstages.sort_with(st, cfg, index))
    plan_t = _swap(stages.resolve_plan(d["cfg_t"], stages.KERNELS), "sort",
                   "sd_sort")
    plan_j = _swap(jstages.resolve_plan(d["cfg_j"], jstages.REFERENCE),
                   "sort", "sd_sort")
    assert stages.chain_primitives(plan_t, d["cfg_t"]) is None
    assert jstages.chain_primitives(plan_j, d["cfg_j"]) is None
    pipeline.CHAIN_ROUTES.clear()
    got = map_chunk(torch.from_numpy(d["sig"]), d["tarr"], d["cfg_t"],
                    n_valid=R - 2, plan=plan_t)
    assert [b for b, _, _ in pipeline.CHAIN_ROUTES] == ["graph"]
    _eq_output(got, _jax_graph(d), mode)


@pytest.mark.parametrize("mode", MODES)
def test_custom_vote_sends_cheap_phase_to_the_stage_bodies(
        data, jax_cheap, custom_backend, mode):
    """A registered vote backend: ``cheap_primitives`` is None in both
    packages, so ``cheap_phase`` runs ``cheap_phase_vmap`` (no fused
    kernel, no batch level), equal to JAX's, and ``map_chunk`` chains its
    output, equal to JAX's chunk."""
    d = data[mode]
    custom_backend("vote", "my_vote", stages.vote_ref, jstages.vote_ref)
    plan_t = _swap(stages.resolve_plan(d["cfg_t"], stages.KERNELS), "vote",
                   "my_vote")
    plan_j = _swap(jstages.resolve_plan(d["cfg_j"], jstages.REFERENCE),
                   "vote", "my_vote")
    assert stages.cheap_primitives(plan_t, d["cfg_t"]) is None
    assert jstages.cheap_primitives(plan_j, d["cfg_j"]) is None
    assert stages.fused_cheap_backend(plan_t, d["cfg_t"]) is None
    x = torch.from_numpy(d["sig"])
    got = pipeline.cheap_phase(x, d["tarr"], d["cfg_t"], plan_t)
    want = jax_cheap[mode]
    for i, n in enumerate(("q_pos", "t_pos", "hit_valid")):
        _eq(got[i], want[i], f"{mode} {n}")
    _eq_counters(got[3], want[3], mode)
    _eq_output(map_chunk(x, d["tarr"], d["cfg_t"], n_valid=R - 2,
                         plan=plan_t), _jax_graph(d), mode)


# --------------------------------------------------------------------------- #
# The pre-fast-path references
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", MODES)
def test_detect_events_reference_equals_jax(data, mode):
    """``robust_normalize_reference`` and ``detect_events_reference`` (both
    with the plain segment sum and the kernels plan's, on the CPU its plain
    version) against the compiled JAX functions."""
    from repro_torch.kernels.segment_sum.ops import segment_sum
    d = data[mode]
    cfg_j = d["cfg_j"]
    x = d["sig"]
    norm = jax.jit(jevents.robust_normalize_reference)
    _eq(events.robust_normalize_reference(torch.from_numpy(x)),
        norm(jnp.asarray(x)), "robust_normalize_reference")
    want = _jit(jevents.detect_events_reference, cfg_j)(jnp.asarray(x))
    for seg in (events.segment_sum_in_order, segment_sum):
        got = events.detect_events_reference(torch.from_numpy(x),
                                             d["cfg_t"], seg)
        for n, g, w in zip(("means", "n_events", "counts"), got, want):
            _eq(g, w, f"{mode} {n}")


@pytest.mark.parametrize("mode", MODES)
def test_query_and_vote_references_equal_jax(data, jax_cheap, mode):
    """``index_arrays_unpacked`` + ``query_index_reference`` (and
    ``query_index``'s fall-through to it) and ``vote_filter_reference``
    on the chunk's seeds, against JAX's per read."""
    from repro_torch.kernels.pluto_lookup.ops import lookup
    d = data[mode]
    cfg_j, cfg_t = d["cfg_j"], d["cfg_t"]
    plan = stages.resolve_plan(cfg_t, stages.REFERENCE)
    st = stages.execute_stages({"signal": torch.from_numpy(d["sig"]),
                                "counters": {}}, d["tarr"], cfg_t, plan,
                               ("detect", "quantize", "seed"))
    keys, valid = st["keys"], st["seed_valid"]
    un_t = index_arrays_unpacked(d["tidx"], "cpu")
    un_j = {k: jnp.asarray(v) for k, v in jax_unpacked(d["jidx"]).items()}
    query = jax.jit(jax.vmap(functools.partial(
        jseeding.query_index_reference, cfg=cfg_j), in_axes=(0, 0, None)))
    want = query(jnp.asarray(keys.numpy().astype(np.uint32)),
                 jnp.asarray(valid.numpy()), un_j)
    for label, got in (
            ("reference", seeding.query_index_reference(keys, valid, un_t,
                                                        cfg_t)),
            ("lookup", seeding.query_index_reference(keys, valid, un_t,
                                                     cfg_t, gather=lookup)),
            ("dispatch", seeding.query_index(keys, valid, un_t, cfg_t))):
        _eq(got[0], want[0], f"{mode} {label} t_pos")
        _eq(got[1], want[1], f"{mode} {label} hit_valid")
        _eq_counters(got[2], want[2], f"{mode} {label}")
    q_pos = np.array(jax_cheap[mode][0])
    # the vote's input: the query's hits (before the vote, so the filter
    # has work to do); a pair of far-negative diags exercise the unguarded
    # shift
    t_in = np.asarray(want[0]).copy()
    t_in[0, 0, :2] = -(1 << 21)
    h_in = np.asarray(want[1]).copy()
    h_in[0, 0, :2] = True
    keep_j, cnt_j = _jit(jvote.vote_filter_reference, cfg_j)(jnp.asarray(q_pos), jnp.asarray(t_in),
                           jnp.asarray(h_in))
    keep, cnt = vote.vote_filter_reference(torch.from_numpy(q_pos),
                                           torch.from_numpy(t_in),
                                           torch.from_numpy(h_in), cfg_t)
    _eq(keep, keep_j, f"{mode} vote keep")
    _eq_counters(cnt, cnt_j, f"{mode} vote")


@pytest.mark.parametrize("mode", MODES)
def test_chain_references_equal_jax(data, jax_cheap, mode):
    """``sort_anchors_reference``, ``chain_dp_reference`` (also on
    tie-heavy anchors) and ``chain_anchors`` on the chunk's post-vote
    anchors, against the compiled JAX functions per read."""
    from repro_torch.kernels.bitonic_sort.ops import sort_rows
    from repro_torch.kernels.chain_dp.ops import chain_dp
    from repro_torch.kernels.fixtures import tie_anchors
    d = data[mode]
    cfg_j, cfg_t = d["cfg_j"], d["cfg_t"]
    q, t, h = (np.array(a) for a in jax_cheap[mode][:3])
    qt, tt, ht = (torch.from_numpy(a) for a in (q, t, h))
    sq_j, st_j, sv_j = _jit(jchaining.sort_anchors_reference, cfg_j)(
        *(jnp.asarray(a) for a in (q, t, h)))
    for sorter in (None, sort_rows):
        got = chaining.sort_anchors_reference(qt, tt, ht, cfg_t,
                                              sorter=sorter)
        for n, g, w in zip(("sq", "st", "sv"), got, (sq_j, st_j, sv_j)):
            _eq(g, w, f"{mode} {n}")
    dp_j = _jit(jchaining.chain_dp_reference, cfg_j)
    qq, tq, vq = tie_anchors(np.random.default_rng(3), 4, 96,
                             max_gap=cfg_t.max_gap)
    for label, inputs in (("anchors", (sq_j, st_j, sv_j)),
                          ("ties", (qq, tq, vq))):
        inputs = [np.array(x) for x in inputs]
        want = dp_j(*(jnp.asarray(x) for x in inputs))
        tin = [torch.from_numpy(x) for x in inputs]
        got = chaining.chain_dp_reference(*tin, cfg_t)
        _eq(got[0], want[0], f"{mode} {label} f")
        _eq(got[1], want[1], f"{mode} {label} diag0")
        _eq(chaining.chain_dp(*tin, cfg_t)[0], want[0],
            f"{mode} {label} fast DP")
    res_j, cnt_j = _jit(jchaining.chain_anchors, cfg_j)(
        *(jnp.asarray(a) for a in (q, t, h)))
    for kw in ({}, dict(sorter=sort_rows,
                        dp=lambda a, b, c: chain_dp(a, b, c, cfg_t))):
        res, cnt = chaining.chain_anchors(qt, tt, ht, cfg_t, **kw)
        for f in res_j._fields:
            _eq(getattr(res, f), getattr(res_j, f), f"{mode} {f}")
        _eq_counters(cnt, cnt_j, f"{mode} chain_anchors")


def test_to_forward_coord_equals_jax():
    n = 5_000
    t = np.array([0, 17, n - 1, n, n + 3, 2 * n - 1], np.int32)
    span = np.array([1, 40, 2, 9, 100, 1], np.int64)
    got = tsimulate.to_forward_coord(t, span, n)
    want = simulate.to_forward_coord(t, span, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
