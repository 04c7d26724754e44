"""The PyTorch port's serving path against the JAX package's: ``ServeDriver``
(continuous batching, the early-termination prefix ladder, SLO classes,
shedding through the cost model, tenant budgets, the virtual clock and the
event trace), ``Mapper.serve`` and the ``serve_rsga`` launcher.

Each scenario drives the JAX package's driver (its reference plan, on the
CPU) and the port's driver (both plans, on the CPU: the kernel wrappers take
their plain versions) on the same reads and the same trace, each made by
its own package's ``build_trace`` from one seed.  Every stream state and
report, the class and tenant reports, the event trace, the virtual clock,
the chunk and pad counts and the summed counters must be equal.
Tolerance: exact (floats compared by value, NaN equal to NaN).
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as J                                        # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro.launch import serve_rsga as jax_serve_rsga         # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core.index import index_from_numpy           # noqa: E402
from repro_torch.core.realtime import map_realtime            # noqa: E402
from repro_torch.launch import serve_rsga                     # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
CHUNK = 8
MODES = ("ms_fixed", "ms_float", "rh2")
PKGS = {"jax": types.SimpleNamespace(core=J, launch=jax_serve_rsga),
        "torch": types.SimpleNamespace(core=T, launch=serve_rsga)}


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
    ref = simulate.make_reference(8_000, seed=5)
    reads = simulate.sample_reads(ref, 24, signal_len=1024, seed=6,
                                  junk_frac=0.25)
    out = {}
    for mode in MODES:
        cfg_j = J.MarsConfig(hash_bits=12).with_mode(mode)
        cfg_t = T.MarsConfig(hash_bits=12).with_mode(mode)
        jidx = J.build_index(ref.events_concat, ref.n_events, cfg_j)
        tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                                jidx.n_ref_events, cfg_t)
        out[mode] = dict(cfg_j=cfg_j, cfg_t=cfg_t, jidx=jidx, tidx=tidx)
    return reads, out


def _mapper(data, pkg, mode, plan):
    _, per = data
    d = per[mode]
    if pkg == "jax":
        return J.Mapper(d["jidx"], d["cfg_j"])
    return T.Mapper(d["tidx"], d["cfg_t"], use_kernels=plan == "kernels",
                    device="cpu")


# --------------------------------------------------------------------------- #
# Scenarios: each drives one package's ServeDriver and returns it
# --------------------------------------------------------------------------- #
def _trace(p, sig, load, per_stream=8, **kw):
    return p.launch.build_trace(sig, 3, per_stream,
                                arrival_rate=load * CHUNK, seed=0, **kw)


def _plain(p, m, sig):
    sd = p.core.ServeDriver(m, chunk=CHUNK)
    sd.serve_trace(_trace(p, sig, 0.7))
    return sd


def _early_term(p, m, sig):
    sd = p.core.ServeDriver(m, chunk=CHUNK, early_term=True)
    sd.serve_trace(_trace(p, sig, 0.7))
    return sd


def _shed(p, m, sig):
    classes = p.launch.SHED_CLASSES
    sd = p.core.ServeDriver(m, chunk=CHUNK, early_term=True, shed=True,
                            shed_window=2.0, slo_classes=classes)
    sd.serve_trace(_trace(p, sig, 1.3, per_stream=16,
                          slos=[c.name for c in classes]))
    return sd


def _tenants(p, m, sig):
    budgets = tuple(p.core.TenantBudget(f"t{i}", rate=CHUNK / 3)
                    for i in range(3))
    sd = p.core.ServeDriver(m, chunk=CHUNK, shed=True, shed_window=2.0,
                            cost_model="sim",
                            slo_classes=p.launch.SHED_CLASSES,
                            tenant_budgets=budgets)
    sd.serve_trace(_trace(p, sig, 1.3, per_stream=16, tenants=3, skew=1.0,
                          slos=[c.name for c in p.launch.SHED_CLASSES]))
    return sd


def _flood(p, m, sig):
    """The fairness contract's overloads: a flooding tenant with an empty
    budget at a higher priority, an unsheddable class, a full queue that
    evicts, NaN rows refused at admission, deadlines dropped."""
    budgets = (p.core.TenantBudget("acme", rate=10.0),
               p.core.TenantBudget("flood", rate=0.0, burst=1.0))
    gold = p.core.SLOClass("gold", priority=1, sheddable=False)
    sd = p.core.ServeDriver(m, chunk=CHUNK, max_queue=20, shed=True,
                            shed_window=2.0, cost_model="sim",
                            slo_classes=(gold,), tenant_budgets=budgets,
                            drop_expired=True, early_term=True)
    bad = sig[:3].copy()
    bad[1, 7] = np.nan
    sd.submit("a0", sig[:10], tenant="acme", t=0.0)
    sd.submit("g0", np.repeat(sig[13:14], 4, axis=0), tenant="flood",
              slo="gold", t=0.0)
    sd.submit("f0", np.repeat(sig[12:13], 24, axis=0), tenant="flood",
              priority=1, t=0.5)
    sd.submit("a1", bad, tenant="acme", deadline=1.0, t=1.0)
    sd.drain()
    sd.submit("a0", sig[14:20], tenant="acme", t=sd.clock + 3.0)
    sd.drain()
    return sd


SCENARIOS = {
    "plain": ("ms_fixed", _plain),
    "early_term": ("ms_fixed", _early_term),
    "shed": ("ms_fixed", _shed),
    "tenants": ("ms_fixed", _tenants),
    "flood": ("ms_fixed", _flood),
    "early_term_ms_float": ("ms_float", _early_term),
    "early_term_rh2": ("rh2", _early_term),
}
_JAX_RUNS = {}


def _run(data, pkg, name, plan="reference"):
    mode, drive = SCENARIOS[name]
    if pkg == "jax":
        if name not in _JAX_RUNS:
            _JAX_RUNS[name] = drive(PKGS["jax"],
                                    _mapper(data, "jax", mode, plan),
                                    data[0].signals)
        return _JAX_RUNS[name]
    return drive(PKGS["torch"], _mapper(data, "torch", mode, plan),
                 data[0].signals)


def _state(sd):
    """Everything a driver run decides, as plain python values."""
    return dict(
        streams={sid: dataclasses.asdict(st) for sid, st in
                 sd._streams.items()},
        report={k: dataclasses.asdict(v) for k, v in sd.report().items()},
        class_report={k: dataclasses.asdict(v)
                      for k, v in sd.class_report().items()},
        tenant_report={k: dataclasses.asdict(v)
                       for k, v in sd.tenant_report().items()},
        tokens={t: sd.tenant_tokens(t) for t in sd.tenant_budgets},
        events=list(sd.events), clock=sd.clock, counters=dict(sd.counters),
        n_chunks=sd.n_chunks, n_pad_rows=sd.n_pad_rows, n_shed=sd.n_shed,
        stages=sd.stages)


@pytest.mark.parametrize("plan", ["kernels", "reference"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serve_driver_equals_jax(data, name, plan):
    want = _run(data, "jax", name)
    got = _run(data, "torch", name, plan)
    gs, ws = _state(got), _state(want)
    assert gs["events"] == ws["events"]
    assert gs["clock"] == ws["clock"]
    assert gs["counters"] == ws["counters"]
    assert set(gs["counters"]) >= set(T.stages.CHUNK_COUNTER_SCHEMA)
    np.testing.assert_equal(gs, ws)
    for sid in want.stream_ids():
        g, w = got.results(sid), want.results(sid)
        assert isinstance(g, T.MapOutput) and g.counters == {}
        for f in ("t_start", "score", "mapped", "n_events"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, (sid, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{sid} {f}")
    # the scenario exercises what it is named for
    assert got.n_chunks > 1 and got.counters["n_reads"] > 0
    if name in ("shed", "tenants", "flood"):
        assert got.n_shed > 0
    if name == "flood":
        assert got.stream("a1").n_nonfinite == 1
        assert got.tenant_report()["flood"].n_over_budget > 0


def _stream_rows(trace):
    """Each stream's signals in the order serve_trace admits them."""
    rows = {}
    for t, sid, sig, *_ in sorted(trace, key=lambda r: r[0]):
        rows.setdefault(sid, []).append(sig)
    return {sid: np.stack(v) for sid, v in rows.items()}


@pytest.mark.parametrize("plan", ["kernels", "reference"])
@pytest.mark.parametrize("early_term", [False, True])
def test_stream_results_equal_batch_mapping(data, early_term, plan):
    """Per-stream results equal the port's batch paths on that stream's
    reads alone: ``Mapper.map_signals`` (early_term off) and
    ``map_realtime`` (on), whatever the interleaving."""
    reads, per = data
    d = per["ms_fixed"]
    mapper = T.Mapper(d["tidx"], d["cfg_t"], use_kernels=plan == "kernels",
                      device="cpu")
    trace = serve_rsga.build_trace(reads.signals, 3, 8, arrival_rate=5.6)
    sd = mapper.serve(chunk=CHUNK, early_term=early_term)
    assert isinstance(sd, T.ServeDriver)
    sd.serve_trace(trace)
    for sid, sig in _stream_rows(trace).items():
        got = sd.results(sid)
        if early_term:
            want = map_realtime(sig, d["tidx"], d["cfg_t"], chunk=CHUNK,
                                use_kernels=plan == "kernels", device="cpu")
            st = sd.stream(sid)
            np.testing.assert_array_equal(st.samples_used, want.samples_used)
            np.testing.assert_array_equal(st.stage_of, want.stage_of)
        else:
            want = mapper.map_signals(sig, chunk=CHUNK)
            np.testing.assert_array_equal(got.n_events, want.n_events)
        np.testing.assert_array_equal(got.t_start, want.t_start)
        np.testing.assert_array_equal(got.score, want.score)
        np.testing.assert_array_equal(got.mapped, want.mapped)


def test_build_trace_equals_jax(data):
    sig = data[0].signals
    for kw in (dict(), dict(slos=["gold", "best_effort"]),
               dict(tenants=3, skew=1.0), dict(priorities=(0, 2, 1))):
        want = jax_serve_rsga.build_trace(sig, 4, 5, 3.3, seed=2, **kw)
        got = serve_rsga.build_trace(sig, 4, 5, 3.3, seed=2, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[1] == w[1] and g[3:] == w[3:]
            np.testing.assert_array_equal(g[2], w[2])


def test_early_term_ladder_resolves_early_reads(data):
    """The Read Until win: the port's ladder resolves most reads before
    full length, through the same per-stage programs as map_realtime."""
    reads, per = data
    sd = _run(data, "torch", "early_term", "kernels")
    used = np.concatenate([sd.stream(s).samples_used
                           for s in sd.stream_ids()])
    assert (used < 1024).mean() > 0.5
    assert sd.stages == (256, 512, 768, 1024)


# --------------------------------------------------------------------------- #
# The launcher
# --------------------------------------------------------------------------- #
def _lines(text):
    """The launcher's output lines without host-clock times: the [setup]
    line is dropped and the [serve] line keeps what follows its wall
    clause (chunks, pad rows, virtual makespan)."""
    out = []
    for line in text.splitlines():
        if line.startswith("[setup]"):
            continue
        if line.startswith("[serve]"):
            line = "[serve] " + line.split("); ", 1)[1]
        out.append(line)
    return out


LAUNCH_ARGS = {
    "early_term_sim": ["--early-term", "--model", "sim"],
    "shed_tenants": ["--load", "1.3", "--shed", "--tenants", "2", "--skew",
                     "1.0", "--n-failed", "1"],
}


@pytest.mark.parametrize("case", list(LAUNCH_ARGS))
def test_launcher_equals_jax(case, capsys):
    """The port's launcher (kernels plan, on the CPU) prints the JAX
    launcher's lines and returns equal reports."""
    argv = ["--dataset", "D1", "--streams", "2", "--reads-per-stream", "4",
            "--chunk", "4", *LAUNCH_ARGS[case]]
    want = jax_serve_rsga.main(argv)
    want_out = capsys.readouterr().out
    got = serve_rsga.main(argv + ["--use-kernels", "--device", "cpu"])
    got_out = capsys.readouterr().out
    assert _lines(got_out) == _lines(want_out)
    assert any(line.startswith("[model]") for line in _lines(got_out))
    np.testing.assert_equal({k: dataclasses.asdict(v)
                             for k, v in got.items()},
                            {k: dataclasses.asdict(v)
                             for k, v in want.items()})


def test_launcher_refuses_fault_plan():
    """``--fault-plan`` serves through the tiered index, whose tiles split
    the buckets by powers of two: both launchers refuse any other tile
    count.  (``tests/test_torch_tiered.py`` holds the path itself against
    the JAX launcher.)"""
    argv = ["--dataset", "D1", "--streams", "1", "--reads-per-stream", "2",
            "--fault-plan", "3", "--tiles", "6"]
    with pytest.raises(ValueError, match="power of two"):
        jax_serve_rsga.main(argv)
    with pytest.raises(ValueError, match="power of two"):
        serve_rsga.main(argv + ["--device", "cpu"])


def test_serve_driver_guards(data):
    reads, per = data
    d = per["ms_fixed"]
    m = T.Mapper(d["tidx"], d["cfg_t"], device="cpu")
    with pytest.raises(ValueError, match="signals"):
        T.ServeDriver(m, chunk=4).submit("s", np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="signal_len"):
        T.ServeDriver(m, early_term=True, prefix_stages=(256, 512))
    with pytest.raises(ValueError, match="SLO class"):
        T.ServeDriver(m).submit("s", reads.signals[:1], slo="nope")
    with pytest.raises(ValueError, match="shed_window"):
        T.ServeDriver(m, shed_window=0.0)
    with pytest.raises(ValueError, match="unknown cost model"):
        T.ServeDriver(m, cost_model="mqsim")
    assert m.cache is None
    assert math.isinf(T.SLOClass("x").deadline)
