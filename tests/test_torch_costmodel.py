"""The port's cost models against the JAX package's: ``workload``,
``ssd_model`` (analytic), ``sim`` (the discrete-event in-storage simulator),
``costmodel`` (both backends), ``faults`` (the seeded fault draws) and the
driver's ``stream_map(trace=, clock=)`` records.

Every case calls the same function of both packages on equal inputs — the
workloads of the contracts of tests/test_ssd_model.py and
tests/test_sim.py, and one measured by the port's own pipeline — and
requires equal results to the last bit (floats compared by their bits, NaN
equal to NaN; an exception must be of the same type with the same message).
"""
import dataclasses
import math
import struct
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import Mapper as JaxMapper                    # noqa: E402
from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import costmodel as j_cm                      # noqa: E402
from repro.core import driver as j_driver                     # noqa: E402
from repro.core import faults as j_faults                     # noqa: E402
from repro.core import sim as j_sim                           # noqa: E402
from repro.core import ssd_model as j_ssd                     # noqa: E402
from repro.core import workload as j_wl                       # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.core import MarsConfig, Mapper, driver, stages  # noqa: E402
from repro_torch.core import costmodel as t_cm                # noqa: E402
from repro_torch.core import faults as t_faults               # noqa: E402
from repro_torch.core import sim as t_sim                     # noqa: E402
from repro_torch.core import ssd_model as t_ssd               # noqa: E402
from repro_torch.core import workload as t_wl                 # noqa: E402
from repro_torch.core.index import index_from_numpy           # noqa: E402

PLANES = ("bucket_start", "entries_key", "entries_pos", "entries_cnt")
NS = {"jax": types.SimpleNamespace(S=j_ssd, CM=j_cm, SIM=j_sim, WL=j_wl,
                                   F=j_faults),
      "torch": types.SimpleNamespace(S=t_ssd, CM=t_cm, SIM=t_sim, WL=t_wl,
                                     F=t_faults)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b, path="result"):
    """Exact equality of nested results: floats by their bits."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), (path, a, b)
        assert (struct.pack("<d", float(a)) == struct.pack("<d", float(b))
                or (math.isnan(a) and math.isnan(b))), (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _call(fn, ns):
    try:
        return fn(ns)
    except Exception as e:                     # the same error, both sides
        return ("raised", type(e).__name__, str(e))


# --------------------------------------------------------------------------- #
# Workloads: the two contract workloads, and one the port's pipeline measured
# --------------------------------------------------------------------------- #
def _w_ssd(ns, scale=1.0, fixed=True):
    """tests/test_ssd_model.py's workload."""
    return ns.WL.Workload(
        n_reads=int(1e4 * scale), n_samples=int(1e9 * scale),
        n_events=int(1.2e8 * scale), n_seeds=int(1.1e8 * scale),
        n_lookups=int(1.1e8 * scale), n_hits_raw=int(3e8 * scale),
        n_hits_exact=int(4e8 * scale), n_hits_postfreq=int(2.5e8 * scale),
        n_votes=int(5e8 * scale), n_anchors_postvote=int(1e8 * scale),
        n_sorted=int(1e8 * scale), n_dp_pairs=int(3.2e9 * scale),
        bytes_raw=int(2e9 * scale), bytes_index=int(5e8),
        bytes_intermediate=int(3e9 * scale), fixed_point=fixed)


def _w_sim(ns, r=50_000):
    """tests/test_sim.py's workload."""
    return ns.WL.Workload(
        n_reads=r, n_samples=4_000 * r, n_events=450 * r, n_seeds=420 * r,
        n_lookups=420 * r, n_hits_raw=3_400 * r, n_hits_exact=3_800 * r,
        n_hits_postfreq=900 * r, n_votes=900 * r,
        n_anchors_postvote=260 * r, n_sorted=260 * r, n_dp_pairs=4_160 * r,
        bytes_raw=8_000 * r, bytes_index=512 << 20,
        bytes_intermediate=30_000 * r, fixed_point=True)


def _arr(ns, n=4, failed=0):
    return ns.S.SSDArrayConfig(n_ssds=n, n_failed=failed)


def _ssd(ns, **kw):
    return dataclasses.replace(ns.S.SSDConfig(), **kw)


def _tiny_bytes(ns):
    w = _w_sim(ns)
    return dataclasses.replace(w, bytes_raw=w.bytes_raw // 200,
                               bytes_index=w.bytes_index // 200)


# (drives, failed drives) of the array configs priced
ARRAYS = ((1, 0), (2, 0), (2, 1), (4, 0), (4, 1), (8, 0), (8, 1))
GUARDS = ("array_guard", "array_failed_guard", "array_degraded_guard",
          "queueing_validation", "system_unknown",
          "simulate_batch_query_scale_guard",
          "simulate_serving_virtual_guard", "skew_factors_guard",
          "get_model_unknown")

SSD_CASES = {
    "area_table": lambda ns: ns.S.area_table(),
    "host_components": lambda ns: ns.S.host_components(_w_ssd(ns)),
    "host_latency": lambda ns: ns.S.host_latency(_w_ssd(ns),
                                                 ns.S.HostRates(), 1.7),
    "stage_times_float": lambda ns: ns.S.mars_stage_times(
        _w_ssd(ns, fixed=False), ns.S.SSDConfig()),
    "mars_latency": lambda ns: [ns.S.mars_latency(_w_ssd(ns, s))
                                for s in (0.01, 1.0, 3.0)],
    "mars_latency_channels": lambda ns: [
        ns.S.mars_latency(_w_sim(ns), _ssd(ns, channels=c,
                                           chips_per_channel=k))
        for c, k in ((1, 1), (1, 8), (2, 2), (4, 4), (8, 8))],
    "mars_energy": lambda ns: [ns.S.mars_energy(_w_ssd(ns, fixed=f))
                               for f in (True, False)],
    "system_latency_energy": lambda ns: {
        s: ns.S.system_latency_energy(s, _w_ssd(ns)) for s in ns.S.SYSTEMS},
    "system_latency_energy_sim_workload": lambda ns: {
        s: ns.S.system_latency_energy(s, _w_sim(ns), ns.S.HostRates(),
                                      ns.S.SSDConfig(), ns.S.HostConfig())
        for s in ns.S.SYSTEMS},
    "system_unknown": lambda ns: ns.S.system_latency_energy("XYZ",
                                                            _w_ssd(ns)),
    "array_latency": lambda ns: [ns.S.mars_array_latency(_w_ssd(ns),
                                                         _arr(ns, n, f))
                                 for n, f in ARRAYS],
    "array_energy": lambda ns: [ns.S.mars_array_energy(_w_ssd(ns),
                                                       _arr(ns, n, f))
                                for n, f in ARRAYS],
    "array_degraded_guard": lambda ns: ns.S.mars_array_latency(
        _w_ssd(ns), _arr(ns, 1, 1)),
    "array_guard": lambda ns: ns.S.SSDArrayConfig(n_ssds=3),
    "array_failed_guard": lambda ns: ns.S.SSDArrayConfig(n_ssds=4,
                                                         n_failed=2),
    "erlang_c": lambda ns: [ns.S._erlang_c(c, a) for c, a in
                            ((1, 0.5), (4, 3.2), (8, 7.99), (16, 1e-9),
                             (64, 40.0))],
    "queueing_percentiles": lambda ns: [
        ns.S.queueing_percentiles(s, c, load, q) for s, c, load, q in
        ((1e-3, 4, 100.0, (50.0, 99.0)), (2.0, 8, 3.9, (50.0, 90.0, 99.9)),
         (1.0, 1, 1.0, (50.0,)), (1.0, 2, 5.0, (99.0,)))],
    "queueing_validation": lambda ns: ns.S.queueing_percentiles(1.0, 0, 1.0),
    "serving_latency": lambda ns: [
        ns.S.serving_latency(_w_ssd(ns), load, _arr(ns, n, f))
        for load in (10.0, 1e3, 1e5) for n, f in ((1, 0), (4, 0), (4, 1))],
    "serving_latency_virtual": lambda ns: [
        ns.S.serving_latency_virtual(ch, load, cost, (50.0, 99.0, 99.9))
        for ch in (1, 8, 32) for load in (0.5, 4.0, 7.9, 40.0)
        for cost in (1.0, 0.25)],
    "dram_size_sensitivity": lambda ns: ns.S.dram_size_sensitivity(
        _w_ssd(ns), (1 << 30, 2 << 30, 4 << 30, 8 << 30, 16 << 30)),
    "workload_scale": lambda ns: [_w_ssd(ns).scale(f)
                                  for f in (0.001, 0.37, 2.5)],
}

SIM_CASES = {
    "simulate_batch": lambda ns: ns.SIM.simulate_batch(_w_sim(ns)),
    "simulate_batch_stripes": lambda ns: ns.SIM.simulate_batch(
        _w_sim(ns), n_stripes=4, buffer_depth=3, query_scale=1.7),
    "simulate_batch_channels": lambda ns: [
        ns.SIM.simulate_batch(_w_sim(ns), _ssd(ns, channels=c,
                                               chips_per_channel=k))["total"]
        for c, k in ((1, 1), (1, 8), (2, 2), (4, 4), (8, 8))],
    "simulate_batch_compute_bound": lambda ns: ns.SIM.simulate_batch(
        _tiny_bytes(ns), n_stripes=8),
    "simulate_batch_query_scale_guard": lambda ns: ns.SIM.simulate_batch(
        _w_sim(ns), query_scale=0.0),
    "simulate_array_latency": lambda ns: [
        ns.SIM.simulate_array_latency(_w_sim(ns), _arr(ns, 4, f),
                                      n_stripes=8) for f in (0, 1)],
    "simulate_dram_sensitivity": lambda ns: ns.SIM.simulate_dram_sensitivity(
        _w_sim(ns), n_stripes=8),
    "simulate_serving_virtual": lambda ns: [
        ns.SIM.simulate_serving_virtual(8, load, seed=s, n_reads=4000)
        for load in (4.0, 9.0) for s in (3, 4)],
    "simulate_serving_virtual_guard": lambda ns:
        ns.SIM.simulate_serving_virtual(8, 0.0),
    "simulate_serving": lambda ns: ns.SIM.simulate_serving(
        _w_sim(ns), 3e4, _arr(ns, 4), (50.0, 99.0), n_reads=4000, seed=1),
    "engine": lambda ns: _engine_run(ns),
}


def _engine_run(ns):
    """Two components sharing a simulator: FIFO service, queueing, a
    rate-priced task and the per-component statistics."""
    from importlib import import_module
    eng = import_module(ns.SIM.__name__ + ".engine")
    sim = eng.Simulator()
    a = eng.Component(sim, "a", n_servers=2)
    b = eng.Component(sim, "b", rate=3.0)
    for k in range(7):
        sim.schedule(0.5 * k, lambda k=k: a.submit(1.25 + 0.1 * k, tag=k))
        sim.schedule(0.3 * k, lambda k=k: b.submit(work=2.1, tag=k))
    end = sim.run()
    return dict(end=end, log=list(sim.event_log), n=sim.n_events,
                stats=eng.stats_table([a, b], end))


def _model_cases():
    out = {}
    for model in ("analytic", "sim"):
        def m(ns, model=model):
            return ns.CM.get_model(model)
        out.update({
            f"{model}_latency": lambda ns, m=m: m(ns).latency(_w_sim(ns)),
            f"{model}_energy": lambda ns, m=m: [m(ns).energy(_w_ssd(ns, s))
                                                for s in (0.1, 1.0)],
            f"{model}_array": lambda ns, m=m: [
                (m(ns).array_latency(_w_sim(ns), _arr(ns, n, f)),
                 m(ns).array_energy(_w_sim(ns), _arr(ns, n, f)))
                for n, f in ((4, 0), (4, 1))],
            f"{model}_serving": lambda ns, m=m: m(ns).serving(
                _w_sim(ns), 2e4, _arr(ns, 4)),
            f"{model}_serving_virtual": lambda ns, m=m: [
                m(ns).serving_virtual(8, load, 1.0) for load in (4.0, 9.0)],
            f"{model}_dram_sensitivity": lambda ns, m=m:
                m(ns).dram_sensitivity(_w_sim(ns)),
            f"{model}_system_latency_energy": lambda ns, m=m: {
                s: m(ns).system_latency_energy(s, _w_sim(ns))
                for s in ns.S.SYSTEMS},
            f"{model}_skewed_serving": lambda ns, m=m: [
                m(ns).skewed_serving(_w_sim(ns), t, replicas=k)
                for t, k in (([7, 7, 7, 7], 2), ([90, 5, 5, 0], 1),
                             ([100, 80, 8, 8, 8, 8, 8, 8], 2))],
            f"{model}_shed_signal": lambda ns, m=m: [
                m(ns).shed_signal(8, cost, load, delays, delay_limit=lim)
                for cost in (1.0, 0.5) for load in (0.0, 2.0, 7.9, 16.0)
                for delays in ((), (0.5, 1.0), (10.0,) * 8)
                for lim in (4.0, 2.0)],
        })
    out.update({
        "skew_factors": lambda ns: [
            ns.CM.skew_factors(t, r, c) for t, r, c in
            (([5, 5, 5, 5], 2, 2), ([0, 0, 80, 0, 0, 0, 0, 0], 1, 2),
             ([1, 9], 0, 2), ([4, 4, 4, 0], 1, 2), ([3.5, -1, 2], 1, 3),
             ([], 0, 2), ([0, 0, 0], 0, 2))],
        "skew_factors_guard": lambda ns: ns.CM.skew_factors([1], copies=0),
        "delay_tripped": lambda ns: [
            ns.CM._delay_tripped(d, c, lim) for d in ((), (1.0, 9.0))
            for c in (0.0, 1.0) for lim in (1.0, 4.0)],
        "get_model": lambda ns: [ns.CM.get_model(n).name
                                 for n in (None, "analytic", "sim")]
        + [sorted(ns.CM.MODELS), ns.CM.SHED_DELAY_LIMIT],
        "get_model_unknown": lambda ns: ns.CM.get_model("mqsim"),
    })
    return out


MODEL_CASES = _model_cases()
CASES = {**SSD_CASES, **SIM_CASES, **MODEL_CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_cost_models_equal_jax(case):
    fn = CASES[case]
    want = _call(fn, NS["jax"])
    got = _call(fn, NS["torch"])
    _same(got, want)


def test_only_guard_cases_raise():
    """The guard cases exercise the error paths, and no other case raises
    (a case that raised on both sides would compare only the error)."""
    for case, fn in CASES.items():
        got = _call(fn, NS["torch"])
        raised = isinstance(got, tuple) and got[:1] == ("raised",)
        assert raised == (case in GUARDS), (case, got)


# --------------------------------------------------------------------------- #
# Faults: the seeded draws the launcher's plans are made of
# --------------------------------------------------------------------------- #
def _faults_run(ns):
    F = ns.F
    plans = F.sample_fault_plans(6, seed=11, n_tiles=8)
    plan = F.FaultPlan(seed=3, p_read_error=0.3, p_corrupt=0.3,
                       p_latency=0.4, latency_units=2.0,
                       sticky_corrupt_tiles=(5,),
                       prefetch_error_serials=(1, 4))
    inj = F.FaultInjector(plan)
    bstart = np.arange(9, dtype=np.int32)
    ent = np.arange(64, dtype=np.int32).reshape(2, 32)
    reads = []
    for tile in range(8):
        for attempt in range(4):
            reads.append(_call(lambda _: inj.tile_read(tile, attempt, bstart,
                                                       ent), ns))
    pre = [_call(lambda _: inj.check_prefetch(s), ns) for s in range(6)]
    bad = _call(lambda _: F.FaultPlan(p_corrupt=1.5), ns)
    return dict(plans=plans, enabled=[p.enabled for p in plans]
                + [F.FaultPlan().enabled], reads=reads, prefetch=pre,
                bad=bad)


def test_faults_equal_jax():
    _same(_faults_run(NS["torch"]), _faults_run(NS["jax"]))


# --------------------------------------------------------------------------- #
# Measured workloads and the driver's trace records
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mapped():
    cfg_j = JaxConfig(hash_bits=12).with_mode("ms_fixed")
    cfg_t = MarsConfig(hash_bits=12).with_mode("ms_fixed")
    ref = simulate.make_reference(6_000, seed=9)
    reads = simulate.sample_reads(ref, 10, signal_len=1024, seed=10,
                                  junk_frac=0.2)
    jidx = jax_build_index(ref.events_concat, ref.n_events, cfg_j)
    tidx = index_from_numpy(*(getattr(jidx, n) for n in PLANES),
                            jidx.n_ref_events, cfg_t)
    jm = JaxMapper(jidx, cfg_j)
    want = jm.map_signals(reads.signals, chunk=4)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jidx=jidx, tidx=tidx, jm=jm,
                reads=reads, want=want)


@pytest.mark.parametrize("mode", ["ms_fixed", "ms_float"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_workload_from_port_counters_equals_jax(mapped, use_kernels, mode):
    """``from_counters`` of the port's measured counters equals the JAX
    package's ``Workload`` of its own counters, field by field, and every
    cost-model number priced from it is equal too."""
    m = Mapper(mapped["tidx"], mapped["cfg_t"], use_kernels=use_kernels,
               device="cpu")
    out = m.map_signals(mapped["reads"].signals, chunk=4)
    want_c = {k: int(v) for k, v in mapped["want"].counters.items()}
    assert out.counters == want_c
    assert set(out.counters) == set(stages.CHUNK_COUNTER_SCHEMA)
    cfg_j = mapped["cfg_j"].with_mode(mode)
    cfg_t = mapped["cfg_t"].with_mode(mode)
    nbytes = mapped["tidx"].nbytes
    assert nbytes == mapped["jidx"].nbytes
    got = t_wl.from_counters(out.counters, cfg_t, index_bytes=nbytes)
    want = j_wl.from_counters(want_c, cfg_j, index_bytes=nbytes)
    _same(got, want)
    for model in ("analytic", "sim"):
        arr = (t_ssd.SSDArrayConfig(n_ssds=4), j_ssd.SSDArrayConfig(n_ssds=4))
        g = t_cm.get_model(model)
        w = j_cm.get_model(model)
        _same(g.array_latency(got, arr[0]), w.array_latency(want, arr[1]))
        _same(g.serving(got, 1e3, arr[0]), w.serving(want, 1e3, arr[1]))
    with pytest.raises(ValueError, match="counters missing"):
        t_wl.from_counters({"n_reads": 1}, cfg_t, 0)


@pytest.mark.parametrize("clocked", [False, True])
def test_stream_map_trace_equals_jax(mapped, clocked):
    """``stream_map(trace=, clock=)`` appends the reference's records in its
    order, and recording changes neither pull order nor outputs."""
    sig = mapped["reads"].signals

    def run(drv, fn):
        trace, pulls, tick = [], [], [0.0]

        def chunks():
            for c in drv.array_chunks(sig, 4):
                pulls.append(("pull", c[0], len(trace)))
                yield c

        def clock():
            tick[0] += 0.5
            return tick[0]
        outs = [(ci, nv, out.t_start.tolist(), out.counters)
                for ci, nv, out in drv.stream_map(
                    fn, chunks(), trace=trace,
                    clock=clock if clocked else None)]
        return trace, pulls, outs

    m = Mapper(mapped["tidx"], mapped["cfg_t"], use_kernels=True,
               device="cpu")
    got = run(driver, m.chunk_fn())
    want = run(j_driver, mapped["jm"].chunk_fn())
    assert got[0] == want[0] and got[1] == want[1]
    assert [o[:3] for o in got[2]] == [o[:3] for o in want[2]]
    assert [o[3] for o in got[2]] == [{k: int(v) for k, v in o[3].items()}
                                      for o in want[2]]
    plain = [(ci, nv, out.t_start.tolist()) for ci, nv, out in
             driver.stream_map(m.chunk_fn(), driver.array_chunks(sig, 4))]
    assert plain == [o[:3] for o in got[2]]
    kinds = [k for k, *_ in got[0]]
    assert kinds.count("dispatch") == kinds.count("complete") == len(plain)


def test_replay_of_port_serve_trace_equals_jax(mapped):
    """The serving simulator replays the port driver's event trace to the
    same numbers as the JAX driver's, with no drift."""
    from repro.core import ServeDriver as JaxServeDriver
    from repro_torch.core import ServeDriver
    sig = mapped["reads"].signals
    m = Mapper(mapped["tidx"], mapped["cfg_t"], device="cpu")
    sd = ServeDriver(m, chunk=4)
    jsd = JaxServeDriver(mapped["jm"], chunk=4)
    for k, s in enumerate(sig):
        sd.submit(f"s{k % 3}", s)
        jsd.submit(f"s{k % 3}", s)
    sd.drain()
    jsd.drain()
    got = t_sim.replay_chunk_trace(sd.events, chunk_cost=sd.chunk_cost)
    want = j_sim.replay_chunk_trace(jsd.events, chunk_cost=jsd.chunk_cost)
    _same(got, want)
    assert got["max_drift"] == 0.0 and got["n_chunks"] == sd.n_chunks
