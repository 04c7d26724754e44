"""The port's paper evaluation (``repro_torch.benchmarks``, the filter
ablation) against the JAX package's ``benchmarks/``, ``scripts/bench_sim.py``
and ``examples/filter_ablation.py``, on the CPU.

Both packages' figure and table modules read the same 15 records (the
golden ``jax_records.json``, written into both packages' record caches),
so every CSV line compares the cost models and the figures' arithmetic
alone: the whole line for Figs. 5/6/11/12/13 and Tables 4/5, the name and
``derived`` for Table 3 (its ``us_per_call`` is a wall clock).  The
serving calibration, ``bench_sim.measure`` and the ablation run both
packages' pipelines on the same seeded inputs.  ``pipeline_run`` over a
(1, 2) mesh of 2 gloo ranks must give the golden D1 ``ms_fixed`` record.
Tolerance: exact throughout.  The JAX package is imported inside the
fixtures only: the mesh case's spawned ranks import this module.
"""
import dataclasses
import importlib.util
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "benchmarks" / "jax_records.json"
MODULES = ("table3", "fig5", "fig6", "fig11", "fig12", "table4", "table5",
           "fig13")
SIM_FIGURES = ("fig11", "fig12", "fig13")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.fixture(scope="module")
def record_dirs(golden, tmp_path_factory):
    """The golden records written into a JAX cache and a port CPU cache."""
    jax_dir = tmp_path_factory.mktemp("jax_bench")
    port_dir = tmp_path_factory.mktemp("port_bench")
    (port_dir / "cpu").mkdir()
    for key, rec in golden["records"].items():
        name = key.replace("/", "_") + ".json"
        (jax_dir / name).write_text(json.dumps(rec))
        (port_dir / "cpu" / name).write_text(json.dumps(rec))
    return jax_dir, port_dir


@pytest.fixture()
def both(record_dirs, monkeypatch):
    """(JAX benchmarks.run, port run), each reading its cache of the
    golden records, with no calibration cached from another test."""
    pytest.importorskip("jax")
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import common as jax_common
    from benchmarks import run as jax_run
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import run
    monkeypatch.setattr(jax_common, "CACHE", record_dirs[0])
    monkeypatch.setattr(jax_common, "_CALIB_CACHE", None)
    monkeypatch.setattr(common, "CACHE", record_dirs[1])
    monkeypatch.setattr(common, "_CALIB_CACHE", {})
    return jax_run, run


def _lines(run, key, **kw):
    out = []
    run.MODULES[key].run(out.append, **kw)
    return out


@pytest.mark.parametrize("key,model", [(k, "analytic") for k in MODULES]
                         + [(k, "sim") for k in SIM_FIGURES])
def test_csv_lines_equal_jax(both, golden, key, model):
    jax_run, run = both
    kw = {} if model == "analytic" else dict(model=model)
    want = _lines(jax_run, key, **kw)
    got = _lines(run, key, device="cpu", **kw)
    assert len(got) == len(want) > 0
    if key == "table3":       # us_per_call is a wall clock
        got = [g.split(",")[0::2] for g in got]
        want = [w.split(",")[0::2] for w in want]
    assert got == want
    gold = golden["derived"][model]
    for line in _lines(run, key, device="cpu", **kw):
        name, _, derived = line.split(",", 2)
        assert gold[name] == derived, name


def test_run_prints_every_module(both, golden, capsys):
    _, run = both
    run.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert {ln.split(",")[0] for ln in lines[1:]} == set(
        golden["derived"]["analytic"])
    with pytest.raises(SystemExit):
        run.main(["fig99", "--device", "cpu"])


def test_calibrated_host_equals_jax(both):
    from benchmarks import common as jax_common
    from repro_torch.benchmarks import common
    want = dataclasses.asdict(jax_common.calibrated_host())
    got = dataclasses.asdict(common.calibrated_host("cpu"))
    assert list(got) == list(want)
    for field, value in want.items():
        assert got[field] == value, field


def test_bench_sim_measure_equals_jax_and_checks_the_root_record(
        tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from repro_torch.benchmarks import bench_sim, common
    jax_bench_sim = _load_path("jax_bench_sim", "scripts/bench_sim.py")
    got = bench_sim.measure()
    assert got == jax_bench_sim.measure()
    assert bench_sim.BASELINE == ROOT / "BENCH_sim.json"
    assert bench_sim.check(bench_sim.BASELINE) == 0
    # a fresh record goes under the port's cache, byte-equal to the
    # committed one; the committed file is never a target
    monkeypatch.setattr(common, "CACHE", tmp_path)
    assert bench_sim.main([]) == 0
    assert ((tmp_path / "BENCH_sim.json").read_text()
            == bench_sim.BASELINE.read_text())
    with pytest.raises(SystemExit):
        bench_sim.main(["--out", str(bench_sim.BASELINE)])


CALIBRATE = dict(chunk=8, load_fracs=(0.3, 0.6), n_reads=96)


@pytest.fixture(scope="module")
def jax_calibrate_rows():
    pytest.importorskip("jax")
    jax_cal = _load_path("jax_calibrate_serving",
                         "benchmarks/calibrate_serving.py")
    return jax_cal.calibrate(jax_cal.default_mapper(hash_bits=12,
                                                    ref_events=8_000),
                             **CALIBRATE)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["reference", "kernels"])
def test_calibrate_rows_equal_jax(jax_calibrate_rows, use_kernels):
    from repro_torch.benchmarks import calibrate_serving
    got = calibrate_serving.calibrate(calibrate_serving.default_mapper(
        hash_bits=12, ref_events=8_000, device="cpu",
        use_kernels=use_kernels), **CALIBRATE)
    assert got == jax_calibrate_rows


def _jax_ablation_row(name, n_bases, n_reads):
    """examples/filter_ablation.py's body for one variant, at a size."""
    from repro.core import MarsConfig, Mapper, build_index, score_accuracy
    from repro.signal import simulate
    variants = _load_path("jax_filter_ablation",
                          "examples/filter_ablation.py").VARIANTS
    ref = simulate.make_reference(n_bases, seed=0)
    base = MarsConfig()
    reads = simulate.sample_reads(ref, n_reads, signal_len=base.signal_len,
                                  seed=1, junk_frac=0.1)
    cfg = base.replace(**variants[name])
    idx = build_index(ref.events_concat, ref.n_events, cfg)
    out = Mapper(idx, cfg).map_signals(reads.signals)
    acc = score_accuracy(out, reads.true_pos, reads.true_strand,
                         reads.mappable, reads.n_bases, ref.n_events)
    return dict(precision=acc["precision"], recall=acc["recall"],
                f1=acc["f1"],
                n_anchors_postvote=int(out.counters["n_anchors_postvote"]),
                n_dp_pairs=int(out.counters["n_dp_pairs"]))


@pytest.mark.parametrize("variant", [
    "none (raw RawHash-like)", "+freq filter", "+seed-and-vote",
    "+early quantization", "+fixed point (MARS)"])
def test_filter_ablation_equals_jax(variant):
    pytest.importorskip("jax")
    from repro_torch.examples import filter_ablation
    want = _jax_ablation_row(variant, 50_000, 32)
    ref, reads = filter_ablation.inputs(50_000, 32)
    for backend in ("reference", "kernels"):
        _, got = filter_ablation.map_variant(variant, ref, reads, backend,
                                             device="cpu")
        assert got == want, backend


def _mesh_record(cache):
    """A rank's ``pipeline_run`` of D1 ``ms_fixed`` through query:ring."""
    from repro_torch.benchmarks import common
    from repro_torch.launch.mesh import make_mesh
    common.CACHE = pathlib.Path(cache)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    return common.pipeline_run("D1", "ms_fixed", backend="ring", mesh=mesh)


def test_pipeline_run_over_a_mesh_equals_golden(golden, tmp_path):
    from repro_torch.launch.mesh import run_ranks
    recs = run_ranks(_mesh_record, 2, str(tmp_path), timeout=240)
    want = golden["records"]["D1/ms_fixed"]
    for rank, rec in enumerate(recs):
        for k, v in want.items():
            assert rec[k] == v, (rank, k)
        assert rec["mesh"] == {"data": 1, "model": 2}
        assert dict(rec["plan"])["query"] == "ring"
    cached = tmp_path / "cpu" / "D1_ms_fixed_ring_data1xmodel2.json"
    assert json.loads(cached.read_text())["counters"] == want["counters"]
    assert sorted(p.name for p in (tmp_path / "cpu").iterdir()) == [
        cached.name]
