"""The port's pipeline bench harness (``repro_torch.benchmarks.microbench``,
``repro_torch.scripts.bench_pipeline``) against the JAX package's
(``benchmarks/microbench.py``, ``scripts/bench_pipeline.py``) on the CPU,
at the quick profile's size (16 reads against 8,000 reference events).

* Every timed closure of the port, under both of its plans, equals the
  JAX closure on its reference backend (the plan never changes a result):
  the chain, cheap, per-stage-group, chunk, serving, tiered-cache and
  fused programs.  Tolerance: exact (values and dtypes).
* The deterministic fields of a CPU run at the quick profile equal
  ``jax_microbench.json`` (tests/test_torch_microbench_golden.py
  regenerates it and holds the full profile's).
* The command line: ``--quick --device cpu --out`` writes both backends
  and all six gate records; the root ``BENCH_pipeline.json`` is refused;
  ``--check`` exits 0 without a baseline for the device type and 1
  against a baseline whose chain ratio is doubled; ``--compiled --device
  cpu`` is a note and exit 0.  Timings are only checked positive and
  finite.

The module's repeats and gate rounds are lowered here (1 repeat, 3 gate
rounds) to keep the file cheap; its defaults stay.
"""
import json
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import microbench as mb  # noqa: E402
from repro_torch.core import stages                  # noqa: E402
from repro_torch.scripts import bench_pipeline as bp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "benchmarks" / "jax_microbench.json"
QUICK = bp.PROFILES["quick"]
PLANS = (stages.REFERENCE, stages.KERNELS)
GATE_ROUNDS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree_equal(got, want, path="out"):
    """Exact equality of nested outputs: tuples, lists, dicts, arrays (JAX,
    torch or numpy; dtype and values), python scalars."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {set(got)} vs {set(want)}"
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, float, bool)) and not isinstance(
            got, torch.Tensor):
        assert got == want, f"{path}: {got} vs {want}"
    else:
        g, w = _np(got), _np(want)
        assert g.dtype == w.dtype, f"{path}: {g.dtype} vs {w.dtype}"
        assert g.shape == w.shape, f"{path}: {g.shape} vs {w.shape}"
        assert np.array_equal(g, w), f"{path}: values differ"


def jax_closures(jmb, map_chunk, cfg, signals, arrays, backend):
    """group -> argless closure of the JAX package's microbench, as
    ``group_closures`` gives the port's (the fused pair aside)."""
    cheap_c, fast_c, pre_c = jmb._chain_programs(cfg, signals, arrays,
                                                 backend)
    cf, cp = jmb._cheap_programs(cfg, signals, arrays, backend)
    sfast, spre, _, _ = jmb._serving_programs(cfg, signals, arrays, backend)
    packed, _ = jmb._split_arrays(arrays)
    plan = jmb.stages.resolve_plan(cfg, backend)
    cfg_pre = cfg.replace(chain_compaction=False)
    plan_pre = jmb.stages.resolve_plan(cfg_pre, backend)
    out = dict(cheap=cheap_c, chain_fast=fast_c, chain_pre=pre_c,
               map_chunk=lambda: map_chunk(signals, packed, cfg, plan=plan),
               map_chunk_pre=lambda: map_chunk(signals, packed, cfg_pre,
                                               plan=plan_pre),
               serving_fast=sfast, serving_pre=spre)
    for g in ("cheap", "detect", "query", "vote"):
        out[f"{g}_fast"], out[f"{g}_pre"] = cf[g], cp[g]
    return out


GROUPS = ("cheap", "chain_fast", "chain_pre", "map_chunk", "map_chunk_pre",
          "serving_fast", "serving_pre", "cheap_fast", "cheap_pre",
          "detect_fast", "detect_pre", "query_fast", "query_pre",
          "vote_fast", "vote_pre")


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX closures' outputs on the quick workload, reference backend
    (and the tiered-cache pair; the fused pair's comparand is the
    reference cheap phase)."""
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    from benchmarks import microbench as jmb
    from repro.core import pipeline as jpipe
    cfg, signals, arrays = jmb.make_workload(
        QUICK["n_reads"], QUICK["ref_events"], QUICK["junk_frac"])
    fns = jax_closures(jmb, jpipe.map_chunk, cfg, signals, arrays,
                       jmb.stages.REFERENCE)
    out = {k: fn() for k, fn in fns.items()}
    tiered, resident, _ = jmb._cache_programs(cfg, signals, arrays)
    out["cache_tiered"], out["cache_resident"] = tiered(), resident()
    return out


@pytest.fixture(scope="module")
def port_workload():
    return mb.make_workload(QUICK["n_reads"], QUICK["ref_events"],
                            QUICK["junk_frac"], device="cpu")


@pytest.fixture(scope="module")
def port_closures(port_workload):
    return {plan: mb.group_closures(*port_workload, plan) for plan in PLANS}


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("plan", PLANS)
def test_closure_equals_jax(jax_outputs, port_closures, plan, group):
    assert_tree_equal(port_closures[plan][group](), jax_outputs[group],
                      group)


def test_cache_closures_equal_jax(jax_outputs, port_workload):
    tiered, resident, mapper = mb._cache_programs(*port_workload)
    assert mapper.cache is not None
    assert_tree_equal(tiered(), jax_outputs["cache_tiered"], "tiered")
    assert_tree_equal(resident(), jax_outputs["cache_resident"], "resident")


@pytest.mark.parametrize("side", ["fused_fast", "fused_pre"])
def test_fused_closures_equal_jax_cheap_phase(jax_outputs, port_closures,
                                              side):
    assert_tree_equal(port_closures[stages.KERNELS][side](),
                      jax_outputs["cheap"], side)


def test_group_closures_cover_the_launch_table(port_closures):
    assert set(port_closures[stages.KERNELS]) == set(mb.GROUP_KERNELS) - {
        "cache_tiered", "cache_resident", "fairness"}
    assert "fused_fast" not in port_closures[stages.REFERENCE]


@pytest.fixture(scope="module")
def lowered():
    """The module's repeats and gate rounds, lowered for the CPU tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(bp.PROFILES, "quick", {**QUICK, "repeats": 1})
        mp.setattr(bp, "CHECK_REPEATS", GATE_ROUNDS)
        mp.setitem(bp.PHASE_ROUNDS, "fused", GATE_ROUNDS)
        yield mp


@pytest.fixture(scope="module")
def cli_record(lowered, tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "BENCH_pipeline.json"
    assert bp.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    return out, json.loads(out.read_text())


def _timings(d):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _timings(v)
        elif isinstance(v, float) and not k.startswith(("fairness",
                                                        "serving_offered",
                                                        "serving_p99",
                                                        "cache_hit")):
            yield k, v


def test_cli_quick_writes_both_backends_and_six_gates(cli_record):
    _, rec = cli_record
    assert set(rec["profiles"]) == {"quick"}
    prof = rec["profiles"]["quick"]
    assert set(prof["backends"]) == set(PLANS)
    assert prof["backends"]["kernels"]["serving_skipped"] is True
    assert "serving_fast" in prof["backends"]["reference"]
    assert {k for k in prof if k.endswith("_gate")} == {
        f"{p}_gate" for p in bp.GATE_PHASES}
    assert prof["machine"]["device_type"] == "cpu"
    assert prof["machine"]["torch"] == torch.__version__
    assert prof["fused"]["fused_mode"] == "plain"
    assert prof["fused_gate"]["backend"] == "kernels"
    assert prof["chain_gate"]["backend"] == "reference"
    times = dict(_timings(prof))
    assert len(times) > 40
    bad = {k: v for k, v in times.items() if not (math.isfinite(v) and v > 0)}
    assert not bad


def test_quick_deterministic_fields_equal_golden(cli_record, port_workload):
    """The quick record against the golden: the workload (at its repeats),
    every field but the lowered gate rounds; the kernels backend's serving
    fields, which --quick skips, from its group on the 8-read grid."""
    golden = json.loads(GOLDEN.read_text())["quick"]
    prof = cli_record[1]["profiles"]["quick"]
    want = json.loads(json.dumps(golden))
    want["workload"]["repeats"] = 1
    for phase, g in want["gates"].items():
        if phase != "fairness":
            g["rounds"] = GATE_ROUNDS
    assert mb.deterministic_mismatches(prof, want) == []
    cfg, signals, arrays = port_workload
    red = QUICK["pallas_reduced_reads"]
    got = mb.bench_serving(cfg, signals[:red], arrays, stages.KERNELS,
                           repeats=1)
    for k, v in golden["backends"]["kernels"].items():
        if k.startswith("serving_"):
            assert got[k] == v, k


def test_cli_refuses_the_root_record():
    with pytest.raises(SystemExit):
        bp.main(["--quick", "--device", "cpu", "--out",
                 str(ROOT / "BENCH_pipeline.json")])
    with pytest.raises(ValueError, match="reference package"):
        bp.write(ROOT / "BENCH_pipeline.json", {})


def test_check_without_a_baseline_for_the_device_exits_0(tmp_path, capsys):
    assert bp.main(["--check", "--device", "cpu"]) == 0
    assert bp.main(["--check", "--device", "cpu", "--out",
                    str(tmp_path / "none.json")]) == 0
    # a card's baseline is never compared with CPU ratios
    card = tmp_path / "card.json"
    card.write_text(json.dumps({"profiles": {"quick": {
        "machine": {"device_type": "cuda"},
        "chain_gate": {"chain_speedup_median": 1e9}}}}))
    assert bp.main(["--check", "--device", "cpu", "--out", str(card)]) == 0
    assert "not compared" in capsys.readouterr().out


def test_check_against_a_doubled_baseline_exits_1(cli_record, tmp_path,
                                                  capsys, monkeypatch):
    """The CLI's --check against the written record with its chain ratio
    doubled.  The check's measurement is the record's own gates: a CPU
    shared by the suite's workers moves one pair of ratios by more than
    the 20% tolerance (2.3x to 7x for the chain here)."""
    quick = cli_record[1]["profiles"]["quick"]
    gates = {p: quick[f"{p}_gate"] for p in bp.GATE_PHASES}
    monkeypatch.setattr(bp, "measure_gate", lambda device: gates)
    rec = json.loads(json.dumps(cli_record[1]))
    rec["profiles"]["quick"]["chain_gate"]["chain_speedup_median"] *= 2
    base = tmp_path / "doubled.json"
    base.write_text(json.dumps(rec))
    assert bp.main(["--check", "--device", "cpu", "--out", str(base)]) == 1
    out = capsys.readouterr().out
    assert "FAIL: chain phase regressed" in out
    assert out.count("FAIL") == 1
    assert bp.main(["--check", "--device", "cpu", "--out",
                    str(cli_record[0])]) == 0
    assert "[bench_pipeline] OK" in capsys.readouterr().out
    # gate records a run already took are compared as they are
    monkeypatch.undo()
    assert bp.check(base, "cpu", gates=gates) == 1
    assert bp.check(cli_record[0], "cpu", gates=gates) == 0
    out = capsys.readouterr().out
    assert "measuring" not in out and "[bench_pipeline] OK" in out


def test_compiled_on_the_cpu_is_a_note(tmp_path, capsys):
    out = tmp_path / "compiled.json"
    assert bp.main(["--compiled", "--device", "cpu", "--out",
                    str(out)]) == 0
    assert not out.exists()
    assert "plain versions" in capsys.readouterr().out


def test_support_prints_the_kernel_matrix(capsys):
    assert bp.main(["--support", "--device", "cpu"]) == 0
    assert "fused_cheap" in capsys.readouterr().out


def test_default_out_is_per_device_and_never_the_root():
    for dev in ("cpu", "cuda"):
        out = bp.default_out(dev)
        assert out.parts[-3:] == ("bench_torch", dev, "BENCH_pipeline.json")
        assert out.resolve() != bp.ROOT_RECORD.resolve()
    assert bp.BASELINE.name == "bench_pipeline_h100.json"
    assert bp.BASELINE.parent.name == "benchmarks"
    base = json.loads(bp.BASELINE.read_text())["profiles"]["quick"]
    assert base["machine"]["device_type"] == "cuda"
    assert {f"{p}_gate" for p in bp.GATE_PHASES} <= set(base)
