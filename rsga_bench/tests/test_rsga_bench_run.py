"""Whole runs of each cell at a tiny size on the CPU; the control and the
faults put in the program's place coming out as not correct; the refusals
of ``run.py``; and, on a card, a short run of a cell at its own size."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rsga_bench import controls, knee_sweep, manifest, run, traffic

TINY = dict(genome_len=30_000, pool_reads=128, chunk=32, channels=80)
CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_and_reports_its_metrics(cell, trace):
    res = run.run_cell(cell, 2 ** 31 + 21, 0.6, bool(trace), device="cpu",
                       sizes=TINY)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert all(v["value"] == 0 and v["limit"] == 0
               for v in res["checks"].values())
    want = manifest.metrics_for(manifest.load(), cell)
    names = set(res["metrics"])
    if trace:
        # the CPU has no device trace: only the host's spans are read
        assert names == {x["name"] for x in want["per_layer"]
                         if x["source"] == "program_span"}
    else:
        assert names == {x["name"] for x in want["end_to_end"]}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_each_fault_are_not_correct(cell):
    seconds = 0.3 if "readuntil" in cell else 0.6
    got = {r["program"]: r for r in controls.readings(
        cell, 2 ** 31 + 22, seconds, device="cpu", sizes=TINY)}
    assert got["port"]["correct"]
    for prog in ("control", "half_batch", "altered_answer"):
        assert not got[prog]["correct"], prog
        assert got[prog]["checks"]["wrong_reads"] > 0, prog


def test_bursts_time_every_due_read_from_its_due_time():
    rec = dict(t0=0.0, t_end=1.0, interval_s=0.5, channels=4, bursts_due=2,
               chunks=[dict(n=4, due=0.0, t_done=0.3),
                       dict(n=2, due=0.5, t_done=1.4)])
    lat = np.sort(traffic.latencies_s(rec))
    # the first burst at 0.3 s; the second's answered chunk and its two
    # unanswered reads both enter with the wait to the close, 0.5 s
    assert np.allclose(lat, [0.3] * 4 + [0.5] * 4)


def test_knee_sweep_sets_four_fifths_of_the_knee(tmp_path):
    (tmp_path / "PERF.md").write_text("# PERF\n")
    (tmp_path / manifest.BENCH.name / "workloads").mkdir(parents=True)

    def pt(n, grows):
        return dict(channels=n, bursts_due=8, bursts_started=8,
                    service_median_ms=1.0, late_first_ms=0.1,
                    late_last_ms=0.1, decision_p50_ms=1.0,
                    decision_p95_ms=2.0, backlog_grows=grows)
    sweep = tmp_path / "knee.json"
    sweep.write_text(json.dumps(dict(
        workload="x.readuntil", seed=1, seconds=2.0, smi="card, 700 W",
        chunk=2048,
        points=[pt(10240, False), pt(20480, False), pt(30720, True),
                pt(40960, False)])))
    assert knee_sweep.apply(sweep, tmp_path) == 0
    cell = json.loads((tmp_path / manifest.BENCH.name / "workloads"
                       / "x.readuntil.json").read_text())
    # 0.8 x 20480 = 16384, whole chunks of 2048
    assert cell == {"traffic": {"channels": 16384}}
    body = (tmp_path / "PERF.md").read_text()
    assert "knee 20480 channels" in body
    assert knee_sweep.apply(sweep, tmp_path) == 0         # replaces
    assert (tmp_path / "PERF.md").read_text() == body


def test_run_refuses_without_a_card_and_prints_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.BENCH, tmp_path / manifest.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (manifest.ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "rsga_bench/run.py", "--workload", CELLS[0],
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "rsga_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 23), "--seconds", "2", "--trace", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["kind"] == card
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.gpu
def test_the_control_fails_on_the_card_at_the_cell_size(card):
    got = {r["program"]: r for r in controls.readings(
        CELLS[0], 2 ** 31 + 24, 3.0, programs={
            k: controls.PROGRAMS[k] for k in ("port", "control")})}
    assert got["port"]["correct"] and not got["control"]["correct"]
