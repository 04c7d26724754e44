"""BENCHMARK.json against the contract, and the harness finding every
configuration, cell, metric and roofline count by name, also one added as
files alone."""
import copy
import json
import shutil

import pytest

from rsga_bench import manifest, run


def test_manifest_meets_the_contract():
    assert manifest.problems(manifest.load()) == []


def test_every_name_is_found():
    m = manifest.load()
    for w in m["workloads"]:
        c = manifest.cell(m, w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["loop"] in ("closed", "bursts")
        got = manifest.metrics_for(m, w["name"])
        for metric in got["end_to_end"] + got["per_layer"]:
            assert callable(manifest.reader(metric["name"]))
    for kernel in ("cheap_fused", "chain_dp"):
        assert callable(manifest.roofline_count(kernel))
    assert manifest.roofline_count("no_such_kernel") is None
    with pytest.raises(KeyError):
        manifest.cell(m, "no_such_cell")


def test_each_cell_reports_setup_and_its_moves():
    m = manifest.load()
    for w in m["workloads"]:
        got = manifest.metrics_for(m, w["name"])
        e2e = [x["name"] for x in got["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert got["per_layer"]
        for x in got["per_layer"]:
            assert x["moves"] in e2e, (w["name"], x["name"])


@pytest.mark.parametrize("where,key,bad", [
    ("workloads", "name", "bad name"),
    ("workloads", "name", "a/b"),
    ("workloads", "traffic", "x,y"),
    ("end_to_end", "unit", "reads per second"),
    ("end_to_end", "unit", "µs"),
    ("per_layer", "name", "café"),
    ("per_layer", "moves", "no_such_metric"),
    ("workloads", "why", "two\nlines"),
    ("workloads", "why", "x" * 201),
    ("end_to_end", "bound", 0.3),
    ("end_to_end", "extra_key", 1),
])
def test_problems_catches(where, key, bad):
    m = copy.deepcopy(manifest.load())
    m[where][0][key] = bad
    assert manifest.problems(m)


def test_a_moves_the_cell_does_not_report_is_caught():
    m = copy.deepcopy(manifest.load())
    m["end_to_end"].append(dict(name="x_ms", unit="ms", better="lower",
                                bound=0.1, source="host_clock",
                                workloads=["d5_rh2.offline"]))
    pl = next(x for x in m["per_layer"] if x["name"] == "chain_dp_roofline")
    pl["moves"] = "x_ms"
    assert any("d5_ms_fixed.offline: chain_dp_roofline moves x_ms, which "
               "the cell does not report" in p for p in manifest.problems(m))


def _copy_bench(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.BENCH, tmp_path / manifest.BENCH.name,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return tmp_path


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path):
    root = _copy_bench(tmp_path)
    bench = root / manifest.BENCH.name
    cfg = json.loads((bench / "configs" / "d5_human_ms_fixed.json")
                     .read_text())
    cfg["name"] = "small_ms_fixed"
    (bench / "configs" / "small_ms_fixed.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_closed.json").write_text(json.dumps(
        dict(loop="closed", pool_reads=128, chunk=64)))
    (bench / "workloads" / "small.tiny.json").write_text(json.dumps(
        dict(traffic=dict(chunk=32))))
    (bench / "metrics" / "chunks_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx['record']['chunks']))\n")
    m = manifest.load(root)
    m["configs"].append(dict(
        name="small_ms_fixed", source="https://arxiv.org/abs/2506.10931",
        file="rsga_bench/configs/small_ms_fixed.json",
        reduced=["genome_len"], why="a small one"))
    m["workloads"].append(dict(name="small.tiny", config="small_ms_fixed",
                               traffic="tiny_closed", chips=1,
                               why="a cell added as files"))
    for x in m["end_to_end"]:
        if x["name"] == "reads_per_s":
            x["workloads"].append("small.tiny")
    m["per_layer"].append(dict(
        name="chunks_done", unit="chunks", better="higher",
        source="host_clock", layer="core/driver", moves="reads_per_s",
        workloads=["small.tiny"]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    m = manifest.load(root)
    assert manifest.problems(m, root) == []
    c = manifest.cell(m, "small.tiny", root)
    assert c["traffic"] == dict(loop="closed", pool_reads=128, chunk=32)
    names = [x["name"] for x in
             manifest.metrics_for(m, "small.tiny")["per_layer"]]
    assert "chunks_done" in names
    res = run.run_cell("small.tiny", 5, 0.5, True, device="cpu", root=root,
                       sizes=dict(genome_len=30_000))
    assert res["correct"]
    assert res["metrics"]["chunks_done"]["value"] >= 1


def test_a_metric_part_is_read_by_its_base_reader(tmp_path):
    assert manifest.reader_path("host_dispatch_ms.offline").name == \
        "host_dispatch_ms.py"
    assert manifest.reader_path("reads_per_s").name == "reads_per_s.py"
    root = _copy_bench(tmp_path)
    own = root / manifest.BENCH.name / "metrics" / "host_dispatch_ms.x.py"
    own.write_text("def read(ctx):\n    return 7.0\n")
    assert manifest.reader_path("host_dispatch_ms.x", root) == own
    assert manifest.reader("host_dispatch_ms.x", root)({}) == 7.0


@pytest.mark.parametrize("trace", [0, 1])
def test_a_loop_and_mapper_options_added_as_files_alone(tmp_path, trace):
    """A cell whose loop is a file under loops/ and whose Mapper takes the
    tiered backend from the cell's own file: no file is edited."""
    root = _copy_bench(tmp_path)
    bench = root / manifest.BENCH.name
    (bench / "loops").mkdir()
    (bench / "loops" / "twice.py").write_text(
        "from rsga_bench import traffic\n\n\n"
        "def run(map_fn, stream_map, pool, mix, seconds, spans):\n"
        "    # the closed loop over a window of its own length\n"
        "    return traffic.closed(map_fn, stream_map, pool, mix, seconds,\n"
        "                          spans)\n")
    (bench / "traffic" / "twice.json").write_text(json.dumps(
        dict(loop="twice", pool_reads=128, chunk=32)))
    (bench / "workloads" / "d5_ms_fixed.twice.json").write_text(json.dumps(
        dict(program=dict(backend="tiered", tiles=4, cache_slots=2))))
    m = manifest.load(root)
    m["workloads"].append(dict(name="d5_ms_fixed.twice",
                               config="d5_human_ms_fixed", traffic="twice",
                               chips=1, why="a loop and a backend as files"))
    for x in m["end_to_end"] + m["per_layer"]:
        if "d5_ms_fixed.offline" in x.get("workloads", []):
            x["workloads"].append("d5_ms_fixed.twice")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    m = manifest.load(root)
    assert manifest.problems(m, root) == []
    c = manifest.cell(m, "d5_ms_fixed.twice", root)
    assert c["program"] == dict(use_kernels=True, backend="tiered", tiles=4,
                                cache_slots=2)
    st = run.setup_cell("d5_ms_fixed.twice", 9, "cpu", root,
                        sizes=dict(genome_len=30_000))
    res = run.measure(st, 0.5, bool(trace), st["marks"][0][1], root)
    assert res["correct"] and res["attempted"] > 0
    if not trace:
        assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
