"""``BENCHMARK.json`` and the files the harness finds by name.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found from the name the manifest gives it:

    configs/<config>.json       the configuration (sizes, mode, source,
                                the Mapper's options under ``program``)
    traffic/<traffic>.json      a traffic mix's parameters (traffic.py)
    loops/<loop>.py             a loop the generator does not have:
                                ``run(map_fn, stream_map, pool, mix,
                                seconds, spans) -> record``
    workloads/<cell>.json       a cell's own parameters over its mix
                                (``traffic``) and its Mapper's options
                                (``program``)
    metrics/<metric>.py         a metric's reader: ``read(ctx)``; a
                                metric ``<m>.<part>`` without a file of
                                its own is read by ``metrics/<m>.py``
    roofline/<kernel>.py        a kernel's count:
                                ``count(work, mars_config)``

so a later change adds a cell, a configuration or a metric by adding files
and manifest entries, never by editing one.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Dict, List

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {   # each entry's keys, beside a metric's optional ``workloads``
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def load(root: pathlib.Path = ROOT) -> Dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def bench_dir(root: pathlib.Path = ROOT) -> pathlib.Path:
    return pathlib.Path(root) / BENCH.name


def _json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: Dict, name: str, root: pathlib.Path = ROOT) -> Dict:
    """The cell ``name``: its manifest entry, its configuration (the file
    the manifest names), its traffic parameters (the mix's file, updated by
    the cell's own file where it has one) and the Mapper's options (the
    configuration's ``program``, updated by the cell's)."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = bench_dir(root)
    traffic = _json(bench / "traffic" / f"{w['traffic']}.json")
    own_path = bench / "workloads" / f"{name}.json"
    own = _json(own_path) if own_path.exists() else {}
    config = _json(pathlib.Path(root) / cfg_entry["file"])
    return dict(workload=w, config=config,
                traffic={**traffic, **own.get("traffic", {})},
                program={**config.get("program", {}),
                         **own.get("program", {})})


def _applies(metric: Dict, cell_name: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def metrics_for(manifest: Dict, cell_name: str) -> Dict[str, List[Dict]]:
    """The end-to-end and per-layer metrics a cell reports: those that list
    it under ``workloads``; without that key an end-to-end metric is every
    cell's, and a per-layer one every cell's that reports its ``moves``."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per = [m for m in manifest["per_layer"] if _applies(m, cell_name, names)]
    return {"end_to_end": e2e, "per_layer": per}


def _module(path: pathlib.Path, kind: str):
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"rsga_bench_{kind}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(name: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    """The metric ``name``'s reader: ``metrics/<name>.py``, or for a name
    ``<m>.<part>`` without one, the reader ``metrics/<m>.py`` that serves
    every part (the manifest's ``workloads`` scope each part to its
    cells)."""
    metrics = bench_dir(root) / "metrics"
    own = metrics / f"{name}.py"
    return own if own.exists() else metrics / f"{name.split('.')[0]}.py"


def reader(name: str, root: pathlib.Path = ROOT):
    """The metric ``name``'s ``read(ctx) -> float or None``."""
    return _module(reader_path(name, root), "metric").read


def loop(name: str, root: pathlib.Path = ROOT):
    """The loop ``loops/<name>.py``'s ``run``, or None where it has no
    file."""
    path = bench_dir(root) / "loops" / f"{name}.py"
    return _module(path, "loop").run if path.exists() else None


def roofline_count(kernel: str, root: pathlib.Path = ROOT):
    """Kernel ``kernel``'s ``count(work, mars_config) -> (int32
    operations, float32 operations, bytes)``, or None where the benchmark
    has no count for it."""
    path = bench_dir(root) / "roofline" / f"{kernel}.py"
    return _module(path, "roofline").count if path.exists() else None


def problems(manifest: Dict, root: pathlib.Path = ROOT) -> List[str]:
    """What in the manifest breaks the benchmark's contract, as far as the
    files can show it (names, units, sources, every name's files, every
    per-layer metric's ``moves`` reported in each of its cells)."""
    out: List[str] = []
    bench = bench_dir(root)

    def name_ok(kind, n):
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{kind} name {n!r}")

    def text_ok(kind, t):
        if not isinstance(t, str) or not TEXT.match(t):
            out.append(f"{kind} {t!r}: 1 to 200 characters, one line, "
                       "no tab")

    for k, keys in KEYS.items():
        for e in manifest.get(k, []):
            extra = set(e) - keys - ({"workloads"} if k in (
                "end_to_end", "per_layer") else set())
            if extra or not keys <= set(e):
                out.append(f"{k} entry {e.get('name')!r}: keys {sorted(e)}")
    if set(manifest) != set(KEYS) | {"command", "paths", "run_seconds"}:
        out.append(f"top-level keys {sorted(manifest)}")
    rs = manifest.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        out.append(f"run_seconds {rs!r}")
    for w in manifest.get("command", []):
        text_ok("command word", w)
    for m in manifest["end_to_end"]:
        if not 0.01 <= m.get("bound", 0) <= 0.25:
            out.append(f"{m['name']}: bound {m.get('bound')!r}")
    for c in manifest["configs"]:
        text_ok("source", c["source"])
        text_ok("why", c["why"])
    for w in manifest["workloads"]:
        text_ok("why", w["why"])
    for m in manifest["per_layer"]:
        text_ok("layer", m["layer"])

    cfgs = {c["name"]: c for c in manifest["configs"]}
    for c in manifest["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
        if not (pathlib.Path(root) / c["file"]).exists():
            out.append(f"config file {c['file']} missing")
        if not any(w["config"] == c["name"] for w in manifest["workloads"]):
            out.append(f"config {c['name']} used by no cell")
    pairs = set()
    for w in manifest["workloads"]:
        name_ok("workload", w["name"])
        name_ok("traffic", w["traffic"])
        if w["config"] not in cfgs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if not (bench / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"{w['name']}: no traffic file for {w['traffic']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"{w['name']}: config and traffic pair repeated")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
    seen = set()
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for m in metrics:
        name_ok("metric", m["name"])
        if m["name"] in seen:
            out.append(f"metric {m['name']} repeated")
        seen.add(m["name"])
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
        if not reader_path(m["name"], root).exists():
            out.append(f"{m['name']}: no reader file")
    for m in manifest["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: end-to-end source {m['source']}")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
    for w in manifest["workloads"]:
        got = metrics_for(manifest, w["name"])
        names = [m["name"] for m in got["end_to_end"]]
        if "setup_s" not in names or len(names) < 2:
            out.append(f"{w['name']}: needs setup_s and another end-to-end "
                       "metric")
        if not got["per_layer"]:
            out.append(f"{w['name']}: no per-layer metric")
        for m in got["per_layer"]:
            if m["moves"] not in names:
                out.append(f"{w['name']}: {m['name']} moves {m['moves']}, "
                           "which the cell does not report")
    return out

