"""The paper's evaluation records: the JAX package's 15 ``pipeline_run``
records (five datasets x three modes, chunk 32) and the ``derived``
column of every CSV line its ``benchmarks.run`` prints are committed as
``src/repro_torch/benchmarks/jax_records.json`` (the card's host has no
JAX; that file is how a run there is held against the JAX package).

``test_golden_equals_a_fresh_jax_run`` regenerates the file from the JAX
package, its record cache in a temporary directory, and requires
equality, so it cannot go stale.  ``test_port_record_equals_golden`` runs
the port's ``pipeline_run`` on the CPU, one case a record.  Tolerance:
exact (every counter, P/R/F1, ``index_bytes``, ``bench_bytes_raw``,
``n_reads``, every ``derived`` string).

Regenerate the file after a deliberate change of the JAX package:

    PYTHONPATH=src python tests/test_torch_paper_records.py
"""
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "benchmarks" / "jax_records.json"
RECORD_KEYS = ("counters", "accuracy", "index_bytes", "bench_bytes_raw",
               "n_reads")
DATASETS = ("D1", "D2", "D3", "D4", "D5")
MODES = ("rh2", "ms_float", "ms_fixed")
SIM_FIGURES = ("fig11", "fig12", "fig13")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _derived(lines):
    """name -> derived of ``name,us_per_call,derived`` lines."""
    return dict((line.split(",", 2)[0], line.split(",", 2)[2])
                for line in lines)


def jax_golden(cache: pathlib.Path) -> dict:
    """The golden records and CSV ``derived`` fields, from the JAX package
    with its record cache at ``cache``."""
    sys.path.insert(0, str(ROOT))
    from benchmarks import common, run
    old = common.CACHE, common._CALIB_CACHE
    common.CACHE, common._CALIB_CACHE = cache, None
    try:
        records = {f"{ds}/{mode}": {k: common.pipeline_run(ds, mode)[k]
                                    for k in RECORD_KEYS}
                   for ds in DATASETS for mode in MODES}
        analytic, sim = [], []
        for mod in run.MODULES.values():
            mod.run(analytic.append)
        for key in SIM_FIGURES:
            run.MODULES[key].run(sim.append, model="sim")
    finally:
        common.CACHE, common._CALIB_CACHE = old
    return dict(records=records, derived=dict(analytic=_derived(analytic),
                                              sim=_derived(sim)))


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_equals_a_fresh_jax_run(golden, tmp_path):
    pytest.importorskip("jax")
    fresh = json.loads(json.dumps(jax_golden(tmp_path)))
    assert set(fresh["records"]) == set(golden["records"])
    for key, rec in golden["records"].items():
        assert fresh["records"][key] == rec, key
    assert fresh["derived"] == golden["derived"]
    assert len(golden["derived"]["analytic"]) == 60
    assert len(golden["derived"]["sim"]) == 24


@pytest.mark.parametrize("ds,mode", [(d, m) for d in DATASETS
                                     for m in MODES])
def test_port_record_equals_golden(golden, ds, mode, tmp_path, monkeypatch):
    from repro_torch.benchmarks import common
    monkeypatch.setattr(common, "CACHE", tmp_path)
    rec = common.pipeline_run(ds, mode, device="cpu")
    want = golden["records"][f"{ds}/{mode}"]
    for k in RECORD_KEYS:
        assert rec[k] == want[k], (ds, mode, k)
    assert rec["device"] == "cpu" and rec["backend"] == "reference"
    assert {b for _, b in rec["plan"]} == {"reference"}
    # cached per device type; a second call reads the cache
    assert (tmp_path / "cpu" / f"{ds}_{mode}.json").exists()
    assert common.pipeline_run(ds, mode, device="cpu") == json.loads(
        json.dumps(rec))


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        GOLDEN.write_text(json.dumps(jax_golden(pathlib.Path(tmp)),
                                     indent=1, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}")
