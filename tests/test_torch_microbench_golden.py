"""The deterministic fields of the JAX package's pipeline microbenchmark
(``benchmarks/microbench.py`` at the profiles of ``scripts/
bench_pipeline.py``) are committed as
``src/repro_torch/benchmarks/jax_microbench.json`` (the card's host has no
JAX; that file is how a run there is held against the JAX package): per
profile, the workload, each backend's grid markers and serving counts on
the virtual clock, the tiered cache's counts and bytes, the fused group's
read count, every fairness field, and (quick) the gate records' rounds,
read counts and fairness counts — ``repro_torch.benchmarks.microbench.
deterministic`` of a record.

The quick profile runs the kernels backend on a reduced grid of 8 reads;
the golden holds the JAX reference backend's fields on those 8 reads (the
plan never changes a result, so interpret-mode Pallas is not needed).
The timing gates' rounds and read counts are the JAX script's constants.

``test_golden_equals_a_fresh_jax_run`` regenerates it from the JAX package
and requires equality; ``test_full_deterministic_fields_equal_golden``
runs the port's groups at the full profile on the CPU against it (the
quick profile's: tests/test_torch_microbench.py).  Rewrite it after a
deliberate change of the JAX package:

    PYTHONPATH=src python tests/test_torch_microbench_golden.py
"""
import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "benchmarks" / "jax_microbench.json"


def jax_bench_pipeline():
    """The JAX package's ``scripts/bench_pipeline.py`` (its profiles and
    gate constants), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_pipeline", ROOT / "scripts" / "bench_pipeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_golden() -> dict:
    """``deterministic`` of each profile's record, from the JAX package."""
    sys.path.insert(0, str(ROOT))
    from benchmarks import microbench as jmb
    from repro_torch.benchmarks.microbench import deterministic
    jbp = jax_bench_pipeline()
    out = {}
    for name, params in jbp.PROFILES.items():
        n, junk = params["n_reads"], params["junk_frac"]
        cfg, signals, arrays = jmb.make_workload(n, params["ref_events"],
                                                 junk)
        red = params.get("pallas_reduced_reads", 0)
        sig_k = signals[:red] if 0 < red < n else signals
        backends = {}
        for b, sig in (("reference", signals), ("kernels", sig_k)):
            rec = jmb.bench_serving(cfg, sig, arrays, jmb.stages.REFERENCE,
                                    repeats=1)
            rec.update(grid_reads=int(sig.shape[0]),
                       grid_reduced=bool(sig.shape[0] < n))
            backends[b] = rec
        prof = dict(
            workload=dict(n_reads=n, ref_events=params["ref_events"],
                          junk_frac=junk, repeats=params["repeats"], seed=0,
                          signal_len=cfg.signal_len,
                          max_anchors=cfg.max_anchors,
                          chain_band=cfg.chain_band,
                          chain_widths=list(cfg.chain_widths),
                          chain_capacity_frac=cfg.chain_capacity_frac),
            backends=backends,
            cache=jmb.bench_cache(cfg, signals, arrays, repeats=1),
            fused={"fused_n_reads": int(sig_k.shape[0])},
            fairness=jmb.bench_fairness(cfg, signals, arrays))
        if name == "quick":
            for phase in jbp.GATE_PHASES:
                gate = {"rounds": jbp.PHASE_ROUNDS.get(phase,
                                                       jbp.CHECK_REPEATS)}
                if phase == "fused":
                    k = jmb.FUSED_GATE_READS
                    gate["n_reads"] = k if 0 < k < n else n
                if phase == "fairness":
                    gate = jmb.bench_fairness_ratio(cfg, signals, arrays)
                prof[f"{phase}_gate"] = gate
        out[name] = deterministic(prof)
    return json.loads(json.dumps(out))


def test_golden_equals_a_fresh_jax_run():
    pytest.importorskip("torch")
    pytest.importorskip("jax")
    golden = json.loads(GOLDEN.read_text())
    fresh = jax_golden()
    assert set(fresh) == set(golden) == {"quick", "full"}
    for name in golden:
        assert fresh[name] == golden[name], name
    assert set(golden["quick"]["gates"]) == {
        "chain", "cheap", "serving", "cache", "fused", "fairness"}


def test_full_deterministic_fields_equal_golden():
    """The full profile's deterministic groups (serving under both plans,
    the tiered cache, fairness) on the CPU, without the timed groups."""
    torch = pytest.importorskip("torch")
    from repro_torch.benchmarks import microbench as mb
    from repro_torch.scripts import bench_pipeline as bp
    golden = json.loads(GOLDEN.read_text())["full"]
    p = bp.PROFILES["full"]
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg, signals, arrays = mb.make_workload(p["n_reads"], p["ref_events"],
                                            p["junk_frac"], device="cpu")
    prof = dict(workload=golden["workload"], backends={},
                cache=mb.bench_cache(cfg, signals, arrays, repeats=1),
                fused={"fused_n_reads": int(signals.shape[0])},
                fairness=mb.bench_fairness(cfg, signals, arrays))
    for b in ("reference", "kernels"):
        prof["backends"][b] = mb.bench_serving(cfg, signals, arrays, b,
                                               repeats=1)
        prof["backends"][b].update(grid_reads=int(signals.shape[0]),
                                   grid_reduced=False)
    torch.set_num_threads(n_threads)
    assert mb.deterministic_mismatches(prof, golden) == []


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(jax_golden(), indent=1, sort_keys=True)
                      + "\n")
    print(f"wrote {GOLDEN}")
