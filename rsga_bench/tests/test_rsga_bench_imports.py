"""Neither the harness nor the reference loads JAX or the JAX package, and
the reference loads nothing of the program: whole top-level module names."""
import subprocess
import sys

from rsga_bench import manifest, run


def test_forbidden_names_compare_whole_top_level_names():
    ok = ["repro_torch", "repro_torch.core", "reproducible", "jaxtyping",
          "numpy", "torch.profiler"]
    bad = ["repro", "repro.core.pipeline", "jax", "jax.numpy", "jaxlib",
           "jaxlib.xla_client", "flax", "flax.linen"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + bad) == sorted(bad)


def _loaded_after(stmt):
    code = (f"import sys; sys.path[:0] = [{str(manifest.ROOT)!r}]; {stmt}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded_after(
        "from rsga_bench import check, datagen, traffic, manifest, trace; "
        "from rsga_bench.reference import mars, f32order")
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_harness_loads_no_jax():
    tops = _loaded_after(
        f"sys.path.insert(0, {str(manifest.ROOT / 'src')!r}); "
        "from rsga_bench import run, controls, knee_sweep; "
        "import repro_torch.core, repro_torch.core.driver")
    assert "repro_torch" in tops
    assert not tops & {"repro", "jax", "jaxlib", "flax"}
