"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points run on CUDA unless asked for the CPU (no silent fallback),
and its kernel wrappers never catch a failed launch to fall back."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MarsConfig, Mapper, build_index  # noqa: E402
from repro_torch.launch import map_reads                      # noqa: E402
from repro_torch.signal import simulate                       # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the pre-port ``benchmarks`` and ``scripts`` packages import repro and jax
FORBIDDEN = {"jax", "jaxlib", "repro", "benchmarks", "scripts"}


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_core_imports_no_kernel_module():
    """``repro_torch.core`` reaches a kernel only through the stage
    registry (``stages._BACKEND_MODULES``, loaded when a plan asks for
    it): no core module imports ``repro_torch.kernels``."""
    for path in sorted((PORT / "core").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0]
        bad = [m for m in mods if m.startswith("repro_torch.kernels")]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_wrappers_have_no_fallback_handler():
    """A CUDA tensor launches the kernel or raises: no ``try`` in a wrapper
    could swallow a failed launch and quietly take the plain version."""
    for ops in sorted((PORT / "kernels").glob("*/ops.py")):
        tree = ast.parse(ops.read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], ops


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small_index():
    ref = simulate.make_reference(3_000, seed=2)
    return build_index(ref.events_concat, ref.n_events,
                       MarsConfig(hash_bits=10))


def test_mapper_defaults_to_cuda_and_raises_without_it(no_cuda, small_index):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mapper(small_index, use_kernels=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mapper(small_index, device="cuda:0")
    m = Mapper(small_index, use_kernels=True, device="cpu")
    assert m.arrays["entries_packed"].device.type == "cpu"


def test_launcher_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        map_reads.main(["--dataset", "D1", "--reads", "4",
                        "--workdir", str(tmp_path)])


def test_serving_path_defaults_to_cuda_and_raises_without_it(no_cuda,
                                                            small_index):
    from repro_torch.core.realtime import map_realtime
    from repro_torch.launch import serve_rsga
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_rsga.main(["--dataset", "D1", "--streams", "1",
                         "--reads-per-stream", "2"])
    sig = np.zeros((2, 1024), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        map_realtime(sig, small_index, small_index.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mapper(small_index, use_kernels=True).serve(chunk=4)
    sd = Mapper(small_index, device="cpu").serve(chunk=4, early_term=True)
    sd.submit("s", sig)
    sd.drain()
    assert sd.stream("s").n_done == 2


def test_examples_and_scripts_default_to_cuda_and_raise_without_it(
        no_cuda):
    """The ported examples and scripts (``repro_torch.examples``,
    ``repro_torch.scripts``, both under the import guard above) check the
    device before any work: without a card and without ``--device cpu``
    they raise."""
    from repro_torch.examples import map_reads_e2e, quickstart
    from repro_torch.scripts import (fault_sweep, kernel_support,
                                     smoke_core, smoke_ssdmodel, sweep2,
                                     sweep_params)
    files = _port_files()
    assert PORT / "scripts" / "kernel_support.py" in files
    assert PORT / "examples" / "map_reads_e2e.py" in files
    for call in (lambda: quickstart.main([]),
                 lambda: map_reads_e2e.main(["--reads", "2"]),
                 lambda: kernel_support.main([]),
                 lambda: smoke_core.main(["3000", "2"]),
                 lambda: smoke_ssdmodel.main([]),
                 lambda: sweep2.main([]),
                 lambda: sweep_params.main([]),
                 lambda: fault_sweep.main(["--plans", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_paper_evaluation_defaults_to_cuda_and_raises_without_it(
        no_cuda, tmp_path, monkeypatch):
    """The evaluation's entry points (records, the figure CLI, the serving
    calibration's mapper, the filter ablation) run on the card unless
    given the CPU; without a card they raise, whatever the record cache
    holds."""
    from repro_torch.benchmarks import (calibrate_serving, common,
                                        fig11_speedup, run)
    from repro_torch.examples import filter_ablation
    monkeypatch.setattr(common, "CACHE", tmp_path)
    (tmp_path / "cuda").mkdir()
    (tmp_path / "cuda" / "D1_ms_fixed.json").write_text("{}")
    ref, reads = filter_ablation.inputs(3_000, 2)
    for call in (lambda: common.pipeline_run("D1", "ms_fixed"),
                 lambda: common.workload_for("D1", "ms_fixed"),
                 lambda: common.calibrated_host(),
                 lambda: run.main(["table3"]),
                 lambda: fig11_speedup.main([]),
                 lambda: calibrate_serving.default_mapper(ref_events=2_000),
                 lambda: calibrate_serving.main([]),
                 lambda: filter_ablation.ablation(),
                 lambda: filter_ablation.map_variant("+freq filter", ref,
                                                     reads),
                 lambda: filter_ablation.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    m = calibrate_serving.default_mapper(ref_events=2_000, device="cpu",
                                         use_kernels=True)
    assert m.device.type == "cpu" and m.backend == "kernels"
    _, row = filter_ablation.map_variant("+freq filter", ref, reads,
                                         device="cpu")
    assert set(row) == {"precision", "recall", "f1", "n_anchors_postvote",
                        "n_dp_pairs"}


def test_kernels_plan_never_runs_the_plain_cheap_phase_on_cuda(small_index):
    """The kernels plan's per-stage cheap level binds the ``event_detect``
    and ``lookup`` kernel primitives; a config outside the detect gate
    resolves ``detect`` (and the fused kernel) to the reference, as the
    reference package's plan does, and keeps the lookup kernels.  A kernel
    wrapper handed a tensor that is not on the CPU launches or raises: it
    never takes its plain version (here no card exists, so it raises)."""
    from repro_torch.core import pipeline, stages
    from repro_torch.kernels.event_detect import ops as ed_ops
    from repro_torch.kernels.pluto_lookup import ops as pl_ops
    cfg = MarsConfig(hash_bits=10)
    wide = cfg.replace(tstat_window=13)
    kern = stages.resolve_plan(cfg, stages.KERNELS)
    assert dict(kern) == {"detect": "kernels", "quantize": "reference",
                          "seed": "reference", "query": "kernels",
                          "vote": "reference", "sort": "kernels",
                          "dp": "kernels", "finalize": "reference"}
    assert stages.fused_cheap_backend(kern, cfg).name == "kernels"
    prims = stages.cheap_primitives(kern, cfg)
    assert prims.detector.func is ed_ops.event_detect
    assert prims.gather is pl_ops.lookup
    kern_w = stages.resolve_plan(wide, stages.KERNELS)
    assert dict(kern_w)["detect"] == "reference"
    assert stages.fused_cheap_backend(kern_w, wide) is None
    prims_w = stages.cheap_primitives(kern_w, wide)
    assert prims_w.fused is None
    assert prims_w.detector.func is not ed_ops.event_detect
    assert prims_w.gather is pl_ops.lookup
    # a reference detect takes its float segment sums from the plan: the
    # kernel under the kernels plan, the plain loop under the reference's
    from repro_torch.core import events
    from repro_torch.kernels.segment_sum import ops as ss_ops
    flt = cfg.with_mode("ms_float")
    for backend, seg in ((stages.KERNELS, ss_ops.segment_sum),
                         (stages.REFERENCE, events.segment_sum_in_order)):
        det = stages.cheap_primitives(stages.resolve_plan(flt, backend),
                                      flt).detector
        assert det.keywords["segment_sum"] is seg, backend
    off_cpu = torch.empty((2, cfg.signal_len), dtype=torch.int32,
                          device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ed_ops.event_detect_rows(off_cpu, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        pl_ops.lookup(off_cpu[0], off_cpu[1])
    sig = torch.from_numpy(simulate.sample_reads(
        simulate.make_reference(3_000, seed=2), 2, signal_len=cfg.signal_len,
        seed=3).signals)
    arrays = Mapper(small_index, cfg, device="cpu").arrays
    out = pipeline.cheap_phase(sig, arrays, cfg, kern, use_fused=False)
    assert out[1].shape == (2, cfg.max_events, cfg.max_hits_per_seed)
    # the reference detect refuses the config, as the reference's does
    with pytest.raises(ValueError, match="overflows int32"):
        pipeline.cheap_phase(sig, arrays, wide, kern_w)


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch import kernels as K
    from repro_torch.kernels.bitonic_sort import ops as sort_ops
    from repro_torch.kernels.chain_dp import ops as dp_ops
    K.reset_launches()
    keys = torch.from_numpy(np.arange(300, 0, -1, dtype=np.int32)[None])
    assert torch.equal(sort_ops.sort_rows(keys)[0],
                       torch.arange(1, 301, dtype=torch.int32))
    q = torch.zeros((1, 8), dtype=torch.int32)
    f, d = dp_ops.chain_dp(q, q, torch.ones((1, 8), dtype=torch.bool),
                           MarsConfig(chain_band=8))
    assert f.shape == d.shape == (1, 8)
    assert all(v == 0 for v in K.LAUNCHES.values())
