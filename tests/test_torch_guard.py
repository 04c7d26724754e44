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
FORBIDDEN = {"jax", "jaxlib", "repro"}


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
    assert dict(kern) == {"detect": "kernels", "query": "kernels",
                          "sort": "kernels", "dp": "kernels",
                          "fused": "kernels"}
    prims = stages.cheap_primitives(kern, cfg)
    assert prims.detector.func is ed_ops.event_detect
    assert prims.gather is pl_ops.lookup
    kern_w = stages.resolve_plan(wide, stages.KERNELS)
    assert dict(kern_w)["detect"] == dict(kern_w)["fused"] == "reference"
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
