"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points run on CUDA unless asked for the CPU (no silent fallback),
and its kernel wrappers never catch a failed launch to fall back."""
import ast
import pathlib
import types

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
    """On a CUDA device the kernels plan runs the cheap phase through the
    fused kernel or raises: neither a config outside the kernel's gate nor
    ``use_fused=False`` lets the plain per-stage program stand in for the
    unported per-stage kernels.  The reference plan and CPU tensors still
    run it.  (A stand-in carries the CUDA device: the guard reads nothing
    else before raising.)"""
    from repro_torch.core import pipeline, stages
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    cfg = MarsConfig(hash_bits=10)
    wide = cfg.replace(tstat_window=13)
    kern = stages.resolve_plan(cfg, stages.KERNELS)
    assert stages.fused_cheap_backend(kern, cfg) is not None
    assert stages.fused_cheap_backend(kern, wide) is None
    with pytest.raises(NotImplementedError, match="cheap_fused"):
        pipeline.cheap_phase(on_card, {}, wide, kern)
    with pytest.raises(NotImplementedError, match="use_fused=False"):
        pipeline.cheap_phase(on_card, {}, cfg, kern, use_fused=False)
    pipeline.check_plain_cheap(stages.resolve_plan(cfg, stages.REFERENCE),
                               on_card.device)
    sig = torch.from_numpy(simulate.sample_reads(
        simulate.make_reference(3_000, seed=2), 2, signal_len=cfg.signal_len,
        seed=3).signals)
    arrays = Mapper(small_index, cfg, device="cpu").arrays
    out = pipeline.cheap_phase(sig, arrays, cfg, kern, use_fused=False)
    assert out[1].shape == (2, cfg.max_events, cfg.max_hits_per_seed)


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
