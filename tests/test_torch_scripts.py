"""The port's entry points (``repro_torch.examples.quickstart``,
``map_reads_e2e`` and ``repro_torch.scripts.*``) with ``--device cpu`` at
reduced sizes against the JAX package's scripts: the same printed lines
(wall-clock fields excluded; ``pallas`` named ``kernels``) and the same
exit codes.  Where a JAX script has fixed sizes, its lines are computed
here from ``repro.core`` at the reduced size, statement for statement."""
import importlib.util
import pathlib
import re
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import MarsConfig as JaxConfig                # noqa: E402
from repro.core import Mapper as JaxMapper                    # noqa: E402
from repro.core import build_index as jax_build_index         # noqa: E402
from repro.core import costmodel as jcostmodel                # noqa: E402
from repro.core import score_accuracy as jax_score_accuracy   # noqa: E402
from repro.core import ssd_model as jssd_model                # noqa: E402
from repro.core import workload as jworkload                  # noqa: E402
from repro.launch import map_reads as jax_map_reads           # noqa: E402
from repro.signal import datasets as jdatasets                # noqa: E402
from repro.signal import simulate                             # noqa: E402
from repro_torch.examples import map_reads_e2e, quickstart    # noqa: E402
from repro_torch.scripts import (fault_sweep, kernel_support,  # noqa: E402
                                 smoke_core, smoke_ssdmodel, sweep2,
                                 sweep_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# wall-clock fields: "t=1.2s", "... 0.4s" closing [setup], "in 1.0s (x
# reads/s)"
CLOCK = re.compile(r"t=[0-9.]+s|[0-9.]+s$|in [0-9.]+s \([0-9.]+ reads/s\)")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text):
    return [CLOCK.sub("<clock>", ln) for ln in text.splitlines()]


def test_kernel_support_rows_equal_jax(capsys):
    """Every plan row and the fused row, under the name map; the column
    after ``plan <backend>`` pads one name of 7 letters in both."""
    jax_ks = _load("jax_kernel_support", "scripts/kernel_support.py")
    assert jax_ks.main() == 0
    want = capsys.readouterr().out.replace("pallas", "kernels")
    assert kernel_support.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    norm = lambda t: [re.sub(r"\s+:", ":", ln) for ln in t.splitlines()]  # noqa: E731
    assert norm(got) == norm(want)
    assert "fused_cheap : fused:kernels" in got
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_support.main([])


def test_smoke_core_lines_equal_jax(capsys, monkeypatch):
    """The JAX script through its own arguments (reference length, reads)."""
    monkeypatch.setattr(sys, "argv", ["smoke_core.py", "8000", "16"])
    runpy.run_path(str(ROOT / "scripts/smoke_core.py"), run_name="__main__")
    want = capsys.readouterr().out
    assert smoke_core.main(["8000", "16", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want) and len(got.splitlines()) == 3


SWEEPS = {
    # script: (grid point, config from it); each grid holds the default
    # config, which the smoke_core test has compiled on the JAX side
    "sweep2": ((3, 7, 2.5), lambda q, w, tau: dict(
        quant_bits=q, seed_width=w, tstat_threshold=tau,
        min_chain_score=4.0, peak_window=3)),
    "sweep_params": ((2.5, 4.0, 3), lambda tau, mcs, pw: dict(
        tstat_threshold=tau, min_chain_score=mcs, peak_window=pw)),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_lines_equal_jax(name, capsys):
    """One grid point at 8,000 bases and 16 reads; the JAX script's loop
    body, computed here from repro.core."""
    point, kw = SWEEPS[name]
    ref_len, n = 8_000, 16
    ref = simulate.make_reference(ref_len, seed=0)
    cfg = JaxConfig(**kw(*point)).with_mode("ms_fixed")
    reads = simulate.sample_reads(ref, n, signal_len=cfg.signal_len, seed=1,
                                  junk_frac=0.1)
    idx = jax_build_index(ref.events_concat, ref.n_events, cfg)
    out = JaxMapper(idx, cfg).map_signals(reads.signals, chunk=64)
    acc = jax_score_accuracy(out, reads.true_pos, reads.true_strand,
                             reads.mappable, reads.n_bases, ref.n_events)
    c = out.counters
    if name == "sweep2":
        q, w, tau = point
        want = (f"q={q} w={w} tau={tau}: P={acc['precision']:.3f} "
                f"R={acc['recall']:.3f} F1={acc['f1']:.3f} "
                f"hits/read={c['n_hits_raw'] / n:.0f} "
                f"postfreq={c['n_hits_postfreq'] / n:.0f}")
    else:
        tau, mcs, pw = point
        want = (f"tau={tau} mcs={mcs} pw={pw}: P={acc['precision']:.3f} "
                f"R={acc['recall']:.3f} F1={acc['f1']:.3f} "
                f"ev/read={c['n_events'] / n:.0f} "
                f"hits/read={c['n_hits_raw'] / n:.0f}")
    mod = {"sweep2": sweep2, "sweep_params": sweep_params}[name]
    assert point in mod.GRID and len(mod.GRID) == 12
    mod.run(ref_len, n, grid=(point,), device="cpu")
    assert capsys.readouterr().out.splitlines() == [want]


def test_quickstart_lines_equal_jax(capsys):
    """The JAX example's statements at 8,000 bases and 16 reads."""
    cfg = JaxConfig().with_mode("ms_fixed")
    ref = simulate.make_reference(length=8_000, seed=0)
    index = jax_build_index(ref.events_concat, ref.n_events, cfg)
    want = [f"index: {index.n_entries} entries, {index.nbytes/1e6:.1f} MB"]
    reads = simulate.sample_reads(ref, n_reads=16, signal_len=cfg.signal_len,
                                  seed=1, junk_frac=0.1)
    out = JaxMapper(index, cfg).map_signals(reads.signals)
    for i in range(8):
        state = f"pos={out.t_start[i]:>7d} score={out.score[i]:5.1f}" \
            if out.mapped[i] else "unmapped"
        want.append(f"read{i:02d}: {state}")
    acc = jax_score_accuracy(out, reads.true_pos, reads.true_strand,
                             reads.mappable, reads.n_bases, ref.n_events)
    want.append(f"precision={acc['precision']:.3f} "
                f"recall={acc['recall']:.3f} F1={acc['f1']:.3f}")
    got_acc = quickstart.run("cpu", length=8_000, n_reads=16)
    assert capsys.readouterr().out.splitlines() == want
    assert got_acc == acc
    assert any(ln.startswith("read") and "pos=" in ln for ln in want)


def test_smoke_ssdmodel_lines_equal_jax(capsys):
    """The JAX script's statements at D1's first 32 reads (it maps D2's
    128): both cost models' tables, the agreement line, the serving
    twins and the paper-target lines."""
    spec = jdatasets.DATASETS["D1"]
    cfg = jdatasets.config_for(spec).with_mode("ms_fixed")
    ref, reads = jdatasets.build(spec, cfg)
    idx = jax_build_index(ref.events_concat, ref.n_events, cfg)
    out = JaxMapper(idx, cfg).map_signals(reads.signals[:32], chunk=64)
    w = jworkload.from_counters(out.counters, cfg, idx.nbytes).scale(
        spec.scale_factor)
    want = []
    for name in sorted(jcostmodel.MODELS):
        m = jcostmodel.get_model(name)
        res = {s: m.system_latency_energy(s, w) for s in jssd_model.SYSTEMS}
        rh2 = res["RH2"]
        want += [f"--- cost model: {m.name} ---",
                 f"{'system':14s} {'total_s':>10s} {'speedup_vs_RH2':>15s} "
                 f"{'energy_red':>11s}"]
        want += [f"{s:14s} {r['total']:10.2f} "
                 f"{rh2['total']/r['total']:15.1f} "
                 f"{rh2['energy']/r['energy']:11.1f}"
                 for s, r in res.items()]
        want.append("")
        if m.name == "analytic":
            ana = res
    mars_a = ana["MARS"]["total"]
    mars_s = jcostmodel.get_model("sim").system_latency_energy(
        "MARS", w)["total"]
    rel = abs(mars_s - mars_a) / mars_a
    want.append(f"MARS total: analytic={mars_a:.3f}s sim={mars_s:.3f}s "
                f"(rel err {100 * rel:.2f}%)")
    sv_a = jcostmodel.get_model("analytic").serving_virtual(8, 4.0)
    sv_s = jcostmodel.get_model("sim").serving_virtual(8, 4.0)
    want.append(f"serving p50: analytic={sv_a['p50']:.2f} "
                f"sim={sv_s['p50']:.2f}")
    smoke_ssdmodel.run("D1", 32, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got[:len(want)] == want
    assert got[len(want) + 1].startswith("paper targets: MARS vs RH2 28x")
    rh2, m_ = ana["RH2"], ana["MARS"]
    assert got[-1].startswith(
        f"ours: MARS vs RH2 {rh2['total']/m_['total']:.1f}x "
        f"({rh2['energy']/m_['energy']:.0f}x) | vs BC")


def test_map_reads_e2e_lines_equal_jax(capsys, tmp_path, monkeypatch):
    """The port's example at 32 reads against the JAX launcher's lines with
    the same arguments; the example's work directory follows TMPDIR."""
    import tempfile
    wd = tmp_path / "jax"
    jax_map_reads.main(["--dataset", "D1", "--mode", "ms_fixed",
                        "--workdir", str(wd), "--out", str(wd / "out.paf"),
                        "--reads", "32"])
    want = capsys.readouterr().out
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    acc = map_reads_e2e.main(["--device", "cpu", "--reads", "32"])
    got = capsys.readouterr().out
    port_wd = tmp_path / map_reads_e2e.WORKDIR
    assert _lines(got) == _lines(want.replace(str(wd), str(port_wd))) + [
        "e2e driver OK"]
    assert acc["f1"] > 0.9
    assert (port_wd / "out.paf").read_text() == (wd / "out.paf").read_text()


def test_fault_sweep_lines_and_exit_equal_jax(capsys):
    """Two fault plans; the lines and the exit code of the JAX gate."""
    jax_fs = _load("jax_fault_sweep", "scripts/fault_sweep.py")
    rc_j = jax_fs.main(["--plans", "2"])
    want = capsys.readouterr().out
    rc = fault_sweep.main(["--plans", "2", "--device", "cpu"])
    got = capsys.readouterr().out
    assert (rc, got) == (rc_j, want)
    assert rc == 0 and "fault sweep OK (seed 0)" in got
