"""The LM training launcher (``repro_torch.launch.train``) and the
``train_lm`` example on the CPU: the reference launcher's lines (its
f-strings, checked by pattern: the reference's own launcher builds an
Explicit-axes mesh that its model's sharding constraints refuse in this
JAX version), and a run killed once a checkpoint is committed, then
resumed in a new process, ending bit for bit where an uninterrupted run
ends (every ``.npy`` of the final checkpoint equal by sha256).
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-4b", "--reduced", "--batch", "2", "--seq", "32",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launcher_prints_the_reference_lines(capsys, tmp_path,
                                             monkeypatch):
    """Six steps, logging every third, saving every fourth; the monitor's
    clock is a fake one whose fifth step takes ten times the others, so
    the reference's ``[straggler]`` line prints and counts.  The same
    command again resumes at the end and runs no step."""
    import types
    from repro_torch.train import monitor
    ticks = iter([0, 1, 1, 2, 2, 3, 3, 4, 4, 14, 14, 15])
    monkeypatch.setattr(monitor, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    res = train.run(train.parse_args(
        ARGS + ["--steps", "6", "--log-every", "3", "--save-every", "4",
                "--ckpt-dir", str(tmp_path)]))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("arch=qwen3-4b-reduced devices=1 "
                        "mesh={'data': 1, 'model': 1}")
    step = re.compile(r"step +(\d+) loss=\d+\.\d{4} gnorm=\d+\.\d{2} "
                      r"\d+\.\d{2}s \d+ tok/s$")
    assert [int(step.match(x).group(1)) for x in lines
            if x.startswith("step")] == [1, 3, 6]
    assert "[straggler] step=5 10.00s = 10.0x ema" in lines
    assert re.fullmatch(r"done: 6 steps, final loss \d+\.\d{4}, "
                        r"stragglers=1", lines[-1])
    assert len(res["history"]) == 6 and res["start_step"] == 0
    assert res["history"][-1]["loss"] < res["history"][0]["loss"]
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_000000004", "step_000000006"]
    m = json.loads((tmp_path / "step_000000006" / "manifest.json")
                   .read_text())
    assert m["data_state"] == {"seed": 0, "step": 6}
    res = train.run(train.parse_args(
        ARGS + ["--steps", "6", "--ckpt-dir", str(tmp_path)]))
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "resumed from step 6" and res["history"] == []
    assert lines[-1] == "done: 6 steps, final loss nan, stragglers=0"


def test_launcher_takes_one_device_only(capfd):
    """One device or a mesh of ranks: ``--mesh 1x2`` spawns 2 gloo ranks
    and rank 0 prints the reference launcher's lines; an unknown
    ``--mesh`` raises."""
    assert train.mesh_shape("auto", 1) == {"data": 1, "model": 1}
    assert train.mesh_shape("1x1x1", 1) == {"pod": 1, "data": 1, "model": 1}
    res = train.run(train.parse_args(ARGS + ["--steps", "2", "--mesh",
                                             "1x2"]))
    lines = capfd.readouterr().out.splitlines()
    assert lines[0] == ("arch=qwen3-4b-reduced devices=2 "
                        "mesh={'data': 1, 'model': 2}")
    assert re.fullmatch(r"step +1 loss=\d+\.\d{4} gnorm=\d+\.\d{2} "
                        r"\d+\.\d{2}s \d+ tok/s", lines[1])
    assert re.fullmatch(r"done: 2 steps, final loss \d+\.\d{4}, "
                        r"stragglers=0", lines[-1])
    assert len(lines) == 3 and len(res["ranks"]) == 2
    assert res["ranks"][1]["history"] == res["history"]
    assert "params" not in res          # each rank held its blocks
    with pytest.raises(ValueError, match="--mesh"):
        train.main(ARGS + ["--steps", "1", "--mesh", "2x"])


def _run(cmd, env, **kw):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


def _digests(d: pathlib.Path):
    m = json.loads((d / "manifest.json").read_text())
    return {e["path"]: e["sha256"] for e in m["leaves"]}, m["data_state"]


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """A run killed once a checkpoint is committed, resumed by a new
    process, ends where an uninterrupted run (this process, while the
    resumed one runs) ends: every leaf of the final checkpoint equal by
    sha256.  All three use this process's thread count, so every CPU
    reduction splits its work the same way."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    steps = ["--steps", "16", "--save-every", "2", "--log-every", "16"]
    base = [sys.executable, "-m", "repro_torch.launch.train", *ARGS, *steps,
            "--ckpt-dir", str(tmp_path / "cut")]
    killed = _run(base, env)
    deadline = time.monotonic() + 120
    while ckpt.latest_step(tmp_path / "cut") is None:
        assert killed.poll() is None, killed.stdout.read()
        assert time.monotonic() < deadline, "no checkpoint within 120 s"
        time.sleep(0.02)
    killed.kill()
    killed.wait(30)
    cut_at = ckpt.latest_step(tmp_path / "cut")
    assert cut_at < 16, "the run ended before it was killed"
    resumed = _run(base, env)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        whole = train.run(train.parse_args(
            ARGS + steps + ["--ckpt-dir", str(tmp_path / "whole")]))
    finally:
        torch.set_num_threads(threads)
    out_r, _ = resumed.communicate(timeout=300)
    assert resumed.returncode == 0, out_r
    assert f"resumed from step {cut_at}" in out_r
    got = _digests(tmp_path / "cut" / "step_000000016")
    want = _digests(tmp_path / "whole" / "step_000000016")
    assert got == want
    assert out_r.splitlines()[-1].startswith(
        f"done: 16 steps, final loss {whole['history'][-1]['loss']:.4f}")


def test_train_lm_example_runs_and_resumes(capsys, tmp_path, monkeypatch):
    from repro_torch.examples import train_lm
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    assert train_lm.workdir() == tmp_path / "repro_torch_train_lm"
    train_lm.main(["--steps", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen3-4b-reduced devices=1")
    assert lines[-1].startswith("done: 1 steps, final loss ")
    assert ckpt.latest_step(train_lm.workdir()) == 1
    train_lm.main(["--steps", "2", "--device", "cpu"])
    assert "resumed from step 1" in capsys.readouterr().out
