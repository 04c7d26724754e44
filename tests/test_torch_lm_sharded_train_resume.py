"""Elastic kill-and-resume of the sharded training launcher on the CPU,
the port's form of the JAX package's
``tests/test_fault_tolerance.py::test_kill_and_resume``:
``repro_torch.launch.train --mesh 1x2`` (2 gloo ranks) is killed once a
checkpoint is committed, and its ranks exit with it; the same command
resumed on the same mesh ends where an uninterrupted run ends (every
``.npy`` of the final checkpoint equal by sha256), and resumed with
``--mesh auto`` on one device it prints ``resumed from step N`` and
``done:``.  The three runs go in parallel, each a subprocess with the
same thread count, so every CPU reduction splits its work alike.
"""
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-4b", "--reduced", "--batch", "2", "--seq", "32",
        "--device", "cpu", "--steps", "10", "--save-every", "2",
        "--log-every", "10"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these inputs are small, and the suite's workers
    share the host's cores (with more, torch's threads mostly wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(extra, ckpt_dir, env):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, *extra,
         "--ckpt-dir", str(ckpt_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


def _digests(d: pathlib.Path):
    m = json.loads((d / "manifest.json").read_text())
    return {e["path"]: e["sha256"] for e in m["leaves"]}, m["data_state"]


def test_elastic_kill_and_resume(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(max(2, torch.get_num_threads() // 2)))
    cut = tmp_path / "cut"
    killed = _launch(["--mesh", "1x2"], cut, env)
    procs = [killed]
    try:
        deadline = time.monotonic() + 180
        while ckpt.latest_step(cut) is None:
            assert killed.poll() is None, killed.stdout.read()
            assert time.monotonic() < deadline, "no checkpoint within 180 s"
            time.sleep(0.02)
        killed.kill()                   # the launcher alone: not its ranks
        killed.wait(30)
        # its ranks see their parent die and exit
        deadline = time.monotonic() + 30
        while _group_alive(killed.pid):
            assert time.monotonic() < deadline, "the ranks outlived the " \
                "killed launcher"
            time.sleep(0.05)
        cut_at = ckpt.latest_step(cut)
        assert 0 < cut_at < 10, "the run ended before it was killed"
        for name in ("same", "elastic"):
            shutil.copytree(cut, tmp_path / name)
        runs = dict(same=_launch(["--mesh", "1x2"], tmp_path / "same", env),
                    elastic=_launch(["--mesh", "auto"], tmp_path / "elastic",
                                    env),
                    whole=_launch(["--mesh", "1x2"], tmp_path / "whole", env))
        procs += list(runs.values())
        outs = {k: p.communicate(timeout=600)[0] for k, p in runs.items()}
    finally:
        for p in procs:
            if p.poll() is None or _group_alive(p.pid):
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
    for k, p in runs.items():
        assert p.returncode == 0, (k, outs[k])
    same, elastic = outs["same"].splitlines(), outs["elastic"].splitlines()
    assert same[0] == ("arch=qwen3-4b-reduced devices=2 "
                       "mesh={'data': 1, 'model': 2}")
    assert elastic[0] == ("arch=qwen3-4b-reduced devices=1 "
                          "mesh={'data': 1, 'model': 1}")
    for lines in (same, elastic):
        assert lines[1] == f"resumed from step {cut_at}"
        assert re.fullmatch(r"done: 10 steps, final loss \d+\.\d{4}, "
                            r"stragglers=\d+", lines[-1])
    # the same mesh resumed ends where the uninterrupted run ends
    got = _digests(tmp_path / "same" / "step_000000010")
    want = _digests(tmp_path / "whole" / "step_000000010")
    assert got == want
    assert same[-1].split(",")[1] == outs["whole"].splitlines()[-1].split(
        ",")[1]
    # one device continues the stream where the mesh left it
    assert _digests(tmp_path / "elastic" / "step_000000010")[1] == {
        "seed": 0, "step": 10}
