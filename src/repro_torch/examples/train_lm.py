"""Train a reduced-config LM for a few hundred steps on the synthetic token
stream, with checkpointing: the training substrate end to end (optimizer,
monitor, checkpoint/resume), as the reference's ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        [--arch qwen3-4b] [--steps 200] [--device cpu]

Checkpoints go to ``$TMPDIR/repro_torch_train_lm`` (never the reference
example's ``/tmp/mars_train_lm``); a second run resumes from them.
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile

from repro_torch.launch import train


def workdir() -> pathlib.Path:
    return pathlib.Path(tempfile.gettempdir()) / "repro_torch_train_lm"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train.main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--ckpt-dir", str(workdir()),
        "--save-every", "50", "--log-every", "20",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
