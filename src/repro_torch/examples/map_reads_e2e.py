"""End-to-end mapping driver (the paper-kind workload): stream raw-signal
chunks from a container file with a double-buffered reader, map them on
the port, checkpoint progress for restartability, emit PAF.

This wraps the launcher (``repro_torch.launch.map_reads``) at D1,
``ms_fixed``, 96 reads, and requires F1 > 0.9.

    PYTHONPATH=src python -m repro_torch.examples.map_reads_e2e \
        [--device cpu] [--use-kernels]

Its work directory is ``repro_torch_mars_e2e`` under
``tempfile.gettempdir()`` (which follows ``TMPDIR``), apart from the JAX
package's example, so neither resumes from the other's progress log.
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile

from repro_torch.core.pipeline import check_device
from repro_torch.launch import map_reads

WORKDIR = "repro_torch_mars_e2e"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "torch versions of the kernels)")
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--reads", type=int, default=96)
    args = ap.parse_args(argv)
    check_device(args.device)
    wd = pathlib.Path(tempfile.gettempdir()) / WORKDIR
    acc = map_reads.main([
        "--dataset", "D1",
        "--mode", "ms_fixed",
        "--workdir", str(wd),
        "--out", str(wd / "out.paf"),
        "--reads", str(args.reads),
        "--device", args.device,
    ] + (["--use-kernels"] if args.use_kernels else []))
    if not acc["f1"] > 0.9:
        raise AssertionError(acc)
    print("e2e driver OK")
    return acc


if __name__ == "__main__":
    main()
