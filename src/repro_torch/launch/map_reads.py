"""MARS read-mapping launcher on PyTorch — the end-to-end driver.

Streams raw-signal chunks from a container file through the double-
buffered driver (core/driver.py), checkpoints progress to an append-only
JSONL log so a killed job resumes where it stopped, and writes PAF-like
output.  Runs on the CUDA card unless ``--device cpu`` is given (no card
and no ``--device cpu`` raises).

    PYTHONPATH=src python -m repro_torch.launch.map_reads --dataset D1 \
        --use-kernels --out mars.paf

The work directory (signal container, progress log) defaults to
``repro_torch_map_reads`` under ``tempfile.gettempdir()``, which follows
``TMPDIR``; give each concurrent job its own ``--workdir``, since a job
resumes from the progress log it finds there.
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile
import time

import numpy as np

from repro_torch.core import (MapOutput, MarsConfig, Mapper, build_index,
                              driver, score_accuracy)
from repro_torch.signal import datasets, reader, simulate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="D1", choices=sorted(datasets.DATASETS))
    ap.add_argument("--mode", default="ms_fixed",
                    choices=("rh2", "ms_float", "ms_fixed"))
    ap.add_argument("--workdir", default=str(
        pathlib.Path(tempfile.gettempdir()) / "repro_torch_map_reads"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--reads", type=int, default=None)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to map on (default cuda; 'cpu' runs "
                         "the plain torch versions of the kernels)")
    args = ap.parse_args(argv)

    spec = datasets.DATASETS[args.dataset]
    cfg: MarsConfig = datasets.config_for(spec).with_mode(args.mode)
    wd = pathlib.Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)

    # ---- build (or reuse) reference/index/reads --------------------------- #
    sig_file = wd / f"{spec.key}_signals.mars"
    t0 = time.time()
    ref = simulate.make_reference(spec.genome_len, seed=spec.seed)
    n_reads = args.reads or spec.bench_reads
    rs = simulate.sample_reads(ref, n_reads, signal_len=cfg.signal_len,
                               seed=spec.seed + 1, junk_frac=0.08)
    reader.write_signals(sig_file, rs.signals)
    index = build_index(ref.events_concat, ref.n_events, cfg)
    print(f"[setup] genome={spec.genome_len}bp reads={n_reads} "
          f"index={index.n_entries} entries ({index.nbytes/1e6:.1f} MB) "
          f"{time.time()-t0:.1f}s")

    # ---- resume state (append-only JSONL, periodic compaction) ------------- #
    progress = driver.ProgressLog(wd / f"progress_{args.mode}.jsonl")
    start_chunk, results = progress.load()
    if start_chunk:
        print(f"[resume] continuing at chunk {start_chunk}")

    mapper = Mapper(index, cfg, use_kernels=args.use_kernels,
                    device=args.device)
    rdr = reader.SignalReader(sig_file, chunk=args.chunk,
                              start_chunk=start_chunk)
    t0 = time.time()
    n_done = len(results)
    for ci, n_valid, out in driver.stream_map(mapper.chunk_fn(), rdr):
        rows = [(int(out.t_start[i]), float(out.score[i]),
                 bool(out.mapped[i])) for i in range(n_valid)]
        progress.append(ci + 1, rows)      # also accumulates progress.rows
        n_done += n_valid
    results = progress.rows
    dt = time.time() - t0
    print(f"[map] {n_done} reads in {dt:.1f}s "
          f"({n_done/max(dt,1e-9):.1f} reads/s)")

    # ---- score + write PAF -------------------------------------------------- #
    t_start = np.array([r[0] for r in results], np.int64)
    score = np.array([r[1] for r in results], np.float32)
    mapped = np.array([r[2] for r in results])
    out = MapOutput(t_start=t_start, score=score, mapped=mapped,
                    n_events=np.zeros_like(t_start), counters={})
    acc = score_accuracy(out, rs.true_pos[:len(results)],
                         rs.true_strand[:len(results)],
                         rs.mappable[:len(results)],
                         rs.n_bases[:len(results)], ref.n_events)
    print(f"[accuracy] P={acc['precision']:.3f} R={acc['recall']:.3f} "
          f"F1={acc['f1']:.3f}")

    if args.out:
        Le = ref.n_events
        with open(args.out, "w") as f:
            for i, (t, s, m) in enumerate(results):
                if not m:
                    continue
                strand = "-" if t >= Le else "+"
                fwd = t if t < Le else Le - 1 - ((t - Le) + int(rs.n_bases[i]) - 1)
                f.write(f"read{i}\t{cfg.signal_len}\t0\t{cfg.signal_len}\t"
                        f"{strand}\tref\t{Le}\t{fwd}\t"
                        f"{fwd + int(rs.n_bases[i])}\t{s:.1f}\t255\n")
        print(f"[out] PAF written to {args.out}")
    progress.clear()
    return acc


if __name__ == "__main__":
    main()
