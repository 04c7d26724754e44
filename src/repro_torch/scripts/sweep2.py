"""Dev sweep: quantization bits x seed width x t-stat threshold vs
accuracy and hits per read (``ms_fixed``).

    PYTHONPATH=src python -m repro_torch.scripts.sweep2 [--device cpu]

Prints the JAX package's ``scripts/sweep2.py`` lines (its sizes: a
100,000-base reference, 64 reads, the 12-point grid below).
"""
from __future__ import annotations

import argparse
import itertools

from repro_torch.core import MarsConfig, Mapper, build_index, score_accuracy
from repro_torch.core.pipeline import check_device
from repro_torch.signal import simulate

GRID = tuple(itertools.product((3, 4), (5, 6, 7), (2.0, 2.5)))


def run(ref_len: int = 100_000, n_reads: int = 64, grid=GRID,
        device="cuda", use_kernels: bool = False) -> None:
    """The sweep over ``grid`` (quant_bits, seed_width, tstat_threshold)."""
    check_device(device)
    ref = simulate.make_reference(ref_len, seed=0)
    for q, w, tau in grid:
        cfg = MarsConfig(quant_bits=q, seed_width=w, tstat_threshold=tau,
                         min_chain_score=4.0,
                         peak_window=3).with_mode("ms_fixed")
        reads = simulate.sample_reads(ref, n_reads,
                                      signal_len=cfg.signal_len, seed=1,
                                      junk_frac=0.1)
        idx = build_index(ref.events_concat, ref.n_events, cfg)
        out = Mapper(idx, cfg, use_kernels=use_kernels, device=device
                     ).map_signals(reads.signals, chunk=64)
        acc = score_accuracy(out, reads.true_pos, reads.true_strand,
                             reads.mappable, reads.n_bases, ref.n_events)
        hits = out.counters["n_hits_raw"] / n_reads
        hpost = out.counters["n_hits_postfreq"] / n_reads
        print(f"q={q} w={w} tau={tau}: P={acc['precision']:.3f} "
              f"R={acc['recall']:.3f} F1={acc['f1']:.3f} "
              f"hits/read={hits:.0f} postfreq={hpost:.0f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "torch versions of the kernels)")
    ap.add_argument("--use-kernels", action="store_true")
    args = ap.parse_args(argv)
    run(device=args.device, use_kernels=args.use_kernels)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
