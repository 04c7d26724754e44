"""Dev smoke: end-to-end mapping accuracy on synthetic genomes, all modes.

    PYTHONPATH=src python -m repro_torch.scripts.smoke_core [REF_LEN]
        [N_READS] [--device cpu]

Prints the JAX package's ``scripts/smoke_core.py`` lines (its defaults: a
100,000-base reference, 64 reads).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import MarsConfig, Mapper, build_index, score_accuracy
from repro_torch.core.pipeline import check_device
from repro_torch.signal import simulate


def run(ref_len: int = 100_000, n_reads: int = 64, device="cuda",
        use_kernels: bool = False):
    """Map ``n_reads`` reads of a ``ref_len``-base reference in rh2,
    ms_float and ms_fixed; returns {mode: accuracy dict}."""
    check_device(device)
    cfg0 = MarsConfig()
    ref = simulate.make_reference(ref_len, seed=0)
    reads = simulate.sample_reads(ref, n_reads, signal_len=cfg0.signal_len,
                                  seed=1, junk_frac=0.1)
    out_acc = {}
    for mode in ("rh2", "ms_float", "ms_fixed"):
        cfg = cfg0.with_mode(mode)
        idx = build_index(ref.events_concat, ref.n_events, cfg)
        mapper = Mapper(idx, cfg, use_kernels=use_kernels, device=device)
        t0 = time.time()
        out = mapper.map_signals(reads.signals, chunk=64)
        dt = time.time() - t0
        acc = score_accuracy(out, reads.true_pos, reads.true_strand,
                             reads.mappable, reads.n_bases, ref.n_events)
        print(f"{mode:10s} P={acc['precision']:.3f} R={acc['recall']:.3f} "
              f"F1={acc['f1']:.3f} tp={acc['tp']} fp={acc['fp']} "
              f"fn={acc['fn']} t={dt:.1f}s")
        out_acc[mode] = acc
    return out_acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref_len", type=int, nargs="?", default=100_000)
    ap.add_argument("n_reads", type=int, nargs="?", default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "torch versions of the kernels)")
    ap.add_argument("--use-kernels", action="store_true")
    args = ap.parse_args(argv)
    run(args.ref_len, args.n_reads, args.device, args.use_kernels)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
