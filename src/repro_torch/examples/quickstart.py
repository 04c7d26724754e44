"""Quickstart: build a reference index, map a batch of raw-signal reads,
score accuracy — the MARS pipeline end to end on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--use-kernels]

Prints the lines of the JAX package's ``examples/quickstart.py``.
"""
from __future__ import annotations

import argparse

from repro_torch.core import MarsConfig, Mapper, build_index, score_accuracy
from repro_torch.core.pipeline import check_device
from repro_torch.signal import simulate


def run(device="cuda", use_kernels: bool = False, length: int = 50_000,
        n_reads: int = 32):
    """The quickstart at a reference of ``length`` bases and ``n_reads``
    reads (the defaults are the example's); returns the accuracy dict."""
    check_device(device)
    # 1. a synthetic reference genome + its expected-event sequence
    cfg = MarsConfig().with_mode("ms_fixed")        # the full MARS pipeline
    ref = simulate.make_reference(length=length, seed=0)

    # 2. offline indexing (paper Fig. 1 stage A)
    index = build_index(ref.events_concat, ref.n_events, cfg)
    print(f"index: {index.n_entries} entries, {index.nbytes/1e6:.1f} MB")

    # 3. simulate nanopore reads (with 10% unmappable junk)
    reads = simulate.sample_reads(ref, n_reads=n_reads,
                                  signal_len=cfg.signal_len, seed=1,
                                  junk_frac=0.1)

    # 4. online mapping (paper Fig. 1 stage B: events -> seeds -> vote ->
    #    chain)
    mapper = Mapper(index, cfg, use_kernels=use_kernels, device=device)
    out = mapper.map_signals(reads.signals)

    # 5. inspect + score
    for i in range(min(8, n_reads)):
        state = (f"pos={out.t_start[i]:>7d} score={out.score[i]:5.1f}"
                 if out.mapped[i] else "unmapped")
        print(f"read{i:02d}: {state}")
    acc = score_accuracy(out, reads.true_pos, reads.true_strand,
                         reads.mappable, reads.n_bases, ref.n_events)
    print(f"precision={acc['precision']:.3f} recall={acc['recall']:.3f} "
          f"F1={acc['f1']:.3f}")
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "torch versions of the kernels)")
    ap.add_argument("--use-kernels", action="store_true")
    args = ap.parse_args(argv)
    run(args.device, args.use_kernels)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
