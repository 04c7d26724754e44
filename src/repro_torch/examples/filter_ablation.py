"""Ablation of MARS's software techniques (paper Section 5): frequency
filter, seed-and-vote, early quantization, fixed point — accuracy and
chaining-workload impact of each.

    PYTHONPATH=src python -m repro_torch.examples.filter_ablation [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.core import MarsConfig, Mapper, build_index, score_accuracy
from repro_torch.core import stages
from repro_torch.core.pipeline import check_device
from repro_torch.signal import simulate

VARIANTS = {
    "none (raw RawHash-like)": dict(use_freq_filter=False,
                                    use_vote_filter=False,
                                    early_quantization=False,
                                    fixed_point=False),
    "+freq filter": dict(use_freq_filter=True, use_vote_filter=False,
                         early_quantization=False, fixed_point=False),
    "+seed-and-vote": dict(use_freq_filter=True, use_vote_filter=True,
                           early_quantization=False, fixed_point=False),
    "+early quantization": dict(use_freq_filter=True, use_vote_filter=True,
                                early_quantization=True, fixed_point=False),
    "+fixed point (MARS)": dict(use_freq_filter=True, use_vote_filter=True,
                                early_quantization=True, fixed_point=True),
}


def inputs(n_bases: int = 400_000, n_reads: int = 96):
    """The ablation's reference and reads (10% junk), from fixed seeds."""
    ref = simulate.make_reference(n_bases, seed=0)
    reads = simulate.sample_reads(ref, n_reads,
                                  signal_len=MarsConfig().signal_len,
                                  seed=1, junk_frac=0.1)
    return ref, reads


def map_variant(name: str, ref, reads, backend: str = stages.REFERENCE,
                device="cuda"):
    """Map ``reads`` with variant ``name``'s config under ``backend``'s
    plan on ``device``: the ``MapOutput`` and its row (P/R/F1 and the
    chaining workload, ``n_anchors_postvote`` and ``n_dp_pairs``)."""
    cfg = MarsConfig().replace(**VARIANTS[name])
    idx = build_index(ref.events_concat, ref.n_events, cfg)
    out = Mapper(idx, cfg, backend=backend,
                 device=device).map_signals(reads.signals)
    acc = score_accuracy(out, reads.true_pos, reads.true_strand,
                         reads.mappable, reads.n_bases, ref.n_events)
    return out, dict(
        precision=acc["precision"], recall=acc["recall"], f1=acc["f1"],
        n_anchors_postvote=int(out.counters["n_anchors_postvote"]),
        n_dp_pairs=int(out.counters["n_dp_pairs"]))


def ablation(backend: str = stages.REFERENCE,
             device="cuda") -> Dict[str, Dict[str, float]]:
    """One row a variant, every variant over the same reads."""
    check_device(device)
    ref, reads = inputs()
    return {name: map_variant(name, ref, reads, backend, device)[1]
            for name in VARIANTS}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = ablation(device=args.device)
    print(f"{'variant':28s} {'P':>6s} {'R':>6s} {'F1':>6s} "
          f"{'anchors':>8s} {'dp_pairs':>9s}")
    for name, r in rows.items():
        print(f"{name:28s} {r['precision']:6.3f} {r['recall']:6.3f} "
              f"{r['f1']:6.3f} {r['n_anchors_postvote']:8d} "
              f"{r['n_dp_pairs']:9d}")


if __name__ == "__main__":
    main()
