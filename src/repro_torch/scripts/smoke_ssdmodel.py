"""Smoke the Workload->cost path end to end: map a small dataset, scale
its measured counters to paper magnitude, and print the full system table
through the unified ``core/costmodel.py`` interface for BOTH registered
backends (analytic closed forms and the discrete-event simulator), plus
the sim-vs-analytic agreement on the MARS path.

    PYTHONPATH=src python -m repro_torch.scripts.smoke_ssdmodel [--device cpu]

Prints the JAX package's ``scripts/smoke_ssdmodel.py`` lines (dataset D2,
``ms_fixed``) and fails as it does when the two cost models disagree on
the MARS path by 5% or more.
"""
from __future__ import annotations

import argparse

from repro_torch.core import (Mapper, build_index, costmodel, ssd_model,
                              workload)
from repro_torch.core.pipeline import check_device
from repro_torch.signal import datasets


def run(dataset: str = "D2", n_reads=None, device="cuda",
        use_kernels: bool = False) -> None:
    """The smoke at ``dataset`` (its first ``n_reads`` reads; None = all)."""
    check_device(device)
    spec = datasets.DATASETS[dataset]
    cfg = datasets.config_for(spec).with_mode("ms_fixed")
    ref, reads = datasets.build(spec, cfg)
    idx = build_index(ref.events_concat, ref.n_events, cfg)
    out = Mapper(idx, cfg, use_kernels=use_kernels, device=device
                 ).map_signals(reads.signals[:n_reads], chunk=64)
    w = workload.from_counters(out.counters, cfg, idx.nbytes)
    # scale to paper dataset magnitude
    w = w.scale(spec.scale_factor)

    for name in sorted(costmodel.MODELS):
        m = costmodel.get_model(name)
        res = {s: m.system_latency_energy(s, w) for s in ssd_model.SYSTEMS}
        rh2 = res["RH2"]
        print(f"--- cost model: {m.name} ---")
        print(f"{'system':14s} {'total_s':>10s} {'speedup_vs_RH2':>15s} "
              f"{'energy_red':>11s}")
        for s, r in res.items():
            print(f"{s:14s} {r['total']:10.2f} "
                  f"{rh2['total']/r['total']:15.1f} "
                  f"{rh2['energy']/r['energy']:11.1f}")
        if m.name == "analytic":
            ana = res
        print()

    # the two backends must agree on the MARS path (degenerate configs <1%;
    # the default contended config stays close because flash/compute
    # overlap dominates both)
    mars_a = ana["MARS"]["total"]
    mars_s = costmodel.get_model("sim").system_latency_energy(
        "MARS", w)["total"]
    rel = abs(mars_s - mars_a) / mars_a
    print(f"MARS total: analytic={mars_a:.3f}s sim={mars_s:.3f}s "
          f"(rel err {100 * rel:.2f}%)")
    if not rel < 0.05:
        raise AssertionError(f"sim diverged from analytic by "
                             f"{100 * rel:.1f}%")

    # serving twins agree below saturation
    sv_a = costmodel.get_model("analytic").serving_virtual(8, 4.0)
    sv_s = costmodel.get_model("sim").serving_virtual(8, 4.0)
    print(f"serving p50: analytic={sv_a['p50']:.2f} sim={sv_s['p50']:.2f}")

    print("\npaper targets: MARS vs RH2 28x (energy 180x); vs BC 93x (427x); "
          "vs GenPIP 40x (72x); vs MS-EXT 3.1x; vs MS-SIMDRAM latency 21.4x "
          "faster, energy 3.5x worse")
    rh2, m_, bc, gp, ext, sd = (ana["RH2"], ana["MARS"], ana["BC"],
                                ana["GenPIP"], ana["MS-EXT"],
                                ana["MS-SIMDRAM"])
    print(f"ours: MARS vs RH2 {rh2['total']/m_['total']:.1f}x "
          f"({rh2['energy']/m_['energy']:.0f}x) | vs BC "
          f"{bc['total']/m_['total']:.1f}x ({bc['energy']/m_['energy']:.0f}x)"
          f" | vs GenPIP {gp['total']/m_['total']:.1f}x "
          f"({gp['energy']/m_['energy']:.0f}x) | vs EXT "
          f"{ext['total']/m_['total']:.1f}x | vs SIMDRAM "
          f"{sd['total']/m_['total']:.1f}x")


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
