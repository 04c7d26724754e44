"""Benchmark harness: one module per paper table/figure.

Prints ``name,us_per_call,derived`` CSV lines.  The first invocation runs
the full pipeline per (dataset x mode) on the device and caches the
records under results/bench_torch/<device type>/; later invocations are
fast.

    PYTHONPATH=src python -m repro_torch.benchmarks.run            # all, on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.run fig11 --device cpu
"""
import argparse

from repro_torch.benchmarks import (fig5_breakdown, fig6_io_impact,
                                    fig11_speedup, fig12_energy,
                                    fig13_dram_sensitivity, table3_accuracy,
                                    table4_throughput, table5_area)

MODULES = {
    "table3": table3_accuracy,
    "fig5": fig5_breakdown,
    "fig6": fig6_io_impact,
    "fig11": fig11_speedup,
    "fig12": fig12_energy,
    "table4": table4_throughput,
    "table5": table5_area,
    "fig13": fig13_dram_sensitivity,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="*", metavar="MODULE",
                    help=f"any of {', '.join(MODULES)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline records are mapped (cuda, or "
                         "cpu for the plain torch path)")
    args = ap.parse_args(argv)
    unknown = [k for k in args.which if k not in MODULES]
    if unknown:
        ap.error(f"unknown module(s) {unknown}")
    print("name,us_per_call,derived")
    for key in args.which or list(MODULES):
        MODULES[key].run(print, device=args.device)


if __name__ == "__main__":
    main()
