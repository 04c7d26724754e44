"""Pin sim-vs-analytic agreement of the two CostModel backends against
the committed BENCH_sim.json at the repo root.

The discrete-event in-storage simulator (core/sim/) must agree with the
closed forms of core/ssd_model.py to <1% on degenerate no-contention
configs — that identity is the simulator's calibration contract (see
EXPERIMENTS.md "Simulator methodology").  This module evaluates both
backends over PINNED synthetic paper-scale workloads (pure constants from
signal/datasets.py Table-2 numbers — no pipeline runs, so the record is
machine-independent and runs on no device) and checks:

  * ``degenerate``  — analytic vs sim total over a channels x dies sweep;
                      hard gate: relative error < 1% everywhere;
  * ``figures``     — the Fig. 11/12/13 MARS quantities under both
                      backends; drift gate: sim/analytic within 5%;
  * ``serving``     — the virtual-clock queueing twins' p50 below
                      saturation; gate: within 10% (a seeded measured
                      percentile vs an Erlang-C closed form);
  * ``contended``   — the per-component busy/idle/utilization breakdown
                      the simulator adds over the closed forms on a
                      narrow-channel config (reported, not gated).

    python -m repro_torch.benchmarks.bench_sim --check
        # recompute + validate the gates and the committed root
        # BENCH_sim.json (read only; exit 1 on any gate breach or drift)
    python -m repro_torch.benchmarks.bench_sim
        # write a fresh record to results/bench_torch/BENCH_sim.json

Every quantity here is deterministic (pinned workloads, seeded arrival
traces), so --check also pins the committed values to 0.1%: the port's
cost models must reproduce the JAX package's record.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib

from repro_torch.benchmarks import common

REPO = pathlib.Path(__file__).resolve().parents[3]
BASELINE = REPO / "BENCH_sim.json"       # committed; never written here

DEGENERATE_GATE = 0.01      # sim vs closed form, no-contention configs
FIGURE_GATE = 0.05          # sim/analytic drift on the figure quantities
SERVING_GATE = 0.10         # measured-percentile twin vs Erlang-C p50
PIN_TOL = 1e-3              # committed-value regression pin

# channels x chips_per_channel sweep for the degenerate identity
SWEEP = ((1, 1), (1, 8), (2, 2), (4, 8), (8, 8))

# Pinned per-read stage counts for the synthetic paper-scale workloads: a
# representative raw-signal profile (one seed per detected event, paper
# frequency-filter survival, band-16 DP).  These are FIXTURE constants —
# the measured-counter extrapolation lives in common.workload_for
# and feeds the EXPERIMENTS.md tables; this file only needs a deterministic
# workload shape to pin backend agreement on.
PER_READ = dict(n_events=450, n_seeds=420, n_hits_raw=3400,
                n_hits_exact=3800, n_hits_postfreq=900, n_votes=900,
                n_anchors_postvote=260, n_sorted=260, n_dp_pairs=4160)
INDEX_BYTES_PER_BASE = 14


def pinned_workload(ds_key: str):
    from repro_torch.core.workload import Workload
    from repro_torch.signal import datasets

    spec = datasets.DATASETS[ds_key]
    r = int(spec.paper_reads)
    n_samples = int(spec.paper_bytes // 2)          # int16 DAC samples
    counts = {k: v * r for k, v in PER_READ.items()}
    return Workload(
        n_reads=r, n_samples=n_samples, n_lookups=counts["n_seeds"],
        bytes_raw=int(spec.paper_bytes),
        bytes_index=int(spec.paper_genome_len * INDEX_BYTES_PER_BASE),
        bytes_intermediate=(counts["n_events"] * 2 + counts["n_seeds"] * 4
                            + counts["n_hits_raw"] * 8
                            + counts["n_sorted"] * 4),
        fixed_point=True, **counts)


def measure():
    from repro_torch.core import costmodel, ssd_model

    ana = costmodel.get_model("analytic")
    sim = costmodel.get_model("sim")
    datasets_used = ("D1", "D3", "D5")              # small / mid / large
    rec = {"schema": 1, "datasets": list(datasets_used),
           "per_read": dict(PER_READ)}

    # --- degenerate identity sweep ------------------------------------- #
    deg = {}
    for ds in datasets_used:
        w = pinned_workload(ds)
        row = {}
        for ch, chips in SWEEP:
            ssd = dataclasses.replace(ssd_model.SSDConfig(), channels=ch,
                                      chips_per_channel=chips)
            a = ana.latency(w, ssd)["total"]
            s = sim.latency(w, ssd)["total"]
            row[f"{ch}x{chips}"] = dict(
                analytic=a, sim=s, rel_err=abs(s - a) / a)
        deg[ds] = row
    rec["degenerate"] = deg

    # --- figure quantities under both backends ------------------------- #
    figs = {"fig11_mars_total": {}, "fig12_mars_energy": {}, "fig13": {}}
    for ds in datasets_used:
        w = pinned_workload(ds)
        a_t, s_t = ana.latency(w)["total"], sim.latency(w)["total"]
        a_e, s_e = ana.energy(w), sim.energy(w)
        figs["fig11_mars_total"][ds] = dict(analytic=a_t, sim=s_t,
                                            ratio=s_t / a_t)
        figs["fig12_mars_energy"][ds] = dict(analytic=a_e, sim=s_e,
                                             ratio=s_e / a_e)
        a_d = ana.dram_sensitivity(w)
        s_d = sim.dram_sensitivity(w)
        figs["fig13"][ds] = {
            f"{sz >> 30}GB": dict(analytic=a_d[sz], sim=s_d[sz],
                                  ratio=s_d[sz] / a_d[sz])
            for sz in sorted(a_d)}
    rec["figures"] = figs

    # --- serving queue twins ------------------------------------------- #
    sv_a = ana.serving_virtual(8, 4.0)
    sv_s = sim.serving_virtual(8, 4.0)
    w = pinned_workload("D3")
    arr_a = ana.serving(w, offered_load=1.0 / ana.array_latency(w)["total"]
                        * w.n_reads * 0.5)
    arr_s = sim.serving(w, offered_load=1.0 / ana.array_latency(w)["total"]
                        * w.n_reads * 0.5)
    rec["serving"] = dict(
        virtual=dict(analytic_p50=sv_a["p50"], sim_p50=sv_s["p50"],
                     ratio=sv_s["p50"] / sv_a["p50"]),
        array=dict(analytic_p50=arr_a["p50"], sim_p50=arr_s["p50"],
                   ratio=arr_s["p50"] / arr_a["p50"]))

    # --- contended breakdown (sim-only observability) ------------------ #
    w = pinned_workload("D5")
    ssd = dataclasses.replace(ssd_model.SSDConfig(), channels=2,
                              chips_per_channel=2)
    lat = sim.latency(w, ssd)
    rec["contended"] = dict(
        config="channels=2 chips=2 (flash-starved)",
        total=lat["total"], analytic=ana.latency(w, ssd)["total"],
        controller_stall_flash=lat["controller"]["stall_flash"],
        components={name: dict(utilization=c["utilization"],
                               busy_time=c["busy_time"],
                               queue_delay=c["queue_delay"])
                    for name, c in lat["components"].items()})
    return rec


# --------------------------------------------------------------------------- #
# Gates
# --------------------------------------------------------------------------- #
def validate(rec) -> list:
    """The hard agreement gates, on a (re)computed record."""
    bad = []
    for ds, row in rec["degenerate"].items():
        for cfg, r in row.items():
            if r["rel_err"] >= DEGENERATE_GATE:
                bad.append(f"degenerate {ds}/{cfg}: sim diverges "
                           f"{100 * r['rel_err']:.2f}% (gate "
                           f"{100 * DEGENERATE_GATE:.0f}%)")
    for fig, rows in rec["figures"].items():
        for ds, r in rows.items():
            entries = r if "ratio" not in r else {"": r}
            for sub, e in entries.items():
                if abs(e["ratio"] - 1.0) >= FIGURE_GATE:
                    bad.append(f"{fig}/{ds}{('/' + sub) if sub else ''}: "
                               f"sim/analytic {e['ratio']:.3f} outside "
                               f"+-{100 * FIGURE_GATE:.0f}%")
    for q, r in rec["serving"].items():
        if abs(r["ratio"] - 1.0) >= SERVING_GATE:
            bad.append(f"serving/{q}: p50 ratio {r['ratio']:.3f} outside "
                       f"+-{100 * SERVING_GATE:.0f}%")
    return bad


def _pin_drift(base, cur, path="") -> list:
    """Recursive committed-vs-recomputed comparison (floats to PIN_TOL)."""
    bad = []
    if isinstance(base, dict):
        if not isinstance(cur, dict) or set(base) != set(cur):
            return [f"{path}: structure changed"]
        for k in base:
            bad += _pin_drift(base[k], cur[k], f"{path}/{k}")
    elif isinstance(base, float) or isinstance(cur, float):
        b, c = float(base), float(cur)
        scale = max(abs(b), abs(c), 1e-30)
        if not (math.isfinite(b) and math.isfinite(c)) or \
                abs(b - c) / scale > PIN_TOL:
            bad.append(f"{path}: committed {b!r} != recomputed {c!r}")
    elif base != cur:
        bad.append(f"{path}: committed {base!r} != recomputed {cur!r}")
    return bad


def check(path: pathlib.Path) -> int:
    if not path.exists():
        print(f"[bench_sim] no baseline at {path}; run "
              "python -m repro_torch.benchmarks.bench_sim to create one")
        return 1
    base = json.loads(path.read_text())
    cur = measure()
    problems = validate(cur) + _pin_drift(base, cur)
    for p in problems:
        print(f"[bench_sim] FAIL: {p}")
    if problems:
        return 1
    n_cfg = sum(len(r) for r in cur["degenerate"].values())
    worst = max(r["rel_err"] for row in cur["degenerate"].values()
                for r in row.values())
    print(f"[bench_sim] OK: {n_cfg} degenerate configs within "
          f"{100 * DEGENERATE_GATE:.0f}% (worst {100 * worst:.3f}%), "
          f"figure + serving twins agree, committed values reproduced")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="recompute and validate against the committed "
                         "baseline instead of writing a record")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="the record to check (default: the committed "
                         f"{BASELINE.name}) or to write (default: "
                         "results/bench_torch/BENCH_sim.json)")
    args = ap.parse_args(argv)
    if args.check:
        return check(args.out or BASELINE)
    out = args.out or common.CACHE / "BENCH_sim.json"
    if out.resolve() == BASELINE.resolve():
        ap.error(f"{BASELINE} is the JAX package's committed record; "
                 "write elsewhere")
    rec = measure()
    problems = validate(rec)
    for p in problems:
        print(f"[bench_sim] FAIL: {p}")
    if problems:
        return 1
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2, sort_keys=True) + "\n")
    print(f"[bench_sim] wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
