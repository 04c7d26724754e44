"""Find a burst cell's knee: the most channels whose backlog does not grow.

    python3 rsga_bench/knee_sweep.py measure --seed 7 --seconds 15 \
        --repeats 2 --channels 65536,98304,131072 --out knee.json
    python3 rsga_bench/knee_sweep.py apply knee.json

``measure`` (on the card) sets the cell up once and runs its open loop
for ``--seconds`` at each channel count, in the ascending order given,
``--repeats`` times a count; it stops after the first count whose backlog
grew in any repeat.  For each repeat it records the bursts due and started, each burst's service time (from its
start to its last chunk's outputs on the host), how late the generator ran
at the start and the end, and the decision times' median and 95th
percentile.  A repeat's backlog grows when a burst due in the window never
started or the generator ran later at the end than at the start by more
than a tenth of the interval.  ``apply`` takes the knee (the largest count
whose backlog grew in no repeat, below every count whose backlog grew), sets
the cell's channels in ``workloads/<cell>.json`` to four fifths of it,
rounded down to whole chunks (a multiple of 512, one MinION flow cell, as
the chunk is: a burst then has no short chunk to pad, and no chunk wraps
round the pool, so the window copies no signal of its own), and writes
the curve into ``PERF.md`` between its knee markers.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from rsga_bench import manifest, traffic  # noqa: E402

FLOW_CELL = 512
SHARE = 0.8
MARKERS = ("<!-- knee-sweep:start -->", "<!-- knee-sweep:end -->")


def point(rec) -> dict:
    I = rec["interval_s"]
    by_due = {}
    for c in rec["chunks"]:
        by_due.setdefault(c["due"], []).append(c["t_done"])
    late = rec["late_s"]
    service = [max(ts) - (due + lt) for (due, ts), lt in
               zip(sorted(by_due.items()), late)]
    third = max(1, len(late) // 3)
    lat = traffic.latencies_s(rec)
    grows = (len(late) < rec["bursts_due"]
             or np.median(late[-third:]) - np.median(late[:third]) > I / 10)
    return dict(channels=rec["channels"], bursts_due=rec["bursts_due"],
                bursts_started=len(late),
                service_median_ms=1e3 * float(np.median(service)),
                late_first_ms=1e3 * float(np.median(late[:third])),
                late_last_ms=1e3 * float(np.median(late[-third:])),
                decision_p50_ms=1e3 * float(np.percentile(lat, 50)),
                decision_p95_ms=1e3 * float(np.percentile(lat, 95)),
                backlog_grows=bool(grows))


def measure(args) -> int:
    import torch
    from rsga_bench import run
    sys.path.insert(0, str(ROOT / "src"))
    st = run.setup_cell(args.workload, args.seed)
    pts = []
    for n in sorted(int(x) for x in args.channels.split(",")):
        for _ in range(args.repeats):
            rec = traffic.bursts(st["map_fn"], st["stream_map"],
                                 st["pool"], {**st["mix"], "channels": n},
                                 args.seconds, traffic.Spans())
            pts.append(point(rec))
            print(json.dumps(pts[-1]), flush=True)
        if any(p["backlog_grows"] for p in pts if p["channels"] == n):
            break
    out = dict(workload=args.workload, seed=args.seed, seconds=args.seconds,
               repeats=args.repeats,
               chunk=st["mix"]["chunk"],
               card=torch.cuda.get_device_name(0), smi=run._smi(),
               points=pts)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


def apply(sweep, root: pathlib.Path = ROOT) -> int:
    """Set the cell's channels from the sweep's knee and write the curve
    into ``PERF.md``, both under ``root``."""
    root = pathlib.Path(root)
    data = json.loads(pathlib.Path(sweep).read_text())
    grows = min((p["channels"] for p in data["points"]
                 if p["backlog_grows"]), default=float("inf"))
    ok = [p["channels"] for p in data["points"]
          if not p["backlog_grows"] and p["channels"] < grows]
    if not ok:
        print("no channel count kept up; sweep lower", file=sys.stderr)
        return 1
    knee = max(ok)
    step = math.lcm(FLOW_CELL, data["chunk"])
    channels = int(SHARE * knee) // step * step
    cell_file = (manifest.bench_dir(root) / "workloads"
                 / f"{data['workload']}.json")
    cell = json.loads(cell_file.read_text()) if cell_file.exists() else {}
    cell.setdefault("traffic", {})["channels"] = channels
    cell_file.write_text(json.dumps(cell) + "\n")
    rows = ["| channels | bursts started / due | service ms (median) | "
            "generator late ms, first third -> last third | decision p50 "
            "ms | decision p95 ms | backlog |",
            "|---|---|---|---|---|---|---|"]
    for p in data["points"]:
        rows.append(
            f"| {p['channels']} | {p['bursts_started']} / {p['bursts_due']}"
            f" | {p['service_median_ms']:.3f} | {p['late_first_ms']:.3f} -> "
            f"{p['late_last_ms']:.3f} | {p['decision_p50_ms']:.3f} | "
            f"{p['decision_p95_ms']:.3f} | "
            f"{'grows' if p['backlog_grows'] else 'steady'} |")
    text = "\n".join(
        [MARKERS[0],
         f"Knee sweep of `{data['workload']}` (`knee_sweep.py`, seed "
         f"{data['seed']}, {data['seconds']} s a point, "
         f"{data.get('repeats', 1)} a count; {data['smi']}): "
         f"knee {knee} channels, cell set to {channels} "
         f"({channels // FLOW_CELL} flow cells, {channels // data['chunk']} "
         "chunks a burst).", ""] + rows
        + [MARKERS[1]])
    perf = root / "PERF.md"
    body = perf.read_text()
    if MARKERS[0] in body:
        a = body.index(MARKERS[0])
        b = body.index(MARKERS[1]) + len(MARKERS[1])
        body = body[:a] + text + body[b:]
    else:
        body = body.rstrip("\n") + "\n\n" + text + "\n"
    perf.write_text(body)
    print(f"knee {knee}, channels {channels}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("measure")
    m.add_argument("--workload", default="d5_ms_fixed.readuntil")
    m.add_argument("--seed", type=int, default=7)
    m.add_argument("--seconds", type=float, default=15.0)
    m.add_argument("--repeats", type=int, default=2)
    m.add_argument("--channels", required=True)
    m.add_argument("--out", required=True)
    a = sub.add_parser("apply")
    a.add_argument("sweep")
    args = ap.parse_args(argv)
    return measure(args) if args.cmd == "measure" else apply(args.sweep)


if __name__ == "__main__":
    sys.exit(main())
