"""Measure the port's per-stage-group timings and persist them to a
per-device record (the counterpart of the reference package's
``scripts/bench_pipeline.py``).

    python -m repro_torch.scripts.bench_pipeline             # quick + full
    python -m repro_torch.scripts.bench_pipeline --quick     # quick only
                                          # (skips the kernels backend's
                                          # serving group)
    python -m repro_torch.scripts.bench_pipeline --check     # quick gate
                                          # ratios against the device's
                                          # committed baseline: exits 1 if
                                          # the chaining, cheap, serving,
                                          # tiered-cache, fused-kernel OR
                                          # multi-tenant fairness phase
                                          # regressed > 20% (exits 0 when
                                          # the device has no baseline)
    python -m repro_torch.scripts.bench_pipeline --compiled  # the quick
                                          # profile on the full read grid
                                          # with the kernels compiled, under
                                          # ``compiled_cuda``; a note and
                                          # exit 0 with --device cpu, where
                                          # the kernels are plain versions
    python -m repro_torch.scripts.bench_pipeline --support   # the kernel
                                          # backends' supports matrix

Runs on CUDA unless given ``--device cpu``; without a card it raises.
Records go to ``results/bench_torch/<cpu|cuda>/BENCH_pipeline.json``
(relative to the working directory; ``--out`` overrides).  The root
``BENCH_pipeline.json`` is the reference package's record and is never
written here.  The card's baseline, which ``--check`` compares with on
CUDA, is ``repro_torch/benchmarks/bench_pipeline_h100.json``; CPU ratios
are never compared with the card's.

The gate compares interleaved pre/fast speedup RATIOS (never absolute ms),
like for like (quick vs quick).  ``BENCH_GATE_PCT`` overrides the 20%
tolerance.  The quick profile runs the kernels backend (and the fused
group) on a REDUCED read grid (``pallas_reduced_reads``, the reference
package's name); every record carries ``grid_reads``/``grid_reduced``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import torch

from repro_torch.benchmarks import common
from repro_torch.core.pipeline import check_device

REPO = pathlib.Path(__file__).resolve().parents[3]
ROOT_RECORD = REPO / "BENCH_pipeline.json"   # the reference package's
# the card's committed baseline (the CPU has none)
BASELINE = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "bench_pipeline_h100.json")

PROFILES = {
    # quick caps the kernels backend's groups (incl. the fused kernel) to
    # a reduced read grid; records are marked grid_reduced=True
    "quick": dict(n_reads=16, ref_events=8_000, junk_frac=0.5, repeats=5,
                  pallas_reduced_reads=8),
    "full": dict(n_reads=32, ref_events=20_000, junk_frac=0.5, repeats=7),
}

GATE_PHASES = ("chain", "cheap", "serving", "cache", "fused", "fairness")
CHECK_BACKEND = "reference"     # backend whose gate ratios are gated
CHECK_REPEATS = 25
# the fused gate runs fewer interleaved rounds; the fairness gate is a
# deterministic virtual-clock count ratio — one round is exact
PHASE_ROUNDS = {"fused": 9, "fairness": 1}
# the fused gate is kernels-vs-kernels by construction (fused kernel
# against the per-stage kernels program); the others gate CHECK_BACKEND
PHASE_BACKEND = {"fused": "kernels"}


def default_out(device) -> pathlib.Path:
    return common.CACHE / torch.device(device).type / "BENCH_pipeline.json"


def gate_tol() -> float:
    """Gate tolerance as a ratio: 1 + BENCH_GATE_PCT/100 (default 20%)."""
    return 1.0 + float(os.environ.get("BENCH_GATE_PCT", "20")) / 100.0


def hardware_key(device="cuda") -> dict:
    """The hardware/software fingerprint stamped into every measured
    profile and gate record (microbench.hardware_key)."""
    from repro_torch.benchmarks import microbench
    return microbench.hardware_key(device)


def measure(profiles, device="cuda", **kw):
    from repro_torch.benchmarks import microbench
    out = {}
    for name in profiles:
        params = {**PROFILES[name], **kw}
        print(f"[bench_pipeline] measuring profile {name!r} "
              f"({params}) ...", flush=True)
        out[name] = microbench.run(**params, device=device)
        ref = out[name]["backends"]["reference"]
        print(f"[bench_pipeline] {name}: chain_pre={ref['chain_pre']*1e3:.2f}ms "
              f"chain_fast={ref['chain_fast']*1e3:.2f}ms "
              f"speedup={ref['chain_speedup']:.2f}x", flush=True)
        print(f"[bench_pipeline] {name}: cheap_pre={ref['cheap_pre']*1e3:.2f}ms "
              f"cheap_fast={ref['cheap_fast']*1e3:.2f}ms "
              f"speedup={ref['cheap_speedup']:.2f}x", flush=True)
        print(f"[bench_pipeline] {name}: serving_pre={ref['serving_pre']*1e3:.2f}ms "
              f"serving_fast={ref['serving_fast']*1e3:.2f}ms "
              f"speedup={ref['serving_speedup']:.2f}x "
              f"({ref['serving_streams_per_sec']:.1f} streams/s, "
              f"p99={ref['serving_p99_virtual']:.2f} virtual)", flush=True)
        fused = out[name]["fused"]
        print(f"[bench_pipeline] {name}: fused={fused['fused_fast']*1e3:.2f}ms "
              f"per-stage={fused['fused_pre']*1e3:.2f}ms "
              f"fused_gate={fused['fused_speedup']:.2f}x "
              f"({fused['fused_n_reads']} reads, {fused['fused_mode']} mode)",
              flush=True)
        fair = out[name]["fairness"]
        print(f"[bench_pipeline] {name}: fairness acme victims "
              f"legacy={fair['fairness_acme_victims_legacy']} "
              f"budgeted={fair['fairness_acme_victims_fair']} "
              f"isolation={fair['fairness_speedup']:.1f}x "
              f"(flood sheds={fair['fairness_flood_shed_fair']})",
              flush=True)
        cache = out[name]["cache"]
        print(f"[bench_pipeline] {name}: cache_resident="
              f"{cache['cache_resident']*1e3:.2f}ms "
              f"cache_tiered={cache['cache_tiered']*1e3:.2f}ms "
              f"ratio={cache['cache_speedup']:.2f}x "
              f"(hit_rate={cache['cache_hit_rate']:.2f}, "
              f"paged={cache['cache_paged_bytes']/2**20:.1f} MiB, "
              f"{cache['cache_slots']}/{cache['cache_n_tiles']} tiles "
              "resident)", flush=True)
    return out


def write(path: pathlib.Path, measured) -> None:
    # each profile record carries its own git_sha (stamped by
    # microbench.run), so profiles retained from an earlier run keep the
    # SHA they were actually measured at
    path = pathlib.Path(path)
    if path.resolve() == ROOT_RECORD.resolve():
        raise ValueError(f"{ROOT_RECORD} is the reference package's "
                         "committed record; write elsewhere")
    rec = {"schema": 1, "profiles": {}}
    if path.exists():
        try:
            old = json.loads(path.read_text())
            rec["profiles"] = old.get("profiles", {})
        except json.JSONDecodeError:
            pass
    rec["created_unix"] = int(time.time())
    rec["profiles"].update(measured)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=2, sort_keys=True) + "\n")
    print(f"[bench_pipeline] wrote {path}")


def measure_gate(device="cuda"):
    """The interleaved pre/fast ratios on the quick workload — one record
    per gated phase (chain, cheap, serving, cache, fused, fairness), all
    machine-speed independent (microbench.bench_chain_ratio /
    bench_cheap_ratio / bench_serving_ratio / bench_cache_ratio /
    bench_fused_ratio; bench_fairness_ratio is a deterministic
    virtual-clock count ratio rather than a timing)."""
    from repro_torch.benchmarks import microbench
    params = PROFILES["quick"]
    print(f"[bench_pipeline] measuring interleaved {'/'.join(GATE_PHASES)} "
          f"pre/fast ratios ({params}) ...", flush=True)
    cfg, signals, arrays = microbench.make_workload(
        params["n_reads"], params["ref_events"], params["junk_frac"],
        device=device)
    fns = dict(chain=microbench.bench_chain_ratio,
               cheap=microbench.bench_cheap_ratio,
               serving=microbench.bench_serving_ratio,
               cache=microbench.bench_cache_ratio,
               fused=microbench.bench_fused_ratio,
               fairness=microbench.bench_fairness_ratio)
    machine = hardware_key(signals.device)
    gates = {}
    for phase in GATE_PHASES:
        backend = PHASE_BACKEND.get(phase, CHECK_BACKEND)
        rec = fns[phase](cfg, signals, arrays, backend,
                         rounds=PHASE_ROUNDS.get(phase, CHECK_REPEATS))
        rec["backend"] = backend
        rec["machine"] = machine
        gates[phase] = rec
    return gates


def check(path, device="cuda", gates=None) -> int:
    """Regression gate on the chaining, cheap, serving, tiered-cache,
    fused-kernel AND multi-tenant fairness phases, machine-speed
    independent: compares the median interleaved pre/fast speedup ratio of
    each phase against the baseline's identically-measured ``<phase>_gate``
    record.  A rise in any phase's normalized time beyond ``gate_tol()``
    (default 20%; BENCH_GATE_PCT overrides) fails; a phase whose baseline
    record is absent skips cleanly, and so does a baseline measured on
    another device type (``path`` None: the device has none).  ``gates``
    is a ``measure_gate`` result this run already took (chip_smoke.py's,
    which writes it too); by default the gates are measured here."""
    dev_type = torch.device(device).type
    if path is None or not pathlib.Path(path).exists():
        print(f"[bench_pipeline] no {dev_type} baseline"
              f"{'' if path is None else f' at {path}'}; skipping "
              "regression check")
        return 0
    base = json.loads(pathlib.Path(path).read_text())
    prof = base.get("profiles", {}).get("quick", {})
    if not any(prof.get(f"{p}_gate") for p in GATE_PHASES):
        print("[bench_pipeline] baseline has no quick "
              f"{'/'.join(p + '_gate' for p in GATE_PHASES)} record; "
              "skipping")
        return 0
    base_machine = prof.get("machine") or {}
    if base_machine.get("device_type") != dev_type:
        print(f"[bench_pipeline] baseline {path} was measured on "
              f"{base_machine.get('device_type')!r}, this run is on "
              f"{dev_type!r}; ratios of different devices are not "
              "compared, skipping")
        return 0
    here = hardware_key(device)
    if base_machine != here:
        print(f"[bench_pipeline] note: baseline measured on {base_machine}, "
              f"running on {here} — ratio gate is machine-"
              "independent, absolute ms are not comparable")
    tol = gate_tol()
    if gates is None:
        gates = measure_gate(device)
    failed = 0
    for phase in GATE_PHASES:
        cur = gates[phase]
        gate = prof.get(f"{phase}_gate")
        if not gate:
            print(f"[bench_pipeline] baseline has no quick '{phase}_gate' "
                  "record; skipping that phase")
            continue
        baseline = gate[f"{phase}_speedup_median"]
        current = cur[f"{phase}_speedup_median"]
        ratio = baseline / current          # >1: normalized time grew
        print(f"[bench_pipeline] {phase} speedup ({cur['backend']}): "
              f"baseline {baseline:.2f}x, current {current:.2f}x "
              f"-> normalized {phase} time {ratio:.2f}x")
        if ratio > tol:
            print(f"[bench_pipeline] FAIL: {phase} phase regressed "
                  f">{(tol - 1) * 100:.0f}%")
            failed = 1
    if not failed:
        print("[bench_pipeline] OK")
    return failed


def measure_compiled(path, device="cuda") -> int:
    """Opt-in compiled profile: the quick workload on the full read grid
    with the kernels compiled (on the card: the CUDA kernels), stored under
    ``compiled_<device type>``.  The regression gates only ever read
    ``profiles["quick"]``, so a compiled profile never perturbs --check.
    On the CPU the kernel wrappers run their plain versions: a note, exit
    0."""
    dev_type = torch.device(device).type
    if dev_type == "cpu":
        print("[bench_pipeline] --compiled: the device is the CPU, where "
              "the kernel wrappers run their plain versions; nothing to "
              "measure.  Run on the card to record a compiled_cuda "
              "profile.")
        return 0
    key = f"compiled_{dev_type}"
    print(f"[bench_pipeline] measuring compiled-mode quick profile "
          f"under {key!r} ...", flush=True)
    # the full read grid (no reduction), the kernels' serving group too
    measured = measure(("quick",), device=device, pallas_serving=True,
                       pallas_reduced_reads=0)
    rec = measured["quick"]
    rec["kernel_mode"] = "compiled"
    write(path, {key: rec})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="measure only the quick profile")
    ap.add_argument("--check", action="store_true",
                    help="compare a quick measurement against the device's "
                         "committed baseline instead of writing it")
    ap.add_argument("--compiled", action="store_true",
                    help="measure the quick profile on the full read grid "
                         "under compiled_<device type>; a no-op on the CPU")
    ap.add_argument("--support", action="store_true",
                    help="print the kernel-backend supports matrix and exit")
    ap.add_argument("--device", default="cuda",
                    help="the device to measure on (default cuda)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="the record to write (default results/bench_torch/"
                         "<cpu|cuda>/BENCH_pipeline.json) or, with --check, "
                         "the baseline (default: the device's committed "
                         "one)")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if args.out is not None and args.out.resolve() == ROOT_RECORD.resolve() \
            and not args.check:
        ap.error(f"{ROOT_RECORD} is the reference package's committed "
                 "record; write elsewhere")

    if args.support:
        from repro_torch.scripts import kernel_support
        return kernel_support.main(["--device", str(device)])
    if args.check:
        return check(args.out or (BASELINE if device.type == "cuda"
                                  else None), device)
    out = args.out or default_out(device)
    if args.compiled:
        return measure_compiled(out, device)
    profiles = ("quick",) if args.quick else ("quick", "full")
    measured = measure(profiles, device=device,
                       pallas_serving=not args.quick)
    # every write refreshes the gate baselines with the same interleaved
    # estimators --check uses, so the comparison is like-for-like
    for phase, rec in measure_gate(device).items():
        measured["quick"][f"{phase}_gate"] = rec
    write(out, measured)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
