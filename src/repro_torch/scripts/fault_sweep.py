"""Seeded fault-injection sweep: the degraded-mode gate.

Runs the three failure regimes the fault-tolerant storage path must
survive — tile corruption, drive loss, overload — on a tiny deterministic
dataset and asserts the bit-parity oracles:

  1. tile faults (core/faults.FaultPlan at the HotTileCache page-in
     boundary): every injected corruption / read failure is either healed
     by the checksummed retry loop — in which case MapOutput and the
     CHUNK_COUNTER_SCHEMA counters are byte-identical to the fault-free
     baseline — or raises a loud TileReadError.  NO silent wrong answers.
  2. drive loss: ``repartition_index`` folding any failed drive out of an
     N-way partitioning is bit-identical to ``partition_index`` at N/2.
  3. overload: the closed-loop ServeDriver (shed=True) sheds only
     sheddable reads under saturation, never the protected SLO class, and
     every served read still matches the batch mapper bit for bit.

Everything derives from ONE seed (--seed), so a red run reproduces
exactly.  Exit 0 = all oracles hold; exit 1 = a violation (printed).  The
lines are the JAX package's ``scripts/fault_sweep.py``'s.

    PYTHONPATH=src python -m repro_torch.scripts.fault_sweep [--seed 0]
        [--plans 50] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import (Mapper, MarsConfig, SLOClass, TileReadError,
                              build_index, partition_index,
                              repartition_index, sample_fault_plans)
from repro_torch.core.pipeline import check_device
from repro_torch.signal import simulate


def setup(seed: int):
    cfg = MarsConfig(hash_bits=12).with_mode("ms_fixed")
    ref = simulate.make_reference(8_000, seed=5 + seed)
    reads = simulate.sample_reads(ref, 24, signal_len=cfg.signal_len,
                                  seed=6 + seed, junk_frac=0.25)
    idx = build_index(ref.events_concat, ref.n_events, cfg)
    return cfg, idx, reads.signals


def sweep_tile_faults(cfg, idx, sig, base, n_plans: int, seed: int,
                      device) -> int:
    healed = raised = bad = 0
    for i, plan in enumerate(sample_fault_plans(n_plans, seed=seed)):
        m = Mapper(idx, cfg, backend="tiered", tiles=8, cache_slots=4,
                   fault_plan=plan, device=device)
        try:
            out = m.map_signals(sig, chunk=8)
        except TileReadError:
            raised += 1
            continue
        ok = (np.array_equal(np.asarray(out.t_start), np.asarray(base.t_start))
              and np.array_equal(np.asarray(out.score), np.asarray(base.score))
              and np.array_equal(np.asarray(out.mapped),
                                 np.asarray(base.mapped))
              and out.counters == base.counters)
        if ok:
            healed += 1
        else:
            bad += 1
            print(f"VIOLATION: plan #{i} ({plan}) served a SILENT wrong "
                  f"answer — neither healed parity nor TileReadError")
    print(f"[tile faults] {n_plans} plans: healed={healed} raised={raised} "
          f"silent-wrong={bad}")
    return bad


def sweep_drive_loss(idx) -> int:
    bad = 0
    for n in (2, 4, 8):
        fresh = partition_index(idx, n // 2)
        for failed in range(n):
            parts, remap = repartition_index(idx, n, failed)
            for k in fresh:
                if not np.array_equal(parts[k], fresh[k]):
                    bad += 1
                    print(f"VIOLATION: repartition_index({n}, failed="
                          f"{failed})[{k}] != partition_index({n // 2})")
            if failed in remap or len(remap) != n // 2:
                bad += 1
                print(f"VIOLATION: remap {remap} for n={n} failed={failed}")
    print(f"[drive loss] N in (2,4,8) x every failed drive: "
          f"{'parity holds' if not bad else f'{bad} violations'}")
    return bad


def sweep_overload(cfg, idx, sig, base, seed: int, device) -> int:
    bad = 0
    classes = [SLOClass("gold", priority=1, deadline=64.0, sheddable=False),
               SLOClass("best_effort")]
    srv = Mapper(idx, cfg, device=device).serve(
        chunk=8, shed=True, shed_window=4.0, slo_classes=classes)
    rng = np.random.default_rng(seed)
    trace = []
    for w in range(6):                 # ~36 reads/unit >> 8 rows/unit
        t = w * 0.5 + float(rng.uniform(0, 0.01))
        trace.append((t, f"g{w}", sig[:12], None, None, "gold"))
        trace.append((t, f"b{w}", sig[12:], None, None, "best_effort"))
    srv.serve_trace(trace)
    cr = srv.class_report()
    if srv.n_shed == 0:
        bad += 1
        print("VIOLATION: saturating trace shed nothing")
    if cr["gold"].n_shed != 0:
        bad += 1
        print(f"VIOLATION: protected class shed {cr['gold'].n_shed} reads")
    # every SERVED read still matches the batch mapper bit for bit
    for w in range(6):
        out = srv.results(f"g{w}")
        want = np.asarray(base.mapped)[:12]
        got = np.asarray(out.mapped)
        adm = np.asarray(srv.stream(f"g{w}").admitted)
        if not np.array_equal(got[adm], want[adm]):
            bad += 1
            print(f"VIOLATION: stream g{w} served results diverge")
    print(f"[overload] shed={srv.n_shed} "
          f"(gold={cr['gold'].n_shed}, "
          f"best_effort={cr.get('best_effort').n_shed if 'best_effort' in cr else 0}); "
          f"{'oracles hold' if not bad else f'{bad} violations'}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plans", type=int, default=50,
                    help="fault plans in the tile sweep (acceptance floor "
                         "is 50)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "torch path)")
    args = ap.parse_args(argv)
    check_device(args.device)

    cfg, idx, sig = setup(args.seed)
    base = Mapper(idx, cfg, device=args.device).map_signals(sig, chunk=8)
    bad = sweep_tile_faults(cfg, idx, sig, base, args.plans, args.seed,
                            args.device)
    bad += sweep_drive_loss(idx)
    bad += sweep_overload(cfg, idx, sig, base, args.seed, args.device)
    if bad:
        print(f"FAULT SWEEP FAILED: {bad} oracle violations (seed "
              f"{args.seed} reproduces)")
        return 1
    print(f"fault sweep OK (seed {args.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
