"""Dump the kernel-backend supports matrix: for a panel of configs, which
registered backend actually serves each stage of each requested plan, and
whether the fused cheap-phase kernel engages or the chunk program falls
back to the per-stage ladder.

    PYTHONPATH=src python -m repro_torch.scripts.kernel_support [--device cpu]

A stage prints its serving backend name; a stage whose requested backend
exists but whose ``supports`` gate rejected the config prints
``reference (<name> unsupported)`` so silent fallbacks are visible.  The
``fused_cheap`` row shows the whole-phase resolution from
``stages.fused_cheap_backend`` — "fused:<name>" when the fused kernel will
run, otherwise why not (plan mismatch or supports gate).  The lines are
the JAX package's ``scripts/kernel_support.py``'s with ``pallas`` named
``kernels``.
"""
from __future__ import annotations

import argparse

from repro_torch.core import stages
from repro_torch.core.config import MarsConfig
from repro_torch.core.pipeline import check_device

BACKENDS = (stages.KERNELS, "ring", "a2a", "tiered")


def configs():
    base = MarsConfig(hash_bits=12)
    return (
        ("ms_fixed", base.with_mode("ms_fixed")),
        ("ms_float", base.with_mode("ms_float")),
        ("rh2", base.with_mode("rh2")),
        # wide t-stat window: overflows the int32 fixed-point t-stat, so
        # the fixed kernels' supports gates must reject it
        ("ms_fixed_w13", base.with_mode("ms_fixed").replace(tstat_window=13)),
    )


def _fused_row(plan, cfg) -> str:
    b = stages.fused_cheap_backend(plan, cfg)
    if b is not None:
        return f"fused:{b.name}"
    # explain which leg of the engagement test failed
    by_stage = dict(plan)
    names = {by_stage[s] for s in stages.CHEAP_STAGES}
    cand = [fb for fb in stages._FUSED_CHEAP.values() if fb.name in names]
    if not cand:
        return "per-stage (no fused kernel in plan)"
    fb = cand[0]
    if fb.supports is not None and not fb.supports(cfg):
        return f"per-stage ({fb.name} supports gate rejected cfg)"
    return "per-stage (plan shape mismatch)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the device the plans are for (default cuda)")
    check_device(ap.parse_args(argv).device)
    for cfg_name, cfg in configs():
        print(f"=== config {cfg_name} (fixed_point={cfg.fixed_point}, "
              f"early_quantization={cfg.early_quantization}, "
              f"tstat_window={cfg.tstat_window}) ===")
        for backend in BACKENDS:
            plan = stages.resolve_plan(cfg, backend)
            cells = []
            for stage, name in plan:
                if name == backend or name == stages.REFERENCE and (
                        stage, backend) not in stages._REGISTRY:
                    cells.append(f"{stage}={name}")
                else:
                    cells.append(f"{stage}={name} ({backend} unsupported)")
            print(f"  plan {backend:7s}: " + "  ".join(cells))
            if backend == stages.KERNELS:
                print(f"  {'fused_cheap':12s}: {_fused_row(plan, cfg)}")
        print()
    print("registered fused cheap-phase kernels: "
          + (", ".join(sorted(stages._FUSED_CHEAP)) or "(none)"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
