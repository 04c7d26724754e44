"""Shared benchmark machinery: cached pipeline runs + paper-scale workloads
+ host-model calibration.

Every benchmark module draws from the same measured runs (one per
dataset x mode, cached under ``results/bench_torch/<device type>/``) so
figures are consistent.  The records equal the JAX package's field for
field (``jax_records.json`` holds its 15), so every figure derived from
them equals the JAX package's too.

Calibration: the paper's own evaluation is simulation-based; its absolute
RH2 runtimes are derived from Table 4 (exact MARS throughputs) and the
average speedups of Fig. 11 with a small->large genome profile (documented
in EXPERIMENTS.md).  Host component rates are fitted per stage so the
modeled RH2 matches those totals and the Fig. 5 stage fractions.  Every
figure is an output of the cost models (core/ssd_model.py, core/sim/), not
a time measured on the device the pipeline ran on.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import Mapper, build_index, score_accuracy
from repro_torch.core import costmodel, ssd_model, stages, workload
from repro_torch.core.pipeline import check_device
from repro_torch.signal import datasets

CACHE = pathlib.Path("results/bench_torch")

# --- paper-derived anchors (see EXPERIMENTS.md Calibration) ---------------- #
# Table 4 MARS throughputs (bp/s) -> exact MARS runtimes:
PAPER_MARS_T = {k: datasets.DATASETS[k].paper_bases / tp for k, tp in
                dict(D1=46_655_128, D2=5_274_148, D3=1_202_660,
                     D4=1_277_764, D5=286_728).items()}
# Fig. 11 speedup profile over RH2 (avg 28x, larger for small genomes):
RH2_SPEEDUP = dict(D1=54.2, D2=36.1, D3=22.6, D4=18.1, D5=9.0)
PAPER_RH2_T = {k: PAPER_MARS_T[k] * s for k, s in RH2_SPEEDUP.items()}
# Fig. 5 stage fractions of RH2 runtime (io, event, seed, chain):
FIG5_FRACTIONS = {
    "D1": (0.41, 0.205, 0.06, 0.331),
    "D2": (0.30, 0.15, 0.07, 0.48),
    "D3": (0.25, 0.10, 0.06, 0.59),
    "D4": (0.10, 0.05, 0.05, 0.80),
    "D5": (0.02, 0.01, 0.043, 0.927),
}


def git_sha() -> str:
    """The checkout's short commit, or "unknown" outside a git checkout."""
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_device(device=None, mesh=None) -> torch.device:
    """The device a run maps on: the mesh's, else ``device`` (CUDA by
    default; without a card it raises unless given the CPU)."""
    if mesh is not None:
        return mesh.device
    return check_device("cuda" if device is None else device)


def pipeline_run(ds_key: str, mode: str, force: bool = False,
                 backend: str = stages.REFERENCE, mesh=None,
                 device=None) -> Dict:
    """Run (or load cached) one dataset x mode mapping; returns counters,
    accuracy, wall time and raw sizes.

    ``backend`` selects the stage-registry backend plan ("reference",
    "kernels", or — with a ``mesh``, inside a rank program — the
    partitioned-index query schedules "ring"/"a2a"); counters follow the
    chunk counter schema in every case, so the hardware model consumes
    all of them identically.  Records are cached per device type: a CPU
    record never stands in for a card's."""
    dev = run_device(device, mesh)
    suffix = "" if backend == stages.REFERENCE else f"_{backend}"
    if mesh is not None:      # distributed runs cache per mesh shape
        suffix += "_" + "x".join(f"{a}{n}" for a, n in mesh.shape.items())
    cache = CACHE / dev.type
    f = cache / f"{ds_key}_{mode}{suffix}.json"
    if f.exists() and not force:
        return json.loads(f.read_text())
    spec = datasets.DATASETS[ds_key]
    cfg = datasets.config_for(spec).with_mode(mode)
    ref, reads = datasets.build(spec, cfg)
    index = build_index(ref.events_concat, ref.n_events, cfg)
    mapper = Mapper(index, cfg, backend=backend, mesh=mesh, device=dev)
    # explicit warm-up: map one read first so the timed run below is
    # steady-state (library load and allocator growth excluded)
    mapper.map_signals(reads.signals[:1], chunk=32)
    t0 = time.time()
    out = mapper.map_signals(reads.signals, chunk=32)
    wall = time.time() - t0
    acc = score_accuracy(out, reads.true_pos, reads.true_strand,
                         reads.mappable, reads.n_bases, ref.n_events)
    rec = dict(
        dataset=ds_key, mode=mode, backend=backend, git_sha=git_sha(),
        device=str(dev),
        mesh=None if mesh is None else dict(mesh.shape),
        plan=[list(p) for p in mapper.plan],
        counters={k: int(v) for k, v in out.counters.items()},
        accuracy={k: float(v) for k, v in acc.items()},
        wall_time=wall,
        index_bytes=int(index.nbytes),
        bench_bytes_raw=int(out.counters["n_samples"]) * 2,
        n_reads=int(spec.bench_reads),
    )
    if mesh is None or mesh.rank == 0:
        # every rank of a mesh computes the same record; one writes it,
        # whole (a rename), so no reader sees a partial file
        cache.mkdir(parents=True, exist_ok=True)
        tmp = f.with_suffix(".tmp")
        tmp.write_text(json.dumps(rec))
        tmp.replace(f)
    return rec


def workload_for(ds_key: str, mode: str, device=None) -> workload.Workload:
    """Paper-scale workload for the analytic hardware model.

    Two extrapolation factors: signal volume (paper_bytes/bench_bytes)
    scales everything linearly; genome size additionally inflates
    collision-driven counts (seed hits / anchors / DP pairs): spurious
    candidate positions grow linearly with reference length, and the
    paper's frequency thresholds scale UP with genome size (2000 -> 20000,
    Section 5.1) so the filter does not cancel the growth — exponent 1.0
    (see EXPERIMENTS.md Calibration)."""
    rec = pipeline_run(ds_key, mode, device=device)
    spec = datasets.DATASETS[ds_key]
    cfg = datasets.config_for(spec).with_mode(mode)
    w = workload.from_counters(rec["counters"], cfg, rec["index_bytes"])
    factor = spec.bytes_scale_factor(rec["bench_bytes_raw"])
    w = w.scale(factor)
    g = spec.genome_scale_factor ** 1.0
    for f in ("n_hits_raw", "n_hits_exact", "n_hits_postfreq", "n_votes",
              "n_anchors_postvote", "n_sorted", "n_dp_pairs"):
        setattr(w, f, int(getattr(w, f) * g))
    # the index itself scales with genome size, not signal volume
    w.bytes_index = int(rec["index_bytes"] * spec.genome_scale_factor)
    return w


# fitted rates per record directory (CACHE / device type)
_CALIB_CACHE: Dict[pathlib.Path, ssd_model.HostRates] = {}


def calibrated_host(device=None) -> ssd_model.HostRates:
    """Closed-form per-stage calibration: for every dataset the paper gives
    (total RH2 runtime, stage fraction); each stage's inverse rate is the
    geometric mean over datasets of  frac * T_total / W_stage.  Per-stage
    closed form avoids the scale pathologies of a joint least-squares fit
    (the io byte counts are ~6 orders larger than anchor counts)."""
    key = CACHE / run_device(device).type
    if key in _CALIB_CACHE:
        return _CALIB_CACHE[key]
    stage_names = ("io", "event", "seed", "chain")
    per_stage = {s: [] for s in stage_names}
    for ds in datasets.DATASETS:
        w = workload_for(ds, "rh2", device)
        comp = ssd_model.host_components(w)
        total = PAPER_RH2_T[ds]
        for i, s in enumerate(stage_names):
            if comp[s] > 0:
                per_stage[s].append(FIG5_FRACTIONS[ds][i] * total / comp[s])
    gm = {s: float(np.exp(np.mean(np.log(v)))) for s, v in per_stage.items()}
    _CALIB_CACHE[key] = ssd_model.HostRates(
        inv_io=gm["io"], inv_event=gm["event"], inv_seed=gm["seed"],
        inv_chain=gm["chain"])
    return _CALIB_CACHE[key]


# The JAX package's streamed outputs of chip_smoke.py's six [map] cells (D1
# and D5 x rh2/ms_float/ms_fixed, 4096 reads in chunks of 512), as
# ``map_digest`` gives them; tests/test_torch_map_digest.py writes it
MAP_DIGEST = pathlib.Path(__file__).with_name("jax_map_digest.json")
# each per-read field as little-endian bytes of one fixed dtype
DIGEST_FIELDS = (("t_start", "<i4"), ("score", "<f4"), ("mapped", "|b1"),
                 ("n_events", "<i4"))


def map_digest(out, chunk: int) -> Dict:
    """A digest of a streamed host ``MapOutput``: a SHA-256 of each per-read
    field over the whole run, one of each ``chunk`` reads' fields (to name
    the first chunk that differs), and the summed chunk counters."""
    fields = {f: np.ascontiguousarray(np.asarray(getattr(out, f)), dt)
              for f, dt in DIGEST_FIELDS}
    n = len(fields["t_start"])
    return dict(
        n_reads=n, chunk=chunk,
        fields={f: hashlib.sha256(a.tobytes()).hexdigest()
                for f, a in fields.items()},
        chunks=[hashlib.sha256(b"".join(a[i:i + chunk].tobytes()
                                        for a in fields.values()))
                .hexdigest() for i in range(0, n, chunk)],
        counters={k: int(v) for k, v in sorted(out.counters.items())})


def digest_mismatch(got: Dict, want: Dict) -> Optional[str]:
    """None when two ``map_digest``s are equal, else what differs first: the
    read count, the first differing chunk (and the fields that differ), or
    the counters."""
    if (got["n_reads"], got["chunk"]) != (want["n_reads"], want["chunk"]):
        return (f"{got['n_reads']} reads in chunks of {got['chunk']} vs "
                f"{want['n_reads']} in chunks of {want['chunk']}")
    for ci, (g, w) in enumerate(zip(got["chunks"], want["chunks"])):
        if g != w:
            fields = [f for f in got["fields"]
                      if got["fields"][f] != want["fields"][f]]
            return (f"chunk {ci} (reads {ci * got['chunk']}-"
                    f"{(ci + 1) * got['chunk'] - 1}) is the first that "
                    f"differs; fields {fields}")
    if got["fields"] != want["fields"]:
        return "the per-read fields differ"
    if got["counters"] != want["counters"]:
        diff = {k: (got["counters"].get(k), want["counters"].get(k))
                for k in set(got["counters"]) | set(want["counters"])
                if got["counters"].get(k) != want["counters"].get(k)}
        return f"counters differ (got, want): {diff}"
    return None


def csv_line(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.3f},{derived}"


def main(run, doc: str, argv=None, model: bool = False) -> None:
    """The command line of one table or figure module: ``--device`` (and,
    for the cost-model figures, ``--model``); prints its CSV lines."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    if model:
        ap.add_argument("--model", default="analytic",
                        choices=sorted(costmodel.MODELS))
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline records are mapped (cuda, or "
                         "cpu for the plain torch path)")
    run(print, **vars(ap.parse_args(argv)))
