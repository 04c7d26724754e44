"""The control and the faults that the comparison deciding ``correct`` has
to tell apart from the port, each put in the program's place, and their
readings at a cell's own size.

    python3 rsga_bench/controls.py --workload d5_ms_fixed.offline \
        --seeds 11,12,13 --seconds 5 [--out controls.jsonl]

* ``port``: the timed path itself (``run.port_program``), the sound reading;
* ``control``: the plain reference (``reference/mars.py``) mapping each
  chunk with the raw signal rounded to bfloat16, the precision next below
  the configuration's float32 signal (halving the host-to-device upload is
  the step a later change would be tempted by);
* ``half_batch``: the port maps the first half of each chunk's reads and
  leaves the rest out (their rows are the port's padding rows, its
  counters the half's);
* ``altered_answer``: the port with the first read's ``t_start`` of each
  chunk moved by one where it is produced.

A mapper has no state a step could return unchanged and one chip has no
exchange to leave out, so those faults do not apply.  For each seed the cell
is set up once (``run.setup_cell``), then each program runs a window of
``--seconds`` and is compared with the reference (``run.measure``, which
maps the seed's pool once for all of them); one JSON line each, with the
numbers compared.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Callable, Dict, NamedTuple

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rsga_bench.reference import mars  # noqa: E402


class _Out(NamedTuple):
    t_start: object
    score: object
    mapped: object
    n_events: object
    counters: Dict


def port(st: Dict) -> Callable:
    from rsga_bench import run
    return run.port_program(st["index"], st["cfg"], st["dev"],
                            st["program"])


def control(st: Dict) -> Callable:
    import torch
    dev = st["dev"]
    p = mars.Params.from_config(st["config"]["mars_config"])
    g = st["genome"]
    index = mars.index_tensors(
        mars.build_index(g.events_concat, g.n_events, p), dev)

    def fn(sig, nv):
        x = torch.from_numpy(np.ascontiguousarray(sig, np.float32)).to(dev)
        r = mars.map_reads(x, index, p, signal_dtype=torch.bfloat16)
        counters = {k: v[:nv].sum() for k, v in r.counters.items()}
        counters.update(
            n_reads=torch.tensor(nv, device=dev),
            n_samples=torch.tensor(nv * x.shape[1], device=dev))
        return _Out(r.t_start, r.score, r.mapped, r.n_events, counters)
    return fn


def half_batch(st: Dict) -> Callable:
    inner = port(st)

    def fn(sig, nv):
        part = np.array(sig, np.float32)
        part[nv // 2:] = 0.0
        return inner(part, nv // 2)
    return fn


def altered_answer(st: Dict) -> Callable:
    inner = port(st)

    def fn(sig, nv):
        out = inner(sig, nv)
        t = out.t_start.clone()
        t[0] += 1
        return out._replace(t_start=t)
    return fn


PROGRAMS: Dict[str, Callable] = {
    "port": port, "control": control, "half_batch": half_batch,
    "altered_answer": altered_answer}


def readings(name: str, seed: int, seconds: float, programs=PROGRAMS,
             device: str = "cuda", sizes=None, root: pathlib.Path = ROOT):
    """Yield one record a program: the cell set up once from ``seed``,
    then each program's window and comparison."""
    from rsga_bench import run
    st = run.setup_cell(name, seed, device, root, sizes)
    st.pop("map_fn")
    for prog, make in programs.items():
        t = time.perf_counter()
        one = dict(st, map_fn=make(st))
        res = run.measure(one, seconds, False, t, root)
        st["answers"] = one["answers"]     # the reference maps once a seed
        yield dict(workload=name, seed=seed, program=prog,
                   correct=res["correct"], attempted=res["attempted"],
                   checks={k: v["value"] for k, v in res["checks"].items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--programs", default=",".join(PROGRAMS))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from rsga_bench import run
    progs = {k: PROGRAMS[k] for k in args.programs.split(",")}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for rec in readings(args.workload, seed, args.seconds, progs):
                line = json.dumps(rec)
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
