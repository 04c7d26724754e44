"""Run one cell of the port's benchmark once.

    python3 rsga_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's data from ``--seed`` (the synthetic genome, the
port's index over it, a host pool of reads), loads the port's kernels
(built once into ``build/repro_torch_kernels`` inside the checkout) and
warms the cell's chunk shape with one pass over the pool.  The window
then drives ``repro_torch.core.Mapper(index, cfg, use_kernels=True,
device="cuda").chunk_fn()`` (with the options the configuration's and the
cell's ``program`` give) through ``repro_torch.core.driver.stream_map``
for ``--seconds`` seconds, as the cell's traffic mix says
(``traffic.py``).  After the window the plain reference maps the pool and
every chunk answered is compared with it (``check.py``).  The last line of
standard output is the result: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read under
``torch.profiler``.  The numbers compared, each with its limit, are the
last lines of standard error and the result's last key.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()      # set-up is timed from here

import argparse      # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import pathlib       # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rsga_bench import check, datagen, manifest, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level names
SPAN_NAMES = ("window", "source", "map_fn", "collect", "sleep")
PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def mars_config(config: Dict):
    from repro_torch.core import MarsConfig
    mc = dict(config["mars_config"])
    mc["chain_widths"] = tuple(mc["chain_widths"])
    return MarsConfig(**mc)


def port_program(index, cfg, device, options: Optional[Dict] = None
                 ) -> Callable:
    """The timed path: the port's Mapper with its CUDA kernels, built with
    the keyword arguments the configuration's and the cell's ``program``
    give (a backend, say)."""
    from repro_torch.core import Mapper
    kw = {"use_kernels": True, **(options or {})}
    return Mapper(index, cfg, device=device, **kw).chunk_fn()


def _card_info(device) -> Dict:
    import torch
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                    device)))


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def setup_cell(name: str, seed: int, device: str = "cuda",
               root: pathlib.Path = manifest.ROOT,
               sizes: Optional[Dict] = None,
               marks: Optional[list] = None) -> Dict:
    """Cell ``name``'s set-up: the data from ``seed``, the port's index
    over it, the timed path (``port_program``) and one warm pass over the
    pool.  ``sizes`` overrides the configuration's
    ``genome_len`` and the mix's sizes (CPU tests run a tiny cell);
    ``marks`` are the (stage, time) marks of the process so far."""
    import torch
    from repro_torch.core import build_index
    from repro_torch.core.driver import stream_map

    m = manifest.load(root)
    c = manifest.cell(m, name, root)
    config, mix = dict(c["config"]), dict(c["traffic"])
    sizes = sizes or {}
    config["genome_len"] = sizes.get("genome_len", config["genome_len"])
    mix.update({k: v for k, v in sizes.items() if k in mix})
    dev = torch.device(device)
    cfg = mars_config(config)
    reads = config["reads"]

    marks = list(marks or []) + [("manifest", time.perf_counter())]
    if dev.type == "cuda":
        torch.zeros(1, device=dev)           # the card's context
        marks.append(("context", time.perf_counter()))
    genome = datagen.make_genome(config["genome_len"], seed)
    pool = datagen.make_pool(genome, mix["pool_reads"], cfg.signal_len, seed,
                             dwell=tuple(reads["dwell"]),
                             noise_sigma=reads["noise_sigma"],
                             junk_frac=reads["junk_frac"], device=dev)
    if dev.type == "cuda":                   # the peak is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("data", time.perf_counter()))
    index = build_index(genome.events_concat, genome.n_events, cfg)
    marks.append(("index", time.perf_counter()))
    map_fn = port_program(index, cfg, dev, c["program"])
    marks.append(("program", time.perf_counter()))
    traffic.warm(map_fn, stream_map, pool, mix)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    return dict(name=name, manifest=m, config=config, mix=mix, dev=dev,
                program=c["program"],
                genome=genome, pool=pool, index=index, cfg=cfg,
                map_fn=map_fn, stream_map=stream_map, marks=marks,
                signal_len=cfg.signal_len)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: pathlib.Path = manifest.ROOT,
             sizes: Optional[Dict] = None,
             marks: Optional[list] = None) -> Dict:
    """One run of cell ``name``: returns the result line's object (see
    ``setup_cell`` for ``sizes`` and ``marks``; set-up is timed from the
    first mark)."""
    marks = marks or [("start", time.perf_counter())]
    st = setup_cell(name, seed, device, root, sizes, marks)
    return measure(st, seconds, trace, marks[0][1], root)


def measure(st: Dict, seconds: float, trace: bool, t_process: float,
            root: pathlib.Path = manifest.ROOT) -> Dict:
    """The window over a cell set up by ``setup_cell`` (its ``map_fn``,
    which this drops before the reference runs), the comparison and the
    metrics."""
    import torch

    m, config, mix, dev = st["manifest"], st["config"], st["mix"], st["dev"]
    genome, pool, marks = st["genome"], st["pool"], st["marks"]
    map_fn, stream_map, S = st.pop("map_fn"), st["stream_map"], \
        st["signal_len"]
    name = st["name"]

    # ---- the window ------------------------------------------------------------
    red = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        spans = traffic.Spans(annotate=record_function)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with spans("window"):
                record = traffic.run(map_fn, stream_map, pool, mix,
                                     seconds, spans, root)
        from rsga_bench import trace as trace_mod
        red = trace_mod.reduce(prof.profiler.kineto_results.events(),
                               SPAN_NAMES)
    else:
        spans = traffic.Spans()
        record = traffic.run(map_fn, stream_map, pool, mix, seconds,
                             spans, root)
    setup_s = record["t0"] - t_process
    device_info = _card_info(dev)

    # ---- the program's state goes; the reference maps the pool --------------
    del map_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ans = st.get("answers")          # the controls reuse one seed's answers
    if ans is None:
        ans = st["answers"] = check.reference_answers(
            pool, genome.events_concat, genome.n_events,
            config["mars_config"], dev, mix["chunk"])
    numbers = check.compare(record, ans, S)
    ref_s = time.perf_counter() - t_ref

    # ---- metrics ------------------------------------------------------------
    peaks = json.loads(PEAKS.read_text()).get(device_info["kind"])
    def roofline(kernel):
        return trace_share(red, kernel, peaks,
                           lambda: check.chunk_work(record, ans,
                                                    mix["chunk"]),
                           manifest.roofline_count(kernel, root),
                           config["mars_config"])

    ctx = dict(record=record, setup_s=setup_s, spans=spans.rows, trace=red,
               chunk=mix["chunk"], roofline=roofline)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for metric in manifest.metrics_for(m, name)[kind]:
        v = manifest.reader(metric["name"], root)(ctx)
        if v is not None:
            metrics[metric["name"]] = dict(value=float(v),
                                           unit=metric["unit"])
    if trace and red is not None:
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])

    # ---- what the record shows besides the metrics (not judged) -------------
    n_chunks = len(record["chunks"])
    log("[setup] " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])))
    log(f"[window] {n_chunks} chunks, {record['due_reads']} reads due, "
        f"{record['t1'] - record['t0']:.3f} s; set-up {setup_s:.3f} s; "
        f"reference {ref_s:.3f} s")
    if record["loop"] == "bursts":
        late = sorted(record["late_s"])
        lat = traffic.latencies_s(record)
        log(f"[bursts] {record['bursts_due']} due, {len(late)} started; "
            f"generator late: median {1e3 * late[len(late) // 2]:.3f} ms, "
            f"max {1e3 * late[-1]:.3f} ms; reads decided after "
            f"{record['interval_s']} s: "
            f"{100.0 * float((lat > record['interval_s']).mean()):.3f}%")
    if trace and red is not None:
        log(f"[trace] busy {red['busy_s']:.6f} s of {red['window_s']:.6f} s, "
            f"{red['n_device_ops']} device ops")
    if device_info["platform"] == "gpu":
        log(f"[card] {_smi()}")
    for k, v in numbers.items():
        log(f"check {k} {v} limit {check.LIMITS[k]}")

    failed = numbers["wrong_reads"] + numbers["missing_reads"]
    result = dict(
        correct=all(v <= check.LIMITS[k] for k, v in numbers.items()),
        attempted=int(record["due_reads"]), failed=int(failed),
        metrics=metrics, device=device_info)
    if trace and red is not None:
        result["breakdown"] = red["breakdown"]
    result["checks"] = {k: dict(value=v, limit=check.LIMITS[k])
                        for k, v in numbers.items()}
    return result


def trace_share(red, kernel: str, peaks, work_fn, count, mars_config
                ) -> Optional[float]:
    """``kernel``'s share of its roofline, in %: the least time the card
    could take for the work the window's reads need (``count``: int32 and
    float32 operations, bytes) over the kernel's device time by name.  The
    least time is the longest of the int32 pipe's, the float32 pipe's, the
    issue rate's (every operation one issue) and HBM's.  None where the
    trace, the card's peaks, the count or the kernel's time is missing."""
    if red is None or peaks is None or count is None:
        return None
    from rsga_bench import trace as trace_mod
    secs = trace_mod.kernel_seconds(red, kernel)
    work = work_fn() if secs > 0 else None
    if work is None:
        return None
    int_ops, fp_ops, nbytes = count(work, mars_config)
    least = max(int_ops / peaks["int32_ops_per_s"],
                fp_ops / peaks["fp32_ops_per_s"],
                (int_ops + fp_ops) / peaks["issue_ops_per_s"],
                nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the harness's modules import torch
    marks = [("start", T_PROCESS), ("imports", time.perf_counter())]

    try:
        m = manifest.load()
        chips = manifest.cell(m, args.workload)["workload"]["chips"]
    except (OSError, KeyError, ValueError) as e:
        log(f"error: {e}")
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: the cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    sys.path.insert(0, str(manifest.ROOT / "src"))
    try:
        import repro_torch.core  # noqa: F401
    except ImportError as e:
        log(f"error: the program (src/repro_torch) is not importable: {e}")
        return 3
    marks.append(("program import", time.perf_counter()))
    log(f"[host] {torch.get_num_threads()} intra-op threads")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), marks=marks)
    bad = forbidden_modules(sys.modules)
    if bad:
        log(f"error: the process loaded {', '.join(bad)}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
