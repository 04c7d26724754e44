"""Event-driven MARS in-storage batch simulator.

The analytic model (``core/ssd_model.py``) collapses a batch into
``max(flash, compute) + 0.02 * min(flash, compute)``.  This module plays
the same Workload through an explicit machine instead:

  * the raw signal + index bytes stripe evenly over ``ssd.channels``
    flash channels; each channel's share is read in ``n_stripes``
    stripe segments by its ``chips_per_channel`` dies (per-die busy
    windows: a die is occupied ``t_read`` per segment; the one-time DMA
    setup ``t_dma`` rides the first segment) and streamed over the
    channel at ``channel_bw``;
  * a stripe becomes computable when EVERY channel has delivered its
    segment; the controller then sequences the stripe's PNM chain —
    event detection / hashing / filters / DP on the arithmetic units,
    the pLUTo query sweep on the query units, bucket sort on the
    sorter pairs, intermediate traffic over the internal DRAM — one
    stripe at a time (the units share the internal DRAM subarrays, so
    stripes do not overlap each other's compute);
  * flash prefetch runs ``buffer_depth`` stripes ahead of compute
    (Section 6.3 double buffering), which is exactly what produces the
    analytic overlap law: with ``n_stripes = 50`` the non-overlapped
    residual is 1/50 = the closed form's 0.02 factor, so degenerate
    (no-contention) configs reproduce ``mars_latency`` to <1% — the
    calibration gate of tests/test_sim.py and scripts/bench_sim.py.

Per-stage service times come from the same Table-1 rate constants the
analytic model uses (``ssd_model.mars_stage_times``); what the simulator
adds is WHERE the time goes — per-channel / per-die / per-unit busy,
idle and queue-delay stats (``engine.stats_table``) and controller
stalls the closed form cannot express under contention.

The JAX package's ``repro.core.sim.ssdsim``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import ssd_model
from repro_torch.core.sim import engine
from repro_torch.core.workload import Workload

# Stripes per batch.  1/N_STRIPES is the non-overlapped pipeline residual,
# matching the analytic model's 0.02 factor (Section 6.3 calibration).
N_STRIPES = 50


def simulate_batch(w: Workload, ssd: ssd_model.SSDConfig = ssd_model.SSDConfig(),
                   n_stripes: int = N_STRIPES,
                   buffer_depth: int = 2,
                   query_scale: float = 1.0) -> Dict[str, object]:
    """Event-driven batch latency of ``w`` on one MARS SSD.

    ``query_scale`` stretches the pLUTo query-unit stage by a load-
    imbalance factor (>= 1 under hot-bucket skew, back toward 1 with
    replication — see ``costmodel.skew_factors``): the query units serve
    buckets bank-by-bank, so probes concentrating on few buckets serialize
    on the hot bank while the rest idle.  The default 1.0 is bit-exact
    with the unscaled simulator.

    Returns the ``mars_latency`` keys (total / compute / flash / per-stage
    times) plus ``components`` (per-component busy/idle/queue-delay
    decomposition), ``controller`` (compute busy + flash-stall time) and
    ``event_log`` (the deterministic event trace).
    """
    if n_stripes < 1:
        raise ValueError(f"n_stripes must be >= 1; got {n_stripes}")
    if buffer_depth < 1:
        raise ValueError(f"buffer_depth must be >= 1; got {buffer_depth}")
    if query_scale <= 0:
        raise ValueError(f"query_scale must be > 0; got {query_scale}")
    st = dict(ssd_model.mars_stage_times(w, ssd))
    # q - old == 0.0 exactly at scale 1.0, keeping the default bit-exact
    q = st["seeding_query"] * query_scale
    st["seeding"] = st["seeding"] + (q - st["seeding_query"])
    st["seeding_query"] = q
    P = int(n_stripes)

    sim = engine.Simulator()
    dies = [engine.Component(sim, f"ch{c}.dies", ssd.chips_per_channel)
            for c in range(ssd.channels)]
    chans = [engine.Component(sim, f"ch{c}", 1, rate=ssd.channel_bw)
             for c in range(ssd.channels)]
    au = engine.Component(sim, "arith_units", 1)
    qu = engine.Component(sim, "query_units", 1)
    sorter = engine.Component(sim, "sorter", 1)
    dram = engine.Component(sim, "internal_dram", 1, rate=ssd.dram_bw)
    comps: List[engine.Component] = dies + chans + [au, qu, sorter, dram]

    share = (w.bytes_raw + w.bytes_index) / ssd.channels
    seg_bytes = share / P
    # the stripe's PNM chain, controller-sequenced in stage order
    chain = [(au, st["event_detection"] / P, "ed"),
             (au, st["seeding_hash"] / P, "hash"),
             (qu, st["seeding_query"] / P, "query"),
             (au, st["filters"] / P, "filters"),
             (sorter, st["sorting"] / P, "sort"),
             (au, st["chaining_dp"] / P, "dp"),
             (dram, st["dram_move"] / P, "dram")]

    pending = [ssd.channels] * P          # undelivered channel segments
    flash_done: List[Optional[float]] = [None] * P
    released = [False] * P
    state = dict(next=0, busy=False, compute_end=0.0, last_delivery=0.0)
    controller = dict(busy_time=0.0, stall_flash=0.0, n_stripes=P)

    def release(i: int) -> None:
        if i >= P or released[i]:
            return
        released[i] = True
        for c in range(ssd.channels):
            dies[c].submit(duration=ssd.t_read,
                           done=_transfer(c, i), tag=("read", i))

    def _transfer(c: int, i: int):
        def go():
            dur = seg_bytes / ssd.channel_bw + (ssd.t_dma if i == 0 else 0.0)
            chans[c].submit(duration=dur, done=_delivered(i), tag=("xfer", i))
        return go

    def _delivered(i: int):
        def go():
            pending[i] -= 1
            if pending[i] == 0:
                flash_done[i] = sim.now
                state["last_delivery"] = sim.now
                _try_compute()
        return go

    def _try_compute() -> None:
        i = state["next"]
        if state["busy"] or i >= P or flash_done[i] is None:
            return
        state["busy"] = True
        # double buffering: pull the next flash stripe as compute starts
        release(i + buffer_depth)
        controller["stall_flash"] += max(0.0, flash_done[i]
                                         - state["compute_end"])
        _run_chain(i, 0)

    def _run_chain(i: int, k: int) -> None:
        if k == len(chain):
            state["compute_end"] = sim.now
            state["busy"] = False
            state["next"] = i + 1
            controller["busy_time"] += sum(d for _, d, _ in chain)
            _try_compute()
            return
        comp, dur, tag = chain[k]
        comp.submit(duration=dur, done=lambda: _run_chain(i, k + 1),
                    tag=(tag, i))

    for i in range(min(buffer_depth, P)):
        release(i)
    total = sim.run()

    compute = (st["event_detection"] + st["seeding"] + st["filters"] +
               st["sorting"] + st["chaining_dp"] + st["dram_move"])
    # the flash subsystem's own (ungated) completion: per-channel busy is
    # t_dma + share/bw; the first die read adds the t_read startup
    flash = max(c.stats["busy_time"] for c in chans) + ssd.t_read
    out: Dict[str, object] = dict(total=total, compute=compute, flash=flash,
                                  **{k: v for k, v in st.items()
                                     if k != "flash"})
    out["components"] = engine.stats_table(comps, total)
    out["controller"] = controller
    out["n_stripes"] = P
    out["event_log"] = sim.event_log
    return out


def simulate_array_latency(w: Workload,
                           arr: ssd_model.SSDArrayConfig = ssd_model.SSDArrayConfig(),
                           n_stripes: int = N_STRIPES) -> Dict[str, object]:
    """Event-driven twin of ``ssd_model.mars_array_latency``: every serving
    drive runs its 1/N bucket-range share (drives are symmetric, so one
    simulated drive stands for all), then the host link carries the
    per-read result merge and the controller pays per-drive dispatch."""
    per = w.scale(1.0 / arr.n_serving)
    drive = simulate_batch(per, arr.ssd, n_stripes=n_stripes)
    t_merge = (w.n_reads * arr.result_bytes_per_read) / arr.ssd.pcie_bw
    t_orch = arr.n_serving * arr.t_dispatch
    comps = dict(drive["components"])
    comps["host_link"] = dict(busy_time=t_merge, idle_time=0.0,
                              queue_delay=0.0, n_tasks=int(w.n_reads),
                              work=float(w.n_reads * arr.result_bytes_per_read),
                              utilization=1.0 if t_merge > 0 else 0.0)
    return dict(total=drive["total"] + t_merge + t_orch,
                per_ssd=drive["total"], merge=t_merge, orchestration=t_orch,
                compute=drive["compute"], flash=drive["flash"],
                components=comps, controller=drive["controller"])


def simulate_dram_sensitivity(w: Workload, sizes=(2 << 30, 4 << 30, 8 << 30),
                              ssd: ssd_model.SSDConfig = ssd_model.SSDConfig(),
                              n_stripes: int = N_STRIPES) -> Dict[int, float]:
    """Fig. 13 through the simulator: the same config scaling rule as
    ``ssd_model.dram_size_sensitivity`` (compute units scale with DRAM,
    small DRAM re-streams the index), with each point simulated."""
    import dataclasses
    out = {}
    base = ssd.dram_bytes
    for size in sizes:
        f = size / base
        cfg = dataclasses.replace(
            ssd, dram_bytes=size,
            dram_subarrays=int(ssd.dram_subarrays * f),
            n_arith_units=int(ssd.n_arith_units * f),
            n_query_units=int(ssd.n_query_units * f))
        passes = max(1.0, w.bytes_index / (0.6 * size))
        ww = dataclasses.replace(w, bytes_index=int(w.bytes_index * passes))
        out[size] = simulate_batch(ww, cfg, n_stripes=n_stripes)["total"]
    return out
