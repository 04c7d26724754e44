"""Analytic MARS hardware performance / energy / area model.

The paper evaluates MARS with MQSim (SSD timing), CACTI7 (DRAM/PIM timing +
energy) and Synopsys DC synthesis (sorter/merger timing + area), combining
component latencies with data-movement transfer times (Section 7).  This
module is the equivalent analytic model: it converts Workload counts
(workload.py, measured on the real pipeline and scaled to paper-size
datasets) into per-stage latencies and energies for MARS and every baseline
system of Section 7.

Two calibration domains:
  * in-storage units — first-principles from Table 1 (+FULCRUM/pLUTo/DC
    numbers): 256 AUs @164 MHz, 512 QUs (4*tRC pLUTo query), 8 sorter/
    merger pairs @1 GHz, 8x1 GB/s flash channels;
  * host software (RH2 / MS-CPU / minimap2 side) — component rates fitted
    against the paper's own totals (Table 4 + Fig. 11 profile) and Fig. 5
    stage fractions; see benchmarks/common.calibrated_host().

This module is the ANALYTIC backend of the ``core/costmodel.py``
Workload->cost interface.  The closed forms here stay the calibration
oracle; the event-driven twin (``core/sim/``) plays the same Workload
through an explicit machine (channels x dies, PNM units, internal DRAM)
and must agree with these formulas to <1% on degenerate no-contention
configs (tests/test_sim.py, scripts/bench_sim.py).

The JAX package's ``repro.core.ssd_model``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

from repro_torch.core.workload import Workload


# --------------------------------------------------------------------------- #
# Hardware constants (paper Table 1 + cited parts)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SSDConfig:
    channels: int = 8
    chips_per_channel: int = 8
    channel_bw: float = 1.0e9          # B/s per flash channel (Table 1)
    t_dma: float = 16e-6               # s
    t_read: float = 22.5e-6            # s (TLC page read)
    page_bytes: int = 16 * 1024
    pcie_bw: float = 7.0e9             # B/s external (PM1735)

    dram_bytes: int = 4 << 30          # 4 GB LPDDR4
    dram_subarrays: int = 512
    dram_row_bytes: int = 2048
    dram_trc: float = 60e-9            # row cycle
    dram_bw: float = 8.5e9             # B/s streaming

    n_arith_units: int = 256           # Section 6.1.1
    arith_freq: float = 164e6
    n_query_units: int = 512
    n_sorters: int = 8
    sorter_freq: float = 1.0e9
    sorter_width: int = 128


@dataclasses.dataclass(frozen=True)
class HostConfig:
    cpu_threads: int = 128             # 2x EPYC 7742
    cpu_watts: float = 450.0
    dram_watts: float = 40.0
    gpu_watts: float = 300.0
    gpu_basecall_samples_per_sec: float = 2.5e6   # Dorado hac on A6000-class
    minimap_ops_per_base: float = 1.2e3
    samples_per_base: float = 9.0


@dataclasses.dataclass(frozen=True)
class HostRates:
    """Inverse rates (seconds per unit) for the host software pipeline.
    Units: io -> bytes ingested, event -> raw samples, seed -> seed
    lookups, chain -> anchors entering chaining.  Fitted by
    benchmarks/common.calibrated_host()."""
    inv_io: float = 1.0 / 150e6        # ~150 MB/s fast5 ingest default
    inv_event: float = 1.0 / 500e6     # samples/s aggregate
    inv_seed: float = 1.0 / 50e6       # probes/s aggregate
    inv_chain: float = 1.0 / 20e6      # anchors/s aggregate


# Per-primitive op counts of OUR pipeline (word-serial AU ops per item;
# from the events/quantization/hashing/vote/chaining op inventories).
OPS = dict(
    ed_per_sample=14, quant_per_event=12, hash_per_seed=13,
    freq_per_hit=2, vote_per_anchor=6, dp_per_pair=10,
)

# Energy constants (J) — 65nm logic + LPDDR4 DRAM, CACTI7-class.
# qu_lookup is dominated by the pLUTo row activations of the sweep
# (amortized ~2 nJ/lookup); au_op includes instruction-buffer control.
ENERGY = dict(
    au_op=5.0e-12, qu_lookup=2.0e-9, sort_elem=10e-12, dram_byte=50e-12,
    flash_byte=150e-12, pcie_byte=120e-12, host_io_byte=900e-12,
)
# In-storage static power: SSD controller + DRAM refresh while mapping.
# (Component-level accounting like the paper's CACTI+DC methodology; host
# idle power is EXCLUDED for in-storage systems — see EXPERIMENTS.md
# Energy-calibration notes for the reconciliation discussion.)
SSD_ACTIVE_W = 8.0

# Area (mm^2) — paper Table 5 (as published; we do not re-synthesize).
AREA = dict(arith_unit=0.0295, n_arith=256, query_unit=0.018, n_query=512,
            sorter=0.78, n_sorter=8, merger=0.14, n_merger=8,
            control=0.002, n_control=1)


def area_table() -> Dict[str, Dict[str, float]]:
    return {
        "Arithmetic": dict(instances=AREA["n_arith"],
                           per_unit=AREA["arith_unit"],
                           total=AREA["n_arith"] * AREA["arith_unit"]),
        "Querying": dict(instances=AREA["n_query"],
                         per_unit=AREA["query_unit"],
                         total=AREA["n_query"] * AREA["query_unit"]),
        "Sorter": dict(instances=AREA["n_sorter"], per_unit=AREA["sorter"],
                       total=AREA["n_sorter"] * AREA["sorter"]),
        "Merger": dict(instances=AREA["n_merger"], per_unit=AREA["merger"],
                       total=AREA["n_merger"] * AREA["merger"]),
        "Control": dict(instances=AREA["n_control"],
                        per_unit=AREA["control"],
                        total=AREA["n_control"] * AREA["control"]),
    }


# --------------------------------------------------------------------------- #
# Host (CPU software) model
# --------------------------------------------------------------------------- #
def host_components(w: Workload) -> Dict[str, float]:
    """Natural units per stage for the host pipeline.  Chaining scales with
    the anchors that actually enter the DP (post-vote when the vote filter
    runs — that is where MS-CPU's speedup over RH2 comes from, Section 8.2)."""
    return dict(io=float(w.bytes_raw + w.bytes_index),
                event=float(w.n_samples),
                seed=float(w.n_lookups),
                chain=float(w.n_anchors_postvote) + 0.3 * float(w.n_votes))


def host_latency(w: Workload, rates: HostRates,
                 arith_scale: float = 1.0) -> Dict[str, float]:
    c = host_components(w)
    t = dict(io=c["io"] * rates.inv_io,
             event=c["event"] * rates.inv_event * arith_scale,
             seed=c["seed"] * rates.inv_seed,
             chain=c["chain"] * rates.inv_chain * arith_scale)
    t["total"] = sum(t.values())
    return t


# --------------------------------------------------------------------------- #
# MARS in-storage model (Table 1 first-principles)
# --------------------------------------------------------------------------- #
def _flash_read_time(nbytes: float, ssd: SSDConfig) -> float:
    per_channel = nbytes / ssd.channels
    return per_channel / ssd.channel_bw + ssd.t_read + ssd.t_dma


def mars_stage_times(w: Workload, ssd: SSDConfig) -> Dict[str, float]:
    au_rate = ssd.n_arith_units * ssd.arith_freq
    arith_scale = 1.0 if w.fixed_point else 2.4    # float emulation penalty
    t_ed = (w.n_samples * OPS["ed_per_sample"] +
            w.n_events * OPS["quant_per_event"]) * arith_scale / au_rate
    t_hash = w.n_seeds * OPS["hash_per_seed"] * arith_scale / au_rate
    qu_rate = ssd.n_query_units / (4 * ssd.dram_trc)
    t_query = w.n_lookups / qu_rate
    t_filters = (w.n_hits_raw * OPS["freq_per_hit"] +
                 w.n_votes * OPS["vote_per_anchor"]) * arith_scale / au_rate
    sort_rate = ssd.n_sorters * ssd.sorter_freq
    t_sort = w.n_sorted / sort_rate
    t_dp = w.n_dp_pairs * OPS["dp_per_pair"] * arith_scale / au_rate
    t_flash = _flash_read_time(w.bytes_raw + w.bytes_index, ssd)
    t_dram = w.bytes_intermediate / ssd.dram_bw
    return dict(flash=t_flash, event_detection=t_ed, seeding=t_hash + t_query,
                seeding_hash=t_hash, seeding_query=t_query,
                filters=t_filters, sorting=t_sort, chaining_dp=t_dp,
                dram_move=t_dram)


def mars_latency(w: Workload, ssd: SSDConfig = SSDConfig()) -> Dict[str, float]:
    st = mars_stage_times(w, ssd)
    compute = (st["event_detection"] + st["seeding"] + st["filters"] +
               st["sorting"] + st["chaining_dp"] + st["dram_move"])
    # Section 6.3: flash/index loading overlapped with computation.
    total = max(st["flash"], compute) + 0.02 * min(st["flash"], compute)
    return dict(total=total, compute=compute, **st)


def mars_energy(w: Workload, ssd: SSDConfig = SSDConfig()) -> float:
    arith_scale = 1.0 if w.fixed_point else 2.4
    au_ops = (w.n_samples * OPS["ed_per_sample"] +
              w.n_events * OPS["quant_per_event"] +
              w.n_seeds * OPS["hash_per_seed"] +
              w.n_hits_raw * OPS["freq_per_hit"] +
              w.n_votes * OPS["vote_per_anchor"] +
              w.n_dp_pairs * OPS["dp_per_pair"]) * arith_scale
    # static power over the run: SSD controller + DRAM refresh
    lat = mars_latency(w, ssd)
    static = SSD_ACTIVE_W * lat["total"]
    return (au_ops * ENERGY["au_op"]
            + w.n_lookups * ENERGY["qu_lookup"]
            + w.n_sorted * ENERGY["sort_elem"] * 7
            + w.bytes_intermediate * ENERGY["dram_byte"]
            + (w.bytes_raw + w.bytes_index) * ENERGY["flash_byte"]
            + static)


# --------------------------------------------------------------------------- #
# Evaluated systems (paper Section 7)
# --------------------------------------------------------------------------- #
SYSTEMS = ("BC", "RH2", "MS-CPU_Float", "MS-CPU_Fixed", "MS-EXT",
           "MS-SIMDRAM", "GenPIP", "MS-SmartSSD", "MARS")


def system_latency_energy(system: str, w: Workload,
                          rates: HostRates = HostRates(),
                          ssd: SSDConfig = SSDConfig(),
                          host: HostConfig = HostConfig()) -> Dict[str, float]:
    """Latency (s) + energy (J).  Pass the workload measured in the MATCHING
    pipeline mode (rh2 workload for RH2/BC, ms_float for MS-CPU_Float,
    ms_fixed for the rest)."""
    io_bytes = w.bytes_raw + w.bytes_index

    if system in ("RH2", "MS-CPU_Float", "MS-CPU_Fixed"):
        scale = {"RH2": 1.0, "MS-CPU_Float": 1.0,
                 "MS-CPU_Fixed": 0.8}[system]     # int16 SIMD density
        t = host_latency(w, rates, arith_scale=scale)
        busy = t["total"] - t["io"]
        e = (busy * (host.cpu_watts + host.dram_watts)
             + t["io"] * (0.4 * host.cpu_watts + host.dram_watts)
             + io_bytes * ENERGY["host_io_byte"])
        return dict(total=t["total"], compute=busy, io=t["io"], energy=e,
                    stages=t)

    if system == "MARS":
        lat = mars_latency(w, ssd)
        e = mars_energy(w, ssd)
        return dict(total=lat["total"], compute=lat["compute"],
                    io=lat["flash"], energy=e,
                    energy_dynamic=e - SSD_ACTIVE_W * lat["total"],
                    stages=lat)

    if system == "MS-EXT":
        # identical units placed OUTSIDE the SSD: raw data crosses PCIe and
        # bounces through host DRAM to the PIM DIMMs; the host CPU
        # orchestrates every partition pass (no in-storage FSM), and the
        # flash<->compute overlap of Section 6.3 is lost.
        lat = mars_latency(w, ssd)
        t_io = io_bytes / ssd.pcie_bw + 2 * io_bytes / 25.6e9
        t_orc = 0.6 * lat["compute"]              # host-driven scheduling
        total = t_io + 1.3 * lat["compute"] + t_orc   # no overlap, sync gaps
        e = (mars_energy(w, ssd)
             + io_bytes * (ENERGY["pcie_byte"] + 2 * ENERGY["dram_byte"])
             + (t_io + t_orc) * 0.5 * host.cpu_watts)
        return dict(total=total, compute=lat["compute"], io=t_io, energy=e)

    if system == "MS-SIMDRAM":
        lat = mars_latency(w, ssd)
        bitserial = 21.4                          # Section 8.2
        t_arith = (lat["event_detection"] + lat["filters"] +
                   lat["chaining_dp"]) * bitserial
        compute = t_arith + lat["seeding"] + lat["sorting"] + lat["dram_move"]
        total = max(lat["flash"], compute)
        # dynamic energy 3.5x lower (bit-serial rows, no ALU logic).
        # NOTE accounting: the paper's Fig. 12 "SIMDRAM beats MARS on
        # energy" holds for DYNAMIC component energy (CACTI-style); with
        # physical static power over the 21.4x longer run it inverts —
        # both are reported (EXPERIMENTS.md Energy notes).
        dyn = (mars_energy(w, ssd) - SSD_ACTIVE_W *
               mars_latency(w, ssd)["total"]) / 3.5
        e = dyn + 2.0 * total
        return dict(total=total, compute=compute, io=lat["flash"], energy=e,
                    energy_dynamic=dyn)

    if system == "MS-SmartSSD":
        lat = mars_latency(w, ssd)
        link_bw = 3.0e9
        t_link = (w.n_sorted * 4 * 2) / link_bw
        t_sort_fpga = lat["sorting"] * (ssd.sorter_freq / 300e6)
        compute = (lat["compute"] - lat["sorting"]) + t_sort_fpga + t_link
        total = max(lat["flash"], compute)
        e = (mars_energy(w, ssd) + (w.n_sorted * 8) * ENERGY["pcie_byte"]
             + t_sort_fpga * 25.0)
        return dict(total=total, compute=compute, io=lat["flash"], energy=e)

    if system == "BC":
        n_bases = w.n_samples / host.samples_per_base
        t_bc = w.n_samples / host.gpu_basecall_samples_per_sec
        t_mm = n_bases * host.minimap_ops_per_base / (
            host.cpu_threads * 2.0e9)
        t_io = io_bytes * rates.inv_io
        total = max(t_bc, t_mm) + t_io
        e = (t_bc * host.gpu_watts
             + t_mm * host.cpu_watts + t_io * 0.4 * host.cpu_watts
             + io_bytes * ENERGY["host_io_byte"])
        return dict(total=total, compute=max(t_bc, t_mm), io=t_io, energy=e)

    if system == "GenPIP":
        # NVM-PIM basecalling+mapping (MICRO'22): the CRF basecaller runs
        # in analog PIM (~8x the GPU's effective rate at ~1/25 the energy),
        # mapping in PIM (~5x CPU); host-side raw streaming remains.
        n_bases = w.n_samples / host.samples_per_base
        t_bc = w.n_samples / (host.gpu_basecall_samples_per_sec * 6.0)
        t_mm = n_bases * host.minimap_ops_per_base / (host.cpu_threads * 2.0e9) / 5.0
        t_io = io_bytes * rates.inv_io            # fast5 ingest like BC
        total = t_bc + t_mm + t_io
        e = ((w.n_samples / host.gpu_basecall_samples_per_sec)
             * host.gpu_watts / 25.0
             + io_bytes * (ENERGY["host_io_byte"] / 2)
             + t_io * 0.2 * host.cpu_watts)
        return dict(total=total, compute=t_bc + t_mm, io=t_io, energy=e)

    raise ValueError(f"unknown system {system!r}")


# --------------------------------------------------------------------------- #
# Multi-SSD array model + serving-latency queueing term
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SSDArrayConfig:
    """An array of N identical MARS SSDs behind one host.

    The reference index is bucket-range-partitioned across the drives with
    the SAME invariants as ``core/index.partition_index``: ``n_ssds`` must
    be a power of two, every drive owns an equal contiguous bucket range
    (1/N of the index bytes), and every seed's bucket lives on exactly ONE
    drive — so reads stripe evenly, each drive runs the full pipeline on
    its share with its own flash-load/compute overlap (Section 6.3), and
    per-drive results merge exactly (the host sums counter partials and
    concatenates per-read outputs, the analytic analogue of the
    ``query:ring`` / ``query:a2a`` hit-combining).

    ``result_bytes_per_read`` is the per-read record crossing PCIe to the
    host (t_start + score + flags); ``t_dispatch`` is the host-side
    orchestration cost per drive per batch (NVMe submission + completion
    handling).

    ``n_failed`` models the degraded array after a single-drive loss
    rebalanced by ``core/index.repartition_index``: the power-of-two
    partitioning folds to N/2 halves (each surviving pair's bucket ranges
    merge), so exactly ``n_serving = n_ssds // 2`` drives serve the whole
    index — every serving drive's share doubles, which is what the
    latency / energy / queueing models charge.
    """
    n_ssds: int = 4
    ssd: SSDConfig = SSDConfig()
    result_bytes_per_read: int = 16
    t_dispatch: float = 20e-6          # s per drive per batch
    n_failed: int = 0                  # 0 healthy, 1 degraded (N -> N/2)

    def __post_init__(self):
        if self.n_ssds < 1 or (self.n_ssds & (self.n_ssds - 1)):
            raise ValueError(f"n_ssds must be a power of two (bucket-range "
                             f"index partitioning); got {self.n_ssds}")
        if self.n_failed not in (0, 1):
            raise ValueError(f"n_failed must be 0 or 1 (repartition_index "
                             f"handles single-drive loss); "
                             f"got {self.n_failed}")
        if self.n_failed and self.n_ssds < 2:
            raise ValueError("a degraded array needs n_ssds >= 2: there is "
                             "no survivor to fold a failed drive onto")

    @property
    def n_serving(self) -> int:
        """Drives actually serving the index: all of them, or the N/2
        halving ``repartition_index`` folds a single-drive loss into."""
        return self.n_ssds if self.n_failed == 0 else self.n_ssds // 2


def mars_array_latency(w: Workload,
                       arr: SSDArrayConfig = SSDArrayConfig()) -> Dict[str, float]:
    """Batch latency of a Workload spread over the array.

    Each drive maps 1/N of the reads against its resident 1/N index
    partition (``Workload.scale`` divides both the read-proportional
    counts and ``bytes_index`` — exactly the bucket-range split), with
    per-SSD flash/compute overlap.  Drives are symmetric, so the array
    compute time is one drive's time; the host adds the result-merge
    transfer over PCIe and the per-drive dispatch overhead.  A degraded
    array (``n_failed``) serves with ``n_serving`` drives, each carrying
    the doubled post-rebalance share.
    """
    per = w.scale(1.0 / arr.n_serving)
    lat = mars_latency(per, arr.ssd)
    t_merge = (w.n_reads * arr.result_bytes_per_read) / arr.ssd.pcie_bw
    t_orch = arr.n_serving * arr.t_dispatch
    total = lat["total"] + t_merge + t_orch
    return dict(total=total, per_ssd=lat["total"], merge=t_merge,
                orchestration=t_orch, compute=lat["compute"],
                flash=lat["flash"])


def mars_array_energy(w: Workload,
                      arr: SSDArrayConfig = SSDArrayConfig()) -> float:
    """Array energy: N drives each running its 1/N share, plus the result
    merge over PCIe.  Dynamic energy is workload-proportional, so the
    per-drive dynamic energies sum back to (almost) the single-drive
    total; static power burns on every drive for the (shorter) array
    runtime — the energy cost of the latency win.  A degraded array
    burns static power only on the ``n_serving`` survivors."""
    per = w.scale(1.0 / arr.n_serving)
    per_dyn = mars_energy(per, arr.ssd) - SSD_ACTIVE_W * mars_latency(
        per, arr.ssd)["total"]
    static = arr.n_serving * SSD_ACTIVE_W * mars_array_latency(w, arr)["total"]
    merge = w.n_reads * arr.result_bytes_per_read * ENERGY["pcie_byte"]
    return arr.n_serving * per_dyn + static + merge


def _erlang_c(c: int, a: float) -> float:
    """Erlang-C waiting probability for an M/M/c queue with offered load
    ``a`` = lambda/mu erlangs (requires a < c).  Computed with the stable
    iterative Erlang-B recursion b = a*b/(k+a*b)."""
    b = 1.0
    for k in range(1, c + 1):
        b = a * b / (k + a * b)
    rho = a / c
    return b / (1.0 - rho + rho * b)


def queueing_percentiles(service: float, c: int, offered_load: float,
                         percentiles: Sequence[float] = (50.0, 99.0)
                         ) -> Dict[str, float]:
    """The shared M/D/c sojourn-percentile core (Poisson arrivals, ``c``
    servers of deterministic ``service`` each, ``offered_load`` requests
    per unit time).

    Mean wait uses the classic M/D/c ~= M/M/c / 2 correction on the
    Erlang-C formula; the waiting-tail is approximated exponential,
    P(W > t) = C(c,a) * exp(-2 (c*mu - lambda) t), which is exact for
    M/M/c up to the factor-2 deterministic-service correction.
    Percentile q of sojourn = service + max(0, ln(C/(1-q)) / (2(c*mu-l))).

    Beyond saturation (rho >= 1) the queue has no steady state: the
    percentiles are inf and ``saturated`` is set — the graceful-overload
    regime the serving driver's admission control (core/server.py) is
    built for.

    Both serving models are thin wrappers: ``serving_latency`` feeds the
    per-drive amortized batch service of the SSD array
    (c = drives); ``serving_latency_virtual`` feeds the serving driver's
    virtual-clock chunk service (c = chunk rows — a batch server of B
    requests per ``chunk_cost`` behaves like B parallel unit-cost
    servers at the same total capacity).
    """
    if not service > 0:
        raise ValueError(f"service time must be > 0; got {service}")
    c = int(c)
    if c < 1:
        raise ValueError(f"n_servers must be >= 1; got {c}")
    if offered_load < 0:
        raise ValueError(f"offered_load must be >= 0 (requests per unit "
                         f"time); got {offered_load}")
    if offered_load == 0:
        raise ValueError("offered_load must be > 0: an idle system has no "
                         "sojourn distribution (every percentile is just "
                         "the service time)")
    mu = 1.0 / service
    a = offered_load / mu
    rho = a / c
    out = dict(service=service, utilization=rho, n_servers=c,
               offered_load=offered_load, saturated=rho >= 1.0)
    if rho >= 1.0:
        out.update(mean=math.inf, wait_prob=1.0,
                   **{f"p{g:g}": math.inf for g in percentiles})
        return out
    pw = _erlang_c(c, a)
    decay = 2.0 * (c * mu - offered_load)       # M/D/c tail correction
    out.update(mean=service + pw / decay, wait_prob=pw)
    for q in percentiles:
        p = q / 100.0
        wait = 0.0 if (1.0 - p) >= pw else math.log(pw / (1.0 - p)) / decay
        out[f"p{q:g}"] = service + wait
    return out


def serving_latency(w: Workload, offered_load: float,
                    arr: SSDArrayConfig = SSDArrayConfig(),
                    percentiles: Sequence[float] = (50.0, 99.0)
                    ) -> Dict[str, float]:
    """Serving-latency percentiles for a stream of read requests at
    ``offered_load`` reads/second against the array — the queueing term
    that turns Workload *rates* into p50/p99 alongside the batch
    latencies.

    Each SERVING SSD is one server of the M/D/c queue
    (``queueing_percentiles``) — a degraded array has fewer, slower-share
    servers; service time is the per-read amortized batch latency of ONE
    drive serving its index partition, incl. the host merge/dispatch
    share.
    """
    # per-read deterministic service time on one drive (its post-rebalance
    # share, amortized over its reads)
    batch = mars_array_latency(w, arr)
    service = batch["total"] / max(w.n_reads, 1) * arr.n_serving
    out = queueing_percentiles(service, arr.n_serving, offered_load,
                               percentiles)
    out["n_ssds"] = out["n_servers"]
    return out


def serving_latency_virtual(chunk: int, offered_load: float,
                            chunk_cost: float = 1.0,
                            percentiles: Sequence[float] = (50.0, 99.0)
                            ) -> Dict[str, float]:
    """The virtual-clock twin of ``serving_latency``: modeled sojourn
    percentiles for ``core/server.ServeDriver`` at ``offered_load`` reads
    per virtual time unit.

    The serving driver is a *batch* server in virtual time — every
    dispatched chunk advances the clock by ``chunk_cost`` and completes up
    to ``chunk`` reads at once.  Two terms the plain M/D/c core misses
    (both calibrated against measured ``ServeDriver.serve_trace``
    latencies in ``benchmarks/calibrate_serving.py``):

      * the chunk a read rides always costs the FULL ``chunk_cost``
        regardless of occupancy (sojourn >= chunk_cost even when idle),
        which c = ``chunk`` parallel unit-cost servers reproduce; and
      * a read arriving while a chunk is in flight waits the *residual*
        of that dispatch before its own chunk starts.  The dispatcher is
        greedy (any queued read triggers a chunk), so its busy fraction B
        follows the gated-cycle renewal e^(l t)/(e^(l t) + 1/(l t))
        services per idle gap; the residual seen by a busy-period arrival
        is Uniform(0, chunk_cost), so percentile p of the boundary wait is
        chunk_cost * max(0, p - (1-B)) / B.

    Sojourn percentile = chunk_cost + boundary wait + M/D/c backlog wait
    (the Erlang term only bites once the backlog exceeds a whole chunk).
    tests/test_ssd_model.py asserts the modeled p50 tracks the measured
    trace percentile below saturation.
    """
    out = queueing_percentiles(chunk_cost, int(chunk), offered_load,
                               percentiles)
    out.update(chunk=int(chunk), chunk_cost=chunk_cost)
    if out["saturated"]:
        return out
    # dispatch-boundary residual: busy fraction of the greedy dispatcher
    lt = offered_load * chunk_cost
    e_busy = math.exp(lt)                     # services per busy period
    busy = (e_busy * chunk_cost) / (e_busy * chunk_cost + 1.0 /
                                    offered_load)
    out["dispatch_busy"] = busy
    out["mean"] += busy * chunk_cost / 2.0
    for q in percentiles:
        p = q / 100.0
        out[f"p{q:g}"] += chunk_cost * max(0.0, p - (1.0 - busy)) / busy
    return out


def dram_size_sensitivity(w: Workload, sizes=(2 << 30, 4 << 30, 8 << 30),
                          ssd: SSDConfig = SSDConfig()) -> Dict[int, float]:
    """Fig. 13: MARS runtime vs SSD-internal DRAM size: more compute-enabled
    subarrays (AUs/QUs scale with DRAM) and fewer index re-streams."""
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
        out[size] = mars_latency(ww, cfg)["total"]
    return out
