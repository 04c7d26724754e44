"""The unified Workload->cost interface over both performance backends.

Every consumer of the performance model — the Fig. 11/12/13 benchmarks,
``benchmarks/calibrate_serving.py``, ``launch/serve_rsga.py`` and the
serving driver's closed-loop shed controller — goes through ONE
``CostModel`` protocol with two registered implementations:

  * ``analytic`` — the closed forms of ``core/ssd_model.py`` (kept as
    the calibration oracle: Table-1 first-principles rates + the
    M/D/c queueing core);
  * ``sim``      — the discrete-event machine of ``core/sim/`` (flash
    channels x dies, controller-sequenced PNM units, internal-DRAM and
    host links), which must agree with the analytic forms to <1% on
    degenerate no-contention configs and adds the per-component
    busy/idle/queue-delay breakdown under contention.

Host-side baseline systems (RH2 / BC / MS-CPU / GenPIP ...) are modeled
by the analytic host formulas under EITHER backend — only the MARS
in-storage path has an event-driven twin; ``system_latency_energy``
routes exactly that path through the selected model.

The shed controller's overload signal also lives here
(``shed_signal``): offered-load saturation from the queueing model OR a
measured-queue-delay trip (recent per-read dispatch delays exceeding
``delay_limit`` chunk services) — the second term catches effective-
capacity loss (e.g. storage-path retry/backoff stretching the virtual
clock) that offered load alone cannot see.

The JAX package's ``repro.core.costmodel``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

from repro_torch.core import ssd_model
from repro_torch.core.workload import Workload

# Measured-queue-delay trip point: shed when the recent mean per-read
# queue delay exceeds this many chunk services (a healthy driver below
# saturation keeps the mean delay near one chunk_cost).
SHED_DELAY_LIMIT = 4.0


def _delay_tripped(queue_delays: Sequence[float], chunk_cost: float,
                   delay_limit: float) -> bool:
    if not queue_delays:
        return False
    mean = sum(queue_delays) / len(queue_delays)
    return mean > delay_limit * max(chunk_cost, 1e-12)


def skew_factors(traffic: Sequence[float], replicas: int = 0,
                 copies: int = 2) -> tuple:
    """Query-lane load-imbalance factors from a per-tile probe histogram
    (``HotTileCache.tile_traffic()``).

    Tiles stripe 1:1 over query lanes, so the hottest tile sets the pace:
    ``factor = n_tiles * max_i p_i`` where ``p_i`` is tile i's probe
    share — 1.0 for uniform traffic, ``n_tiles`` when every probe lands
    on one tile.  Replicating the top-``replicas`` tiles (same
    traffic-then-tile-id order as ``HotTileCache._refresh_replicas``)
    serves each from ``copies`` lanes, dividing its load.  Returns
    ``(factor, factor_replicated)``, both floored at the uniform 1.0.
    """
    if replicas < 0:
        raise ValueError(f"replicas must be >= 0; got {replicas}")
    if copies < 1:
        raise ValueError(f"copies must be >= 1; got {copies}")
    t = [max(0.0, float(x)) for x in traffic]
    total = sum(t)
    n = len(t)
    if n == 0 or total <= 0:
        return 1.0, 1.0
    top = set(sorted(range(n), key=lambda i: (-t[i], i))[:int(replicas)])
    factor = max(1.0, n * max(t) / total)
    eff = max(t[i] / (copies if i in top else 1) for i in range(n))
    factor_repl = max(1.0, n * eff / total)
    return factor, factor_repl


class CostModel:
    """The Workload->cost protocol both backends implement."""

    name: str = "base"

    # ---- batch latency / energy ------------------------------------- #
    def latency(self, w: Workload,
                ssd: ssd_model.SSDConfig = ssd_model.SSDConfig()) -> Dict:
        raise NotImplementedError

    def energy(self, w: Workload,
               ssd: ssd_model.SSDConfig = ssd_model.SSDConfig()) -> float:
        raise NotImplementedError

    # ---- multi-SSD array -------------------------------------------- #
    def array_latency(self, w: Workload,
                      arr: ssd_model.SSDArrayConfig = ssd_model.SSDArrayConfig()
                      ) -> Dict:
        raise NotImplementedError

    def array_energy(self, w: Workload,
                     arr: ssd_model.SSDArrayConfig = ssd_model.SSDArrayConfig()
                     ) -> float:
        raise NotImplementedError

    # ---- serving queues --------------------------------------------- #
    def serving(self, w: Workload, offered_load: float,
                arr: ssd_model.SSDArrayConfig = ssd_model.SSDArrayConfig(),
                percentiles: Sequence[float] = (50.0, 99.0)) -> Dict:
        raise NotImplementedError

    def serving_virtual(self, chunk: int, offered_load: float,
                        chunk_cost: float = 1.0,
                        percentiles: Sequence[float] = (50.0, 99.0)) -> Dict:
        raise NotImplementedError

    # ---- sensitivity + full system table ---------------------------- #
    def dram_sensitivity(self, w: Workload,
                         sizes=(2 << 30, 4 << 30, 8 << 30),
                         ssd: ssd_model.SSDConfig = ssd_model.SSDConfig()
                         ) -> Dict[int, float]:
        raise NotImplementedError

    def system_latency_energy(self, system: str, w: Workload,
                              rates: ssd_model.HostRates = ssd_model.HostRates(),
                              ssd: ssd_model.SSDConfig = ssd_model.SSDConfig(),
                              host: ssd_model.HostConfig = ssd_model.HostConfig()
                              ) -> Dict:
        """Latency + energy for any evaluated system.  The MARS in-storage
        path routes through this model's ``latency``/``energy``; the
        host-side baselines keep the analytic host formulas (they have no
        event-driven twin)."""
        if system != "MARS":
            return ssd_model.system_latency_energy(system, w, rates, ssd,
                                                   host)
        lat = self.latency(w, ssd)
        e = self.energy(w, ssd)
        return dict(total=lat["total"], compute=lat["compute"],
                    io=lat["flash"], energy=e,
                    energy_dynamic=e - ssd_model.SSD_ACTIVE_W * lat["total"],
                    stages=lat)

    # ---- skewed traffic + hot-tile replication ----------------------- #
    def skewed_serving(self, w: Workload, traffic: Sequence[float],
                       replicas: int = 0, copies: int = 2,
                       ssd: ssd_model.SSDConfig = ssd_model.SSDConfig()
                       ) -> Dict:
        """Price hot-bucket skew and the replication win: stretch the
        query stage by the load-imbalance ``skew_factors`` of ``traffic``
        (a per-tile probe histogram, e.g. ``HotTileCache.tile_traffic()``)
        and re-price the batch with the top-``replicas`` tiles served
        from ``copies`` lanes.  Returns the factors, the skewed and
        replicated totals, and ``replication_speedup`` (>= 1; exactly 1
        on uniform traffic, where both totals equal ``latency(w)``)."""
        raise NotImplementedError

    # ---- the shed controller's overload signal ----------------------- #
    def shed_signal(self, chunk: int, chunk_cost: float, offered_load: float,
                    queue_delays: Sequence[float] = (),
                    delay_limit: float = SHED_DELAY_LIMIT) -> bool:
        """True when the serving driver should shed: the queueing model
        reports no steady state at the trailing offered load, OR the
        measured recent queue delays trip ``delay_limit`` chunk
        services."""
        raise NotImplementedError


class AnalyticModel(CostModel):
    """The closed forms of ``core/ssd_model.py``."""

    name = "analytic"

    def latency(self, w, ssd=ssd_model.SSDConfig()):
        return ssd_model.mars_latency(w, ssd)

    def energy(self, w, ssd=ssd_model.SSDConfig()):
        return ssd_model.mars_energy(w, ssd)

    def array_latency(self, w, arr=ssd_model.SSDArrayConfig()):
        return ssd_model.mars_array_latency(w, arr)

    def array_energy(self, w, arr=ssd_model.SSDArrayConfig()):
        return ssd_model.mars_array_energy(w, arr)

    def serving(self, w, offered_load, arr=ssd_model.SSDArrayConfig(),
                percentiles=(50.0, 99.0)):
        return ssd_model.serving_latency(w, offered_load, arr, percentiles)

    def serving_virtual(self, chunk, offered_load, chunk_cost=1.0,
                        percentiles=(50.0, 99.0)):
        return ssd_model.serving_latency_virtual(chunk, offered_load,
                                                 chunk_cost, percentiles)

    def dram_sensitivity(self, w, sizes=(2 << 30, 4 << 30, 8 << 30),
                         ssd=ssd_model.SSDConfig()):
        return ssd_model.dram_size_sensitivity(w, sizes, ssd)

    def skewed_serving(self, w, traffic, replicas=0, copies=2,
                       ssd=ssd_model.SSDConfig()):
        f, fr = skew_factors(traffic, replicas, copies)
        st = ssd_model.mars_stage_times(w, ssd)
        compute = (st["event_detection"] + st["seeding"] + st["filters"] +
                   st["sorting"] + st["chaining_dp"] + st["dram_move"])
        q = st["seeding_query"]

        def law(c):
            # the Section 6.3 overlap law of mars_latency
            return max(st["flash"], c) + 0.02 * min(st["flash"], c)

        total = law(compute + q * (f - 1.0))
        total_repl = law(compute + q * (fr - 1.0))
        return dict(factor=f, factor_replicated=fr, total=total,
                    total_replicated=total_repl, query=q * f,
                    query_replicated=q * fr,
                    replication_speedup=total / total_repl,
                    n_tiles=len(traffic), replicas=int(replicas))

    def shed_signal(self, chunk, chunk_cost, offered_load, queue_delays=(),
                    delay_limit=SHED_DELAY_LIMIT):
        if offered_load > 0 and ssd_model.serving_latency_virtual(
                chunk, offered_load, chunk_cost)["saturated"]:
            return True
        return _delay_tripped(queue_delays, chunk_cost, delay_limit)


class SimModel(CostModel):
    """The discrete-event machine of ``core/sim/``.

    Energy keeps the analytic DYNAMIC component energies (they are
    per-op constants, not timing) and charges static power over the
    SIMULATED runtime — identical accounting, simulated clock.
    """

    name = "sim"

    def __init__(self, n_stripes: Optional[int] = None, seed: int = 0):
        from repro_torch.core.sim import ssdsim
        self.n_stripes = int(n_stripes or ssdsim.N_STRIPES)
        self.seed = int(seed)

    def latency(self, w, ssd=ssd_model.SSDConfig()):
        from repro_torch.core.sim import ssdsim
        return ssdsim.simulate_batch(w, ssd, n_stripes=self.n_stripes)

    def energy(self, w, ssd=ssd_model.SSDConfig()):
        dyn = (ssd_model.mars_energy(w, ssd) - ssd_model.SSD_ACTIVE_W
               * ssd_model.mars_latency(w, ssd)["total"])
        return dyn + ssd_model.SSD_ACTIVE_W * self.latency(w, ssd)["total"]

    def array_latency(self, w, arr=ssd_model.SSDArrayConfig()):
        from repro_torch.core.sim import ssdsim
        return ssdsim.simulate_array_latency(w, arr,
                                             n_stripes=self.n_stripes)

    def array_energy(self, w, arr=ssd_model.SSDArrayConfig()):
        per = w.scale(1.0 / arr.n_serving)
        per_dyn = (ssd_model.mars_energy(per, arr.ssd)
                   - ssd_model.SSD_ACTIVE_W
                   * ssd_model.mars_latency(per, arr.ssd)["total"])
        static = (arr.n_serving * ssd_model.SSD_ACTIVE_W
                  * self.array_latency(w, arr)["total"])
        merge = (w.n_reads * arr.result_bytes_per_read
                 * ssd_model.ENERGY["pcie_byte"])
        return arr.n_serving * per_dyn + static + merge

    def serving(self, w, offered_load, arr=ssd_model.SSDArrayConfig(),
                percentiles=(50.0, 99.0)):
        from repro_torch.core.sim import serve_sim
        return serve_sim.simulate_serving(w, offered_load, arr, percentiles,
                                          seed=self.seed)

    def serving_virtual(self, chunk, offered_load, chunk_cost=1.0,
                        percentiles=(50.0, 99.0)):
        from repro_torch.core.sim import serve_sim
        return serve_sim.simulate_serving_virtual(chunk, offered_load,
                                                  chunk_cost, percentiles,
                                                  seed=self.seed)

    def dram_sensitivity(self, w, sizes=(2 << 30, 4 << 30, 8 << 30),
                         ssd=ssd_model.SSDConfig()):
        from repro_torch.core.sim import ssdsim
        return ssdsim.simulate_dram_sensitivity(w, sizes, ssd,
                                                n_stripes=self.n_stripes)

    def skewed_serving(self, w, traffic, replicas=0, copies=2,
                       ssd=ssd_model.SSDConfig()):
        from repro_torch.core.sim import ssdsim
        f, fr = skew_factors(traffic, replicas, copies)
        skewed = ssdsim.simulate_batch(w, ssd, n_stripes=self.n_stripes,
                                       query_scale=f)
        repl = ssdsim.simulate_batch(w, ssd, n_stripes=self.n_stripes,
                                     query_scale=fr)
        return dict(factor=f, factor_replicated=fr, total=skewed["total"],
                    total_replicated=repl["total"],
                    query=skewed["seeding_query"],
                    query_replicated=repl["seeding_query"],
                    replication_speedup=skewed["total"] / repl["total"],
                    n_tiles=len(traffic), replicas=int(replicas))

    def shed_signal(self, chunk, chunk_cost, offered_load, queue_delays=(),
                    delay_limit=SHED_DELAY_LIMIT):
        # per-admission calls must stay cheap: the saturation term is the
        # batch server's stability bound (rho >= 1), not a full DES run
        rho = offered_load * chunk_cost / max(int(chunk), 1)
        if rho >= 1.0:
            return True
        return _delay_tripped(queue_delays, chunk_cost, delay_limit)


MODELS = {"analytic": AnalyticModel, "sim": SimModel}


def get_model(model: Union[str, CostModel, None]) -> CostModel:
    """Resolve a model name (or pass a CostModel through).  ``None``
    means the default analytic backend."""
    if model is None:
        return AnalyticModel()
    if isinstance(model, CostModel):
        return model
    try:
        return MODELS[model]()
    except KeyError:
        raise ValueError(f"unknown cost model {model!r}; "
                         f"registered: {sorted(MODELS)}") from None
