"""Deterministic fault injection for the storage path.

MARS's in-storage pipeline assumes the storage subsystem behaves; real SSD
arrays lose channels and whole drives, return corrupted pages, and stall
under load (the degraded-array regimes GenStore and MegIS design for
explicitly).  This module is the seeded fault harness the reproduction's
storage path — the host-resident tiled index and its hot-tile device cache
(core/tiered.py) — is exercised against:

  * ``FaultPlan`` is an immutable, fully seeded description of which
    faults fire where.  Every decision is a *keyed* draw — a fresh
    ``np.random.Generator`` seeded by ``(plan.seed, site, tile, attempt)``
    — so a plan is deterministic regardless of call order, cache policy or
    chunk schedule: the same plan over the same inputs reproduces the same
    faults, which is what makes a failing sweep entry replayable from its
    seed alone.
  * ``FaultInjector`` applies a plan at the tile page-in boundary
    (``HotTileCache._fetch_tile``): transient read failures (raises
    ``TransientTileError`` — retried), payload corruption (a deterministic
    bit flip on a *copy* of the paged planes — caught by the per-tile
    CRC32 and retried), transient latency spikes (virtual-time accounted),
    sticky-corrupt tiles (corrupt on every attempt, so retries exhaust and
    ``TileReadError`` surfaces loudly), and prefetch-hook exceptions.
  * drive loss for partitioned plans is described, not injected: a plan's
    ``failed_drive`` names the rank whose bucket range must be folded onto
    the survivors via ``core/index.repartition_index`` — the sweep driver
    (scripts/fault_sweep.py, launch/serve_rsga.py --fault-plan) wires it.

The happy path is untouched when no plan is attached (``HotTileCache``
only consults an injector when one exists), and a plan that injects
nothing is byte-identical to no harness at all — the bit-parity oracle of
tests/test_faults.py.

The JAX package's ``repro.core.faults``, copied (python and numpy only): the
same f64 expressions in the same order and the same seeded draws,
so every number equals the reference's to the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


class TileReadError(RuntimeError):
    """A tile page-in failed for good: every attempt (1 + max_retries) was
    lost to a read failure or a checksum mismatch.  Raised by
    ``HotTileCache._fetch_tile`` so a corrupted tile can NEVER silently
    contribute wrong hits — the no-silent-wrong-answers contract."""


class TransientTileError(TileReadError):
    """One injected tile-read failure (a lost flash page / channel hiccup).
    Internal to the retry loop: the cache backs off and re-reads; only an
    exhausted retry budget escalates to ``TileReadError``."""


class InjectedPrefetchError(RuntimeError):
    """An injected failure of the driver loop's prefetch hook (the
    read-ahead tile staging of ``driver.stream_map(prefetch=...)``)."""


# Keyed-draw site tags (the `site` component of the RNG key).  Distinct
# per fault type so e.g. a read-failure draw never correlates with the
# corruption draw at the same (tile, attempt).
_SITE_READ = 1
_SITE_CORRUPT = 2
_SITE_LATENCY = 3
_SITE_FLIP = 4
_SITE_PREFETCH = 5


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded storage-fault scenario.

    Probabilities are per (tile, attempt) page-in draw; sets are exact.
    ``failed_drive`` marks a partitioned-index drive loss for the
    rebalancing path (``core/index.repartition_index``) — it does not
    affect tile paging.  ``prefetch_error_serials`` are 0-based prefetch
    invocation counts at which the prefetch hook raises
    ``InjectedPrefetchError`` (the ``driver.stream_map`` regression).
    """
    seed: int = 0
    p_read_error: float = 0.0          # transient page-in failure
    p_corrupt: float = 0.0             # transient payload corruption
    p_latency: float = 0.0             # transient latency spike
    latency_units: float = 4.0         # virtual time added per spike
    sticky_corrupt_tiles: frozenset = frozenset()   # never heal -> raise
    failed_drive: Optional[int] = None              # partitioned plans
    prefetch_error_serials: frozenset = frozenset()

    def __post_init__(self):
        for name in ("p_read_error", "p_corrupt", "p_latency"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability in [0, 1]; "
                                 f"got {p}")
        if self.latency_units < 0:
            raise ValueError(f"latency_units must be >= 0; "
                             f"got {self.latency_units}")
        # frozenset-ify so hand-written plans with lists/tuples still hash
        object.__setattr__(self, "sticky_corrupt_tiles",
                           frozenset(int(t) for t in
                                     self.sticky_corrupt_tiles))
        object.__setattr__(self, "prefetch_error_serials",
                           frozenset(int(s) for s in
                                     self.prefetch_error_serials))

    @property
    def enabled(self) -> bool:
        """Whether this plan can inject ANYTHING at the tile-paging
        boundary.  A disabled plan is never consulted — the cache drops
        the injector entirely, so attaching it is byte-identical to no
        harness at all (the zero-fault parity oracle)."""
        return bool(self.p_read_error or self.p_corrupt or self.p_latency
                    or self.sticky_corrupt_tiles
                    or self.prefetch_error_serials)


def _draw(plan: FaultPlan, site: int, *key: int) -> np.random.Generator:
    """A fresh generator keyed by (plan.seed, site, *key) — deterministic
    for the key regardless of global RNG state or call order."""
    return np.random.default_rng(
        (np.uint64(plan.seed & 0xFFFFFFFF), np.uint64(site))
        + tuple(np.uint64(k & 0xFFFFFFFFFFFFFFFF) for k in key))


class FaultInjector:
    """Applies a ``FaultPlan`` at the storage-path hook points.

    Stateless apart from the plan (every decision is a keyed draw), so one
    injector can be shared by a cache and its prefetch path.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    # ------------------------------------------------------------- paging
    def tile_read(self, tile: int, attempt: int,
                  bstart: np.ndarray, ent: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
        """One tile page-in attempt.  Returns (bstart, ent, latency_units)
        — possibly corrupted COPIES (the host index is never mutated) —
        or raises ``TransientTileError`` for an injected read failure.
        """
        p = self.plan
        lat = 0.0
        if p.p_latency and _draw(p, _SITE_LATENCY, tile,
                                 attempt).random() < p.p_latency:
            lat = p.latency_units
        if p.p_read_error and _draw(p, _SITE_READ, tile,
                                    attempt).random() < p.p_read_error:
            raise TransientTileError(
                f"injected read failure: tile {tile}, attempt {attempt} "
                f"(plan seed {p.seed})")
        corrupt = tile in p.sticky_corrupt_tiles
        if not corrupt and p.p_corrupt:
            corrupt = _draw(p, _SITE_CORRUPT, tile,
                            attempt).random() < p.p_corrupt
        if corrupt:
            ent = self._flip_bit(ent, tile, attempt)
        return bstart, ent, lat

    def _flip_bit(self, ent: np.ndarray, tile: int,
                  attempt: int) -> np.ndarray:
        """Flip one deterministic bit in a COPY of the entry plane.  CRC32
        detects every single-bit error, so an injected corruption is
        always caught at verify time — healed by a clean re-read or, for a
        sticky tile, escalated to ``TileReadError``; never silent."""
        ent = np.array(ent, copy=True)
        rng = _draw(self.plan, _SITE_FLIP, tile, attempt)
        pos = int(rng.integers(ent.size))
        bit = int(rng.integers(31))
        flat = ent.reshape(-1)
        flat[pos] = np.int32(np.uint32(flat[pos]) ^ np.uint32(1 << bit))
        return ent

    # ----------------------------------------------------------- prefetch
    def check_prefetch(self, serial: int) -> None:
        """Raise ``InjectedPrefetchError`` when the plan marks this
        prefetch invocation (0-based count) as failing."""
        if serial in self.plan.prefetch_error_serials:
            raise InjectedPrefetchError(
                f"injected prefetch failure at prefetch serial {serial} "
                f"(plan seed {self.plan.seed})")


def sample_fault_plans(n: int, seed: int = 0, n_tiles: int = 8,
                       n_drives: int = 4) -> Tuple[FaultPlan, ...]:
    """A deterministic sweep of ``n`` mixed fault plans derived from ONE
    seed — the reproducible grid tests/test_faults.py and
    scripts/fault_sweep.py assert the no-silent-wrong-answers contract
    over.  Covers transient read errors, transient + sticky corruption,
    latency spikes, prefetch failures and drive loss, alone and combined.
    """
    if n < 1:
        raise ValueError(f"need n >= 1 plans; got {n}")
    rng = np.random.default_rng((np.uint64(seed), np.uint64(0xFA017)))
    plans = []
    for i in range(n):
        kind = i % 5
        p = dict(seed=int(rng.integers(1 << 31)))
        if kind == 0:                       # transient read errors
            p["p_read_error"] = float(rng.uniform(0.05, 0.5))
        elif kind == 1:                     # transient corruption
            p["p_corrupt"] = float(rng.uniform(0.05, 0.5))
        elif kind == 2:                     # sticky corruption (must raise)
            p["sticky_corrupt_tiles"] = frozenset(
                {int(rng.integers(n_tiles))})
        elif kind == 3:                     # latency + mixed transients
            p["p_latency"] = float(rng.uniform(0.1, 0.8))
            p["p_read_error"] = float(rng.uniform(0.0, 0.3))
            p["p_corrupt"] = float(rng.uniform(0.0, 0.3))
        else:                               # drive loss + light corruption
            p["failed_drive"] = int(rng.integers(n_drives))
            p["p_corrupt"] = float(rng.uniform(0.0, 0.2))
        plans.append(FaultPlan(**p))
    return tuple(plans)
