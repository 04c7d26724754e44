"""MARS core in PyTorch: the mapping path in all three modes, and serving.

Public API:
    MarsConfig            static pipeline configuration
    build_index           offline reference indexing (numpy)
    index_from_numpy      an Index over existing planes
    TieredIndex           host-resident bucket-range tiles (tier_index,
                          build_index_streaming), paged by core/tiered.py
    stages                backend registry + plan resolution
    Mapper / map_chunk    online read mapping (CUDA by default)
    map_chunk_sharded     the chunk program over a mesh (launch/mesh.py)
    partition_index       bucket-range partitions for the ring/a2a
                          schedules (repartition_index: drive-loss fold)
    driver                streaming host driver + ProgressLog
    ServeDriver           continuous-batching multi-stream serving driver
    SLOClass              serving class (priority/deadline/shed contract)
    TenantBudget          per-tenant fair-share shed budget (token bucket)
    FaultPlan             seeded storage-fault injection plan
    score_accuracy        P/R/F1 vs. ground truth
    costmodel             unified Workload->cost interface (analytic | sim)
"""
from repro_torch.core import costmodel, driver, stages
from repro_torch.core.config import (DEFAULT, MODE_MS_FIXED, MODE_MS_FLOAT,
                                     MODE_RH2, MODES, MarsConfig)
from repro_torch.core.faults import (FaultPlan, InjectedPrefetchError,
                                     TileReadError, sample_fault_plans)
from repro_torch.core.index import (Index, TieredIndex, build_index,
                                    build_index_streaming, index_arrays,
                                    index_from_numpy, partition_index,
                                    repartition_index, tier_index)
from repro_torch.core.pipeline import (MapOutput, Mapper, map_chunk,
                                       map_chunk_sharded, score_accuracy)
from repro_torch.core.server import (ClassReport, ServeDriver, SLOClass,
                                     StreamReport, TenantBudget, TenantReport)

__all__ = [
    "DEFAULT", "MODES", "MODE_RH2", "MODE_MS_FLOAT", "MODE_MS_FIXED",
    "MarsConfig", "Index", "build_index", "index_arrays", "index_from_numpy",
    "TieredIndex", "tier_index", "build_index_streaming", "partition_index",
    "repartition_index", "MapOutput", "Mapper", "map_chunk",
    "map_chunk_sharded", "driver", "stages", "score_accuracy",
    "costmodel", "ServeDriver", "StreamReport", "SLOClass", "ClassReport",
    "TenantBudget", "TenantReport", "FaultPlan", "TileReadError",
    "InjectedPrefetchError", "sample_fault_plans",
]
