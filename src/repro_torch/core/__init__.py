"""MARS core in PyTorch: the mapping path in all three modes.

Public API:
    MarsConfig            static pipeline configuration
    build_index           offline reference indexing (numpy)
    index_from_numpy      an Index over existing planes
    stages                backend registry + plan resolution
    Mapper / map_chunk    online read mapping (CUDA by default)
    driver                streaming host driver + ProgressLog
    score_accuracy        P/R/F1 vs. ground truth
"""
from repro_torch.core import driver, stages
from repro_torch.core.config import (DEFAULT, MODE_MS_FIXED, MODE_MS_FLOAT,
                                     MODE_RH2, MODES, MarsConfig)
from repro_torch.core.index import (Index, build_index, index_arrays,
                                    index_from_numpy)
from repro_torch.core.pipeline import (MapOutput, Mapper, map_chunk,
                                       score_accuracy)

__all__ = [
    "DEFAULT", "MODES", "MODE_RH2", "MODE_MS_FLOAT", "MODE_MS_FIXED",
    "MarsConfig", "Index", "build_index", "index_arrays", "index_from_numpy",
    "MapOutput", "Mapper", "map_chunk", "driver", "stages", "score_accuracy",
]
