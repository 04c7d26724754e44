"""Architecture registry: one module per assigned architecture."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES,
                                      SHAPE_ORDER, cell_applicable)

from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.llama3_405b import CONFIG as _llama3
from repro_torch.configs.granite_20b import CONFIG as _granite
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.llama32_vision_11b import CONFIG as _llamav
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.mars_rsga import CONFIG as _mars

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in (
    _danube, _llama3, _granite, _qwen3, _hymba, _llama4, _qwen3moe,
    _llamav, _whisper, _mamba2,
)}

# the paper's own pipeline is selectable but not part of the 40 LM cells
EXTRA_ARCHS: Dict[str, ArchConfig] = {_mars.name: _mars}


def get_config(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in EXTRA_ARCHS:
        return EXTRA_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def list_archs() -> List[str]:
    return list(ARCHS)


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "SHAPE_ORDER", "ARCHS",
           "EXTRA_ARCHS", "get_config", "list_archs", "cell_applicable"]
