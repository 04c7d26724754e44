"""Architecture configuration schema + input-shape registry.

Every assigned architecture is one `ArchConfig` instance (its own file in
this package).  `reduced()` derives the CPU smoke-test variant (same family
and code paths, tiny dims).  `shapes.py`-style shape specs live here too so
(arch x shape) cells are fully defined in one place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio", "ssm", "rsga")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int                    # query heads (0 for attn-free)
    n_kv: int
    d_head: int
    d_ff: int                       # dense-layer FFN width (0 = no MLP)
    vocab: int

    # attention details
    qk_norm: bool = False
    swa_window: Optional[int] = None        # sliding-window size (None=full)
    global_layers: Tuple[int, ...] = ()     # full-attn layers in a SWA stack
    rope_theta: float = 500_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1              # 2 -> alternate dense/MoE (Llama-4)

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # encoder-decoder (audio) / cross-attention (vlm)
    n_enc_layers: int = 0
    cross_attn_every: int = 0       # every k-th layer cross-attends
    n_ctx_tokens: int = 0           # image patches / encoder frames (stub)

    tie_embeddings: bool = False
    source: str = ""                # provenance note

    # ------------------------------------------------------------------ #
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run the 500k-context decode shape: SSM,
        hybrid, or sliding-window attention stacks."""
        return (self.family in ("ssm", "hybrid")
                or self.swa_window is not None)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4) if self.moe_every == 1 else 4,
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv=min(self.n_kv, 2) if self.n_kv else 0,
            d_head=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=64 if self.d_ff_expert else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            n_enc_layers=2 if self.n_enc_layers else 0,
            cross_attn_every=(2 if self.cross_attn_every else 0),
            n_ctx_tokens=32 if self.n_ctx_tokens else 0,
            swa_window=(64 if self.swa_window is not None else None),
            global_layers=tuple(g for g in self.global_layers if g < 4),
        )
        return r

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    key: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Per assignment rules: long_500k only for sub-quadratic archs."""
    if shape.key == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention)"
    return True, ""
