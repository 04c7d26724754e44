"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf] — 128 experts, top-8,
fine-grained experts (d_ff_expert=768), qk-norm.  48L d_model=2048 32H
(GQA kv=4) vocab=151936."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_head=128,
    d_ff=0,                # every layer is MoE (no dense FFN layers)
    vocab=151936,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    n_shared_experts=0,
    moe_every=1,
    rope_theta=1_000_000.0,
    source="hf: Qwen/Qwen3-30B-A3B",
)
