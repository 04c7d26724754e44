"""Qwen3 4B [hf:Qwen/Qwen3-8B family; hf] — qk-norm, GQA.
36L d_model=2560 32H (GQA kv=8, head_dim 128) d_ff=9728 vocab=151936."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_head=128,          # head_dim decoupled from d_model/n_heads (Qwen3)
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf: Qwen/Qwen3-4B",
)
