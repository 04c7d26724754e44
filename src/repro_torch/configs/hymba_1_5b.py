"""Hymba 1.5B [arXiv:2411.13676; hf] — hybrid heads: attention and Mamba
(SSM) branches run in PARALLEL inside every layer; SWA everywhere except
three full-attention layers (first / middle / last).
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.

Simplifications recorded in DESIGN.md: meta-tokens (128 learned prefix
tokens) and cross-layer KV sharing are omitted — backbone only."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    swa_window=1024,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=10_000.0,
    source="arXiv:2411.13676 (hf: nvidia/Hymba-1.5B-Base)",
)
