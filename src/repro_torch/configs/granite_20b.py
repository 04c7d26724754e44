"""Granite 20B (code) [arXiv:2405.04324; hf] — llama-arch with MQA (kv=1).
52L d_model=6144 48H d_ff=24576 vocab=49152.

Note: the released granite-20b-code uses GPT-BigCode-style learned absolute
positions; we use RoPE uniformly across the stack (recorded deviation —
the assignment pins layer/width/head/vocab dims, which match exactly)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    rope_theta=10_000.0,
    source="arXiv:2405.04324 (hf: ibm-granite/granite-20b-code-base)",
)
