"""Llama-3.1 405B [arXiv:2407.21783; unverified] — dense GQA, 128k vocab.
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv=8,
    d_head=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
