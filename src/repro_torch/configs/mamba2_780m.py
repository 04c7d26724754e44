"""Mamba-2 780M [arXiv:2405.21060; unverified] — SSD (state-space duality),
attention-free.  48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128,
expand=2 (d_inner=3072), head_dim=64 -> 48 SSD heads, conv width 4."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv=0,
    d_head=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    source="arXiv:2405.21060",
)
