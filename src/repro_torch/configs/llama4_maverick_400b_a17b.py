"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-*; unverified] — MoE
with 128 routed experts (top-1) + 1 shared expert, MoE layers interleaved
with dense layers.  48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

The early-fusion vision pathway is out of scope for the LM backbone cells
(text-only shapes assigned)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_head=128,
    d_ff=16384,            # dense (non-MoE) interleaved layers
    vocab=202048,
    n_experts=128,
    top_k=1,
    d_ff_expert=8192,
    n_shared_experts=1,
    moe_every=2,           # alternate dense / MoE
    rope_theta=500_000.0,
    source="hf: meta-llama/Llama-4-Maverick-17B-128E (dims per assignment)",
)
