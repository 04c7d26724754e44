"""Llama-3.2 Vision 11B [hf:meta-llama/Llama-3.2-11B-Vision; unverified] —
decoder with cross-attention image layers every 5th layer.  40L
d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

The vision encoder is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (n_ctx_tokens x d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    n_ctx_tokens=1600,      # image patch tokens (stub embeddings)
    rope_theta=500_000.0,
    source="hf: meta-llama/Llama-3.2-11B-Vision",
)
