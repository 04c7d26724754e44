"""Whisper medium [arXiv:2212.04356; unverified] — encoder-decoder; the
conv frontend is a STUB (input_specs() provides precomputed frame
embeddings).  24L enc + 24L dec, d_model=1024 16H (kv=16 -> MHA) d_ff=4096
vocab=51865."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    n_ctx_tokens=1500,      # encoder frames (30 s / 20 ms hop, stub)
    rope_theta=10_000.0,    # (whisper uses sinusoidal; rope noted deviation)
    source="arXiv:2212.04356",
)
