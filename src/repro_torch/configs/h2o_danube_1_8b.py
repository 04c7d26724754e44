"""H2O-Danube 1.8B [arXiv:2401.16818; hf] — llama+mistral mix with
sliding-window attention.  24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_head=80,
    d_ff=6912,
    vocab=32000,
    swa_window=4096,
    rope_theta=10_000.0,
    source="arXiv:2401.16818 (hf: h2oai/h2o-danube-1.8b)",
)
