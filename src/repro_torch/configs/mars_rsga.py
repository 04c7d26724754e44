"""The paper's own workload as a selectable config: the MARS RSGA
read-mapping pipeline (distributed: reads over data axes, reference index
sharded over the model axis).  Not an LM — `family="rsga"`; its shapes are
(reads_per_chunk x signal_len) rather than (batch x seq)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mars-rsga",
    family="rsga",
    n_layers=0, d_model=0, n_heads=0, n_kv=0, d_head=0, d_ff=0, vocab=0,
    source="this paper (MARS, Sections 5-6)",
)
