"""Plain PyTorch version of the clipping gathers (1-D tables and (W, N)
packed rows): the query's own gather, ``table[..., clip(idx, 0, N-1)]``."""
from repro_torch.core.seeding import _take_clip as lookup_ref  # noqa: F401
