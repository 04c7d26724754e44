from repro_torch.kernels.cheap_fused.ops import (  # noqa: F401
    COUNTER_COLS, cheap_fused, cheap_fused_rows)
