from repro_torch.kernels.bitonic_sort.ops import (  # noqa: F401
    MAX_BLOCK, sort1d, sort_batch, sort_rows)
