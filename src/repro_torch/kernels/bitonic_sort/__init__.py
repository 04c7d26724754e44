from repro_torch.kernels.bitonic_sort.ops import MAX_BLOCK, sort_rows  # noqa: F401
