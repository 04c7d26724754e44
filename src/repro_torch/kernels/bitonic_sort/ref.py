"""Plain PyTorch version of the bitonic row sort."""
import torch


def sort_rows_ref(keys: torch.Tensor) -> torch.Tensor:
    """keys: (N, L) int32 -> each row sorted ascending."""
    return torch.sort(keys, dim=-1).values
