"""Plain PyTorch version of the bitonic row sort."""
import torch


def sort_rows_ref(keys: torch.Tensor) -> torch.Tensor:
    """keys: (N, L) int32 -> each row sorted ascending."""
    return torch.sort(keys, dim=-1).values


def sort_ref(keys: torch.Tensor) -> torch.Tensor:
    """The reference package's oracle: ``keys`` sorted ascending along its
    last axis."""
    return torch.sort(keys, dim=-1).values
