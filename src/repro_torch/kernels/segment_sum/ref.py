"""Plain PyTorch version of the in-order segment sum: the float event
detection's own reference math, which adds one sample per row at a time so
each row's sums add in sample order."""
from repro_torch.core.events import segment_sum_in_order as segment_sum_ref

__all__ = ["segment_sum_ref"]
