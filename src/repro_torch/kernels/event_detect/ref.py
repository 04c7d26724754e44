"""Plain PyTorch version of the event-detection kernel: the core pipeline's
own fixed-point detection from the Q-format samples on."""
import torch

from repro_torch.core import events
from repro_torch.core.config import MarsConfig


def event_detect_rows_ref(xq: torch.Tensor, cfg: MarsConfig):
    """xq: (R, S) int32 Q-format samples.  Returns (means (R, E) f32,
    n_events (R,) int32)."""
    means, n_ev, _ = events.detect_quantized(xq, cfg)
    return means, n_ev
