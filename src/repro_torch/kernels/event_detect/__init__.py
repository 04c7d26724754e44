from repro_torch.kernels.event_detect.ops import (  # noqa: F401
    event_detect, event_detect_rows)
