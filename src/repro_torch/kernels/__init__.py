"""Hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

Each kernel package has:
    ops.py  — the wrapper: checks device/dtype/shape/contiguity, allocates
              the outputs, launches the kernel on the current stream and
              counts the launch; a tensor on the CPU takes the plain version
    ref.py  — the plain PyTorch version of the same function

The CUDA sources live in ``repro_torch/csrc/`` and are compiled at first
use by ``kernels/build.py`` (nvcc -> one shared library with a plain C
interface, loaded with ctypes).  ``LAUNCHES`` counts every kernel launch
by name; ``reset_launches`` zeroes it.
"""
from typing import Dict, Sequence

import torch

LAUNCHES: Dict[str, int] = {"cheap_fused": 0, "bitonic_sort": 0,
                            "chain_dp": 0, "event_detect": 0,
                            "pluto_lookup": 0, "pluto_lookup_rows": 0,
                            "segment_sum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype,
                 shape: Sequence) -> None:
    """Raise unless ``x`` has ``dtype`` and ``shape`` (None = any extent)."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.ndim != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, x.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def check_cuda(name: str, *xs: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    dev = xs[0].device
    for x in xs:
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device; "
                             f"got {[str(t.device) for t in xs]}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream_handle(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s device, as the raw handle the C
    launchers take."""
    return torch.cuda.current_stream(x.device).cuda_stream
