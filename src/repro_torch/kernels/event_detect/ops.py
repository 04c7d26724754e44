"""Wrapper of the fixed-point event-detection kernel (csrc/event_detect.cu)
+ its registration as the ``detect`` stage's kernel backend.

Host graph, as the reference package's wrapper: robust-normalize and
early-quantize the signals in torch, then launch the kernel once over the
(R, S) int32 Q-format block.  The ``supports`` gate admits the fixed-point
path whose integer boundary test fits int32; every other config resolves
``detect`` to the reference (core/stages.py).
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.core import events as ev
from repro_torch.core import stages
from repro_torch.core.config import MarsConfig
from repro_torch.kernels.event_detect.ref import event_detect_rows_ref


def event_detect_rows(xq: torch.Tensor, cfg: MarsConfig):
    """xq: (R, S) int32 Q-format samples.  Returns (means (R, E) f32 in
    normalized units, n_events (R,) int32)."""
    K.check_tensor("event_detect xq", xq, torch.int32, (None, None))
    if not _detect_supports(cfg):
        raise ValueError("event_detect: the kernel implements the "
                         "fixed-point path whose integer boundary test "
                         "fits int32, with min_dwell <= 1")
    if xq.device.type == "cpu":
        return event_detect_rows_ref(xq, cfg)
    return _event_detect_kernel(xq, cfg)


def _event_detect_kernel(xq: torch.Tensor, cfg: MarsConfig):
    from repro_torch.kernels import build
    xq = xq.contiguous()
    K.check_cuda("event_detect", xq)
    R, S = xq.shape
    E = cfg.max_events
    means = torch.empty((R, E), dtype=torch.float32, device=xq.device)
    n_ev = torch.empty((R,), dtype=torch.int32, device=xq.device)
    if R:
        err = build.lib().event_detect_rows(
            xq.data_ptr(), means.data_ptr(), n_ev.data_ptr(), R, S, E,
            cfg.tstat_window, int(round(cfg.tstat_threshold ** 2)),
            1 << (2 * cfg.frac_bits - 8), cfg.peak_window, cfg.frac_bits,
            K.stream_handle(xq))
        build.check(err, "event_detect")
        K.LAUNCHES["event_detect"] += 1
    return means, n_ev


def event_detect(signals: torch.Tensor, cfg: MarsConfig):
    """signals: (R, S) f32 raw.  Returns (means (R, E) f32, n_events (R,)
    int32), the ``detect`` stage's batch primitive."""
    return event_detect_rows(ev.early_quantize(signals, cfg), cfg)


def _detect_supports(cfg: MarsConfig) -> bool:
    """The fixed-point path, whose integer boundary test fits int32, with
    the peak window alone spacing the boundaries (``min_dwell <= 1``: the
    kernel has no sequential dwell scan)."""
    return (cfg.fixed_point and cfg.early_quantization
            and ev.fixed_tstat_in_range(cfg) and cfg.min_dwell <= 1)


stages.register_backend("detect", stages.KERNELS, primitive=event_detect,
                        supports=_detect_supports)
