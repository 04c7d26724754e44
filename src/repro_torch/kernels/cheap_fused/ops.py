"""Wrapper of the fused cheap-phase kernel (csrc/cheap_fused.cu) + its
registration as the whole-phase cheap backend.

Host graph, as the reference package's wrapper: robust-normalize and
early-quantize the signals in torch (one ``torch.sort`` per row for the
median), launch the kernel once over the (R, S) int32 Q-format block, and
rebuild the cheap-phase (q_pos, t_pos, hit_valid, counters) contract from
its flat output planes.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import kernels as K
from repro_torch.core import events as ev
from repro_torch.core import stages
from repro_torch.core.config import MarsConfig
from repro_torch.kernels.cheap_fused.ref import (COUNTER_COLS,
                                                 cheap_fused_rows_ref)


def cheap_fused_rows(xq: torch.Tensor, bucket_start: torch.Tensor,
                     entries_packed: torch.Tensor, cfg: MarsConfig):
    """xq: (R, S) int32 Q-format samples; bucket_start (2^h + 1,) int32;
    entries_packed (2, N) int32.  Returns (t_pos (R, E*H) int32, keep
    (R, E*H) int32, counters (R, 9) int32 in COUNTER_COLS order)."""
    K.check_tensor("cheap_fused xq", xq, torch.int32, (None, None))
    K.check_tensor("cheap_fused bucket_start", bucket_start, torch.int32,
                   (cfg.n_buckets + 1,))
    K.check_tensor("cheap_fused entries_packed", entries_packed, torch.int32,
                   (2, None))
    if not _fused_supports(cfg):
        raise ValueError("cheap_fused: the kernel implements the fixed-point "
                         "path whose integer boundary test fits int32, "
                         "with min_dwell <= 1")
    if xq.device.type == "cpu":
        return cheap_fused_rows_ref(xq, bucket_start, entries_packed, cfg)
    return _cheap_fused_kernel(xq, bucket_start, entries_packed, cfg)


def _params(cfg: MarsConfig, S: int, n_entries: int):
    from repro_torch.kernels import build
    clip_q = int(round(cfg.quant_clip_sigma * (1 << cfg.frac_bits)))
    return build.CheapParams(
        S=S, E=cfg.max_events, H=cfg.max_hits_per_seed, tw=cfg.tstat_window,
        tau2=int(round(cfg.tstat_threshold ** 2)),
        eps=1 << (2 * cfg.frac_bits - 8), peak_r=cfg.peak_window,
        frac_bits=cfg.frac_bits, seed_w=cfg.seed_width,
        seed_q=cfg.quant_bits, minimizer_r=cfg.minimizer_radius,
        levels=cfg.quant_levels, clip_q=clip_q,
        step_q=(2 * clip_q) // cfg.quant_levels, n_buckets=cfg.n_buckets,
        n_entries=n_entries, thresh_freq=cfg.thresh_freq,
        use_freq=int(cfg.use_freq_filter), use_vote=int(cfg.use_vote_filter),
        vlog2=cfg.voting_window_log2, nbins=cfg.vote_bins,
        thresh_vote=cfg.thresh_voting)


def _cheap_fused_kernel(xq, bucket_start, entries_packed, cfg: MarsConfig):
    from repro_torch.kernels import build
    xq = xq.contiguous()
    K.check_cuda("cheap_fused", xq, bucket_start, entries_packed)
    R, S = xq.shape
    n_entries = entries_packed.shape[1]
    if n_entries == 0:
        raise ValueError("cheap_fused: the index holds no entries")
    p = _params(cfg, S, n_entries)
    EH = cfg.max_events * cfg.max_hits_per_seed
    dev = xq.device
    t_pos = torch.empty((R, EH), dtype=torch.int32, device=dev)
    keep = torch.empty((R, EH), dtype=torch.int32, device=dev)
    cnt = torch.empty((R, len(COUNTER_COLS)), dtype=torch.int32, device=dev)
    if R:
        # a read needing more shared memory than a CTA may take comes back
        # as the launcher's error (cudaFuncSetAttribute refuses the size)
        err = build.lib().cheap_fused_rows(
            xq.data_ptr(), bucket_start.data_ptr(), entries_packed.data_ptr(),
            t_pos.data_ptr(), keep.data_ptr(), cnt.data_ptr(), R, p,
            K.stream_handle(xq))
        build.check(err, "cheap_fused")
        K.LAUNCHES["cheap_fused"] += 1
    return t_pos, keep, cnt


def cheap_fused(signals: torch.Tensor, index: Dict[str, torch.Tensor],
                cfg: MarsConfig):
    """signals: (R, S) f32 raw; index: ``index_arrays`` on the signals'
    device.  Returns (q_pos, t_pos, hit_valid, counters) — the exact
    ``pipeline.cheap_phase`` contract, with (R,) int32 counters."""
    xq = ev.early_quantize(signals, cfg)
    R = xq.shape[0]
    E, H = cfg.max_events, cfg.max_hits_per_seed
    t_pos, keep, cnt = cheap_fused_rows(xq, index["bucket_start"],
                                        index["entries_packed"], cfg)
    t_pos = t_pos.reshape(R, E, H)
    hit_valid = keep.reshape(R, E, H).to(torch.bool)
    counters = {name: cnt[:, i] for i, name in enumerate(COUNTER_COLS)}
    q_pos = torch.arange(E, dtype=torch.int32, device=xq.device)[
        None, :, None].expand(R, E, H)
    return q_pos, t_pos, hit_valid, counters


def _fused_supports(cfg: MarsConfig) -> bool:
    """The fixed-point path, whose integer boundary test fits int32, with
    the peak window alone spacing the boundaries (``min_dwell <= 1``: the
    kernel has no sequential dwell scan)."""
    return (cfg.fixed_point and cfg.early_quantization
            and ev.fixed_tstat_in_range(cfg) and cfg.min_dwell <= 1)


stages.register_fused_cheap(stages.KERNELS, cheap_fused,
                            supports=_fused_supports)
