"""GPipe-style pipeline-parallel stage utility over a mesh axis ('pipe').

The reference's ``pipeline_apply``: microbatches flow through ``n_stages``
stages, one a rank along ``axis``, connected by a ring shift of the
activations (its ``ppermute``), on the classic schedule of
(n_micro + n_stages - 1) ticks.  The LM's production meshes have no 'pipe'
axis; this runs where a mesh has one.
"""
from __future__ import annotations

from typing import Callable

import torch


def pipeline_apply(fn_stage: Callable, x: torch.Tensor, stage_params, mesh,
                   n_micro: int, axis: str = "pipe") -> torch.Tensor:
    """Run ``fn_stage(params_of_stage, micro_batch)`` as a GPipe pipeline
    on this rank of ``mesh``.

    x: (B, ...) the whole batch (every rank the same), split into n_micro
    microbatches along axis 0.  stage_params: this rank's block of the
    stage-stacked parameters, a tensor or a dict of them with leading
    extent 1 (the stage axis over ``axis``).  Returns fn's output for the
    whole batch, with x's layout, on every rank.
    """
    n_stages = mesh.shape[axis]
    if x.shape[0] % n_micro:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{n_micro} microbatches")
    sid = mesh.coords[axis]
    p_own = _first(stage_params)
    micros = x.reshape(n_micro, -1, *x.shape[1:])
    buf = torch.zeros_like(micros[0])
    outs = torch.zeros_like(micros)
    for t in range(n_micro + n_stages - 1):
        mb = t - sid
        # stage 0 feeds new microbatches; the others take the shifted ones
        cur = micros[min(max(mb, 0), n_micro - 1)] if sid == 0 else buf
        y = fn_stage(p_own, cur) if 0 <= mb < n_micro else cur
        if 0 <= mb < n_micro and sid == n_stages - 1:
            outs[mb] = y             # the last stage keeps its finished one
        buf, = mesh.ring_shift([y], axis)       # stage i -> i + 1
    # the last stage's outputs to every rank: a sum with the others' zeros
    if sid != n_stages - 1:
        outs = torch.zeros_like(outs)
    return mesh.all_reduce(outs, axis).reshape(x.shape)


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]
