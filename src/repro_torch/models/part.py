"""Activation-sharding constraints of the LM stack.

The reference pins activation layouts on a device mesh with
``with_sharding_constraint``.  The port runs the LM on one device: a mesh
is ``None`` or a mesh of one device (every axis of size 1), and then
``constrain`` is a no-op.  A mesh of several devices raises, so nothing
that asks for sharding is silently run unsharded.  The distributed LM is
ROADMAP queue 1 item 2c.
"""
from __future__ import annotations

from typing import Sequence

import torch


def check_mesh(mesh) -> None:
    """Accept no mesh or a mesh of one device (``launch.mesh.Mesh``, whose
    ``size`` is its device count); raise for any other."""
    if mesh is not None and mesh.size != 1:
        raise NotImplementedError(
            f"the LM port runs on one device; a mesh of {mesh.size} devices "
            "needs the distributed LM (ROADMAP queue 1 item 2c)")


def constrain(x: torch.Tensor, mesh, tmpl: Sequence) -> torch.Tensor:
    """x unchanged for no mesh or a one-device mesh (``check_mesh``)."""
    if mesh is not None:
        check_mesh(mesh)
        assert len(tmpl) == x.ndim, (tmpl, x.shape)
    return x
