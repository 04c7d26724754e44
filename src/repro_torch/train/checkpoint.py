"""Checkpoints in the reference's on-disk format: atomic save, the latest
valid step, validated restore.

Layout (one directory per step), as ``repro/train/checkpoint.py`` writes
it, so either package restores the other's checkpoints:

    <dir>/step_000000123/
        manifest.json      {step, leaves: [{path, shape, dtype, file,
                            sha256}], data_state, extra}
        arr_00000.npy ...  one .npy per leaf, in tree order
        COMMIT             written last; a step without COMMIT is ignored

A step is written under ``.tmp_step_*`` and renamed into place; ``keep``
bounds the steps kept.  Leaf paths are the reference's: tuple positions,
``.name`` for a named tuple's fields (``AdamWState``), dict keys in sorted
order, joined by "/" (``0/embed``, ``1/.step``, ``1/.m/embed``).  A bf16
leaf is stored as its uint16 bit pattern under the dtype name
``"bfloat16"`` (through torch's bf16 view: no ``ml_dtypes``), so the
``.npy`` files of a tree equal the reference's byte for byte.

On a mesh (``shardings``: a tree of ``distributed.sharding.NamedSharding``)
``save`` gathers each leaf whole, one at a time, and rank 0 writes the
one-device files; ``restore`` reads each rank's own block of each leaf
from the file (a memory map: the rank never holds the whole tree), onto
any mesh: reshard-on-restore.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pipeline import check_device
from repro_torch.distributed.sharding import NamedSharding, block, gather


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The leaf as the array the reference saves, and its dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _dtype_name(t.dtype)


def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr, order="C")          # a writable copy (0-d kept)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_paths(tree) -> Tuple[List[str], List[Any], Any]:
    """(paths, leaves, rebuild) of a tree of tuples, named tuples and
    dicts: the reference's ``_leaf_paths`` strings, and a function that
    builds a tree of the same structure from a list of new leaves."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, keys):
        if isinstance(node, NamedSharding):
            paths.append("/".join(keys))
            leaves.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], keys + [str(k)])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), keys + [f".{name}"])
        elif isinstance(node, (tuple, list)):
            for i, x in enumerate(node):
                walk(x, keys + [str(i)])
        else:
            paths.append("/".join(keys))
            leaves.append(node)

    walk(tree, [])

    def rebuild(new_leaves):
        it = iter(new_leaves)

        def build(node):
            if isinstance(node, NamedSharding):
                return next(it)
            if isinstance(node, dict):
                out = {k: None for k in node}
                for k in sorted(node):
                    out[k] = build(node[k])
                return out
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*(build(getattr(node, n))
                                    for n in node._fields))
            if isinstance(node, (tuple, list)):
                return type(node)(build(x) for x in node)
            return next(it)
        return build(tree)

    return paths, leaves, rebuild


def save(ckpt_dir, step: int, tree, data_state: Optional[Dict] = None,
         extra: Optional[Dict] = None, keep: int = 3,
         shardings=None) -> pathlib.Path:
    """Write ``tree`` as step ``step``.  With ``shardings`` (a congruent
    tree) the leaves are a rank's blocks: every rank calls ``save``, each
    leaf is gathered whole in turn, rank 0 writes the files (the same
    bytes as the one-device save), and every rank returns once they are
    published."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:09d}"
    paths, leaves, _ = _leaf_paths(tree)
    mesh = None
    if shardings is not None:
        _, shards, _ = _leaf_paths(shardings)
        mesh = shards[0].mesh
        leaves = (gather(leaf, sh.spec, sh.mesh)
                  for leaf, sh in zip(leaves, shards))
        if mesh.rank != 0:
            for _ in leaves:               # the gathers rank 0 waits on
                pass
            mesh.barrier()
            return final
    tmp = ckpt_dir / f".tmp_step_{step:09d}_{int(time.time()*1e6)}"
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = dict(step=step, leaves=[], data_state=data_state or {},
                    extra=extra or {})
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        store, dtype_name = _to_savable(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(tmp / fname, store)
        digest = hashlib.sha256((tmp / fname).read_bytes()).hexdigest()
        manifest["leaves"].append(dict(path=p, shape=list(store.shape),
                                       dtype=dtype_name, file=fname,
                                       sha256=digest))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    _gc(ckpt_dir, keep)
    if mesh is not None:
        mesh.barrier()
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(d for d in ckpt_dir.glob("step_*") if d.is_dir())
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
    for d in ckpt_dir.glob(".tmp_step_*"):
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    valid = [d for d in sorted(ckpt_dir.glob("step_*"))
             if (d / "COMMIT").exists()]
    if not valid:
        return None
    return int(valid[-1].name.split("_")[1])


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(1 << 24), b""):
            h.update(piece)
    return h.hexdigest()


def restore(ckpt_dir, tree_abstract, step: Optional[int] = None,
            validate: bool = True, device="cuda", shardings=None
            ) -> Tuple[Any, int, Dict, Dict]:
    """(tree, step, data_state, extra) of the latest valid step (or
    ``step``): each leaf of ``tree_abstract`` (tensors on the meta device
    give the shapes and dtypes) read by its path, its file's sha256
    checked, cast to the abstract leaf's dtype if it differs, and put on
    ``device``.  With ``shardings`` (a congruent tree of
    ``NamedSharding``, on any mesh) each leaf is the rank's block of it,
    read alone from the file."""
    device = check_device(device)
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())

    paths, leaves_abs, rebuild = _leaf_paths(tree_abstract)
    shards = (_leaf_paths(shardings)[1] if shardings is not None
              else [None] * len(paths))
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for p, ab, sh in zip(paths, leaves_abs, shards):
        e = by_path[p]
        f = d / e["file"]
        if validate and _sha256(f) != e["sha256"]:
            raise IOError(f"checkpoint corruption in {f}")
        arr = np.load(f, mmap_mode="r")
        if tuple(arr.shape) != tuple(ab.shape):
            raise ValueError(f"{p}: shape {tuple(arr.shape)} != expected "
                             f"{tuple(ab.shape)}")
        if sh is not None:
            arr = block(arr, sh.spec, sh.mesh)
        t = _from_savable(arr, e["dtype"])
        if t.dtype != ab.dtype:
            t = t.to(ab.dtype)
        out.append(t.to(device))
    tree = rebuild(out)
    return tree, step, manifest.get("data_state", {}), manifest.get("extra",
                                                                      {})
