"""Multi-pod dry run: every (arch x input-shape x mesh) cell counted on the
production mesh with meta-device stand-ins (nothing is allocated, no card
is needed), priced on a hardware row for the roofline.

The reference lowers and compiles each cell for 512 placeholder devices
and reads flops, bytes and collective bytes out of XLA's HLO.  The port
runs rank 0's step of ``make_production_mesh`` itself, on the meta device
(``analysis.count``): the train, prefill or decode step of
``train.steps`` on the rank's parameter, optimizer and cache blocks and
the whole batch, the collectives through a ``CountingMesh``.  One process,
no process group:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \
        --out results/dryrun_torch [--hw h100|tpu-v5e]

Filters: --arch, --shape, --mesh {single,multi,both}, --skip-existing;
--layout, --microbatches and ``KV_INT8=1`` (int8 decode caches) as the
reference's launcher reads them.  ``--include-mars`` writes the mars-rsga
cell as a skip: the mapper's chunk program syncs with the host twice a
chunk and its kernels need real tensors, so it is not counted; its
``model_flops`` is the reference's AU-op formula.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import time
import traceback

import torch

from repro_torch.analysis import count as count_lib
from repro_torch.analysis import roofline as rl
from repro_torch.configs import (ARCHS, SHAPES, SHAPE_ORDER, cell_applicable,
                                 get_config)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M

MARS_NOTE = ("not counted: the chunk program syncs with the host twice a "
             "chunk and its kernels need real tensors; model_flops is the "
             "AU-op count")


def _mars_cell(shape_key: str, mesh_name: str, chips: int,
               hw: str) -> rl.CellResult:
    """The mapper's cell as a skip, with the reference's useful work: the
    AU-op count of a chunk (``ssd_model.OPS``) as flops-equivalent."""
    from repro_torch.core.config import MarsConfig
    from repro_torch.core.ssd_model import OPS
    cfg = MarsConfig(hash_bits=18).with_mode("ms_fixed")
    reads = {"map_8k": 8192, "map_32k": 32768}[shape_key]
    useful = reads * (cfg.signal_len * OPS["ed_per_sample"] +
                      cfg.max_events * OPS["quant_per_event"] +
                      cfg.max_events * OPS["hash_per_seed"] +
                      cfg.max_anchors * cfg.chain_band * OPS["dp_per_pair"])
    return rl.CellResult(
        arch="mars-rsga", shape=shape_key, mesh=mesh_name, chips=chips,
        flops_per_device=0, bytes_per_device=0, wire_bytes_per_device=0,
        collective_detail={}, peak_memory_per_device=None,
        model_flops=float(useful), model_flops_basis="AU-ops", tokens=reads,
        status="skip", note=MARS_NOTE, hw=hw)


def cell_spec(arch: str, shape_key: str, multi_pod: bool,
              layout: str = "2d", hw: str = rl.DEFAULT_HW) -> rl.CellResult:
    """The cell as far as it needs no count: its mesh's ``chips``, a skip
    and its note (the mars-rsga cell, ``cell_applicable``), and
    ``tokens``, ``model_flops`` and its basis by the reference's rule
    (6·N_active·D to train, 2·N_active·D to serve); an ``ok`` cell's
    counts are 0 until ``count_cell`` fills them."""
    mesh = make_production_mesh(multi_pod=multi_pod, layout=layout)
    mesh_name = "multi" if multi_pod else "single"
    chips = mesh.size
    if arch == "mars-rsga":
        return _mars_cell(shape_key, mesh_name, chips, hw)
    cfg = get_config(arch)
    shape = SHAPES[shape_key]
    empty = dict(arch=arch, shape=shape_key, mesh=mesh_name, chips=chips,
                 flops_per_device=0, bytes_per_device=0,
                 wire_bytes_per_device=0, collective_detail={},
                 peak_memory_per_device=None, hw=hw)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return rl.CellResult(**empty, model_flops=0, model_flops_basis="-",
                             tokens=0, status="skip", note=why)
    n_active = M.active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops, basis = 6.0 * n_active * tokens, "6ND"
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops, basis = 2.0 * n_active * tokens, "2ND"
    else:  # decode
        tokens = shape.global_batch
        model_flops, basis = 2.0 * n_active * tokens, "2ND"
    return rl.CellResult(**empty, model_flops=model_flops,
                         model_flops_basis=basis, tokens=tokens)


def count_cell(arch: str, shape_key: str, multi_pod: bool,
               microbatches: int = 1, layout: str = "2d",
               hw: str = rl.DEFAULT_HW) -> rl.CellResult:
    """Count one cell: rank 0's step on the meta device."""
    res = cell_spec(arch, shape_key, multi_pod, layout, hw)
    if res.status != "ok":
        return res
    shape = SHAPES[shape_key]
    kv_dtype = (torch.int8 if shape.kind == "decode"
                and os.environ.get("KV_INT8") == "1" else torch.bfloat16)
    mesh = count_lib.CountingMesh.of(
        make_production_mesh(multi_pod=multi_pod, layout=layout))
    t0 = time.perf_counter()
    got = count_lib.count_step(get_config(arch), shape, mesh,
                               microbatches=microbatches, kv_dtype=kv_dtype)
    dt = time.perf_counter() - t0
    return dataclasses.replace(
        res, flops_per_device=got["flops"], bytes_per_device=got["bytes"],
        wire_bytes_per_device=mesh.wire_bytes,
        collective_detail=dict(mesh.detail),
        peak_memory_per_device=got["arg_bytes"] + got["out_bytes"],
        note=(f"counted on meta, rank 0, {dt:.1f}s; "
              "peak_memory_per_device = the rank's argument blocks "
              f"{got['arg_bytes']} + output blocks {got['out_bytes']} "
              "bytes, temporaries left out; bytes_per_device unfused"))


def _error_cell(arch: str, shape_key: str, mesh_name: str, err: Exception,
                hw: str) -> rl.CellResult:
    return rl.CellResult(
        arch=arch, shape=shape_key, mesh=mesh_name, chips=0,
        flops_per_device=0, bytes_per_device=0, wire_bytes_per_device=0,
        collective_detail={}, peak_memory_per_device=None, model_flops=0,
        model_flops_basis="-", tokens=0, status="error", note=str(err)[:500],
        hw=hw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--include-mars", action="store_true")
    ap.add_argument("--layout", default="2d", choices=("2d", "fsdp"),
                    help="axis semantics: 2d = TP+FSDP ('data','model'); "
                         "fsdp = pure data/FSDP (Perf hillclimb variant)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--hw", default=rl.DEFAULT_HW, choices=sorted(rl.HARDWARE),
                    help="the hardware row the roofline terms use")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    if args.include_mars and args.arch == "all":
        archs.append("mars-rsga")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    for arch in archs:
        shape_keys = (["map_8k"] if arch == "mars-rsga" else
                      list(SHAPE_ORDER))
        if args.shape != "all":
            shape_keys = [args.shape]
        for sk in shape_keys:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                fname = out_dir / f"{arch}__{sk}__{mesh_name}.json"
                if args.skip_existing and fname.exists():
                    print(f"[skip-existing] {fname.name}")
                    continue
                t0 = time.time()
                try:
                    res = count_cell(arch, sk, mp,
                                     microbatches=args.microbatches,
                                     layout=args.layout, hw=args.hw)
                    dt = time.time() - t0
                    rl.save_cell(res, out_dir)
                    if res.status == "ok":
                        print(f"[ok] {arch} {sk} {mesh_name}: "
                              f"flops/dev={res.flops_per_device:.3e} "
                              f"wire/dev={res.wire_bytes_per_device:.3e} "
                              f"bound={res.bottleneck} "
                              f"roofline={res.roofline_fraction:.2%} "
                              f"({dt:.0f}s)")
                        if res.peak_memory_per_device:
                            print(f"     mem/dev={res.peak_memory_per_device/2**30:.2f} GiB")
                    else:
                        print(f"[{res.status}] {arch} {sk} {mesh_name}: "
                              f"{res.note}")
                except Exception as e:
                    dt = time.time() - t0
                    print(f"[FAIL] {arch} {sk} {mesh_name} ({dt:.0f}s): {e}")
                    traceback.print_exc()
                    rl.save_cell(_error_cell(arch, sk, mesh_name, e, args.hw),
                                 out_dir)

    cells = rl.load_cells(out_dir)
    print("\n" + rl.format_table(cells))


if __name__ == "__main__":
    main()
