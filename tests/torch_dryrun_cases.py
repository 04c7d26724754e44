"""The JAX package's side of the dry run's checks: every cell of
``repro.launch.dryrun`` (the ten architectures x four shapes on the single
and the multi-pod mesh, the 2d layout, and the mars-rsga cell) lowered and
compiled by the JAX package's own ``lower_cell``, on 512 forced host
devices, with its derived roofline fields (``CellResult.to_dict``).

``jax.make_mesh`` builds Explicit axes in this JAX version, which the
model's sharding constraints refuse (the JAX launcher fails on them); a
mesh of Auto axes lowers the same functions, so each child process swaps
``make_production_mesh`` for one.  The host devices must exist before JAX
starts, so every cell group runs in a child process of its own:

    PYTHONPATH=src python tests/torch_dryrun_cases.py
        rewrites src/repro_torch/analysis/jax_dryrun_golden.json (a few
        minutes; ``--jobs N`` children at a time, default 2);
    PYTHONPATH=src python tests/torch_dryrun_cases.py --deviations
        prints the port's count (``repro_torch.launch.dryrun``) beside each
        JAX cell: the flops ratio, the op bytes and the wire bytes by kind,
        and each family's range of the ratio (``--arch``/``--shape``/
        ``--mesh`` filter the cells; ~15 minutes for all); with
        ``--write`` it records each cell's ratio and the cells outside the
        tolerance with their traced causes (``CAUSES``) in the golden;
    PYTHONPATH=src python tests/torch_dryrun_cases.py --trace CELL
        prints one cell's largest products on both sides (the JAX cell's
        HLO dots with loop trip counts, the port's counted matmuls), by
        operand and result shape: where the two counts part.

``repro_torch.analysis.golden`` says what the golden holds.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.analysis import golden as G  # noqa: E402

MARK = "@@CELL "

# the child: lower the cells named in argv with the JAX package's launcher
_CHILD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as D

def auto_production_mesh(*, multi_pod=False, layout="2d"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if layout == "fsdp":
        axes = axes[:-1] + ("data2",)
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))

D.make_production_mesh = auto_production_mesh
for spec in sys.argv[1:]:
    arch, shape, mesh = spec.split(":")
    res, _ = D.lower_cell(arch, shape, mesh == "multi")
    print("@@CELL " + json.dumps(res.to_dict()), flush=True)
"""


# the child of ``--trace``: one cell's HLO products, by shape
_TRACE_CHILD = _CHILD.split("for spec in")[0] + r"""
import re
from repro.analysis import hlo as H
arch, shape, mesh = sys.argv[1].split(":")
_, compiled = D.lower_cell(arch, shape, mesh == "multi")
comps, entry = H.parse_module(compiled.as_text())
agg = {}

def walk(name, mult, stack):
    if name not in comps or name in stack:
        return
    comp, stack = comps[name], stack | {name}
    for op in comp.ops:
        if op.kind == "while":
            bm = re.search(r"body=([%\w\.\-]+)", op.line)
            cm = re.search(r"condition=([%\w\.\-]+)", op.line)
            trip = H._trip_count(comps[cm.group(1)]) if cm else None
            if bm:
                walk(bm.group(1), mult * (trip or 1), stack)
            continue
        for c in op.called:
            walk(c, mult, stack)
        if op.kind in ("dot", "convolution"):
            f = (H._dot_flops(op, comp) if op.kind == "dot"
                 else H._conv_flops(op, comp))
            lhs = comp.table.get(op.operands[0]) if op.operands else None
            rhs = comp.table.get(op.operands[1]) if len(op.operands) > 1 else None
            key = (str(lhs.dims[0] if lhs and lhs.dims else "?") + " x "
                   + str(rhs.dims[0] if rhs and rhs.dims else "?") + " -> "
                   + str(op.dims[0] if op.dims else "?"))
            n, fl = agg.get(key, (0, 0.0))
            agg[key] = (n + mult, fl + mult * f)

walk(entry, 1.0, frozenset())
print("@@CELL " + json.dumps(agg))
"""


# Where the two flops counts part, traced with ``--trace`` on the cells
# outside the tolerance (the products of the largest share on each side):
# a product that GSPMD replicates over a mesh axis and the port splits, or
# the reverse.  Each cell outside FLOPS_TOLERANCE names its causes here;
# ``--write`` refuses a cell outside it with none.
CAUSES = {
    "kv_proj": ("n_kv < 16 'model' ranks: GSPMD computes the K and V "
                "projections whole (n_kv*d_head columns) on every 'model' "
                "rank; the port splits their columns 16 ways"),
    "one_hot": ("the JAX model embeds by a one-hot product (2*tokens*vocab"
                "*d, and its gradient); the port gathers the rows"),
    "heads": ("n_heads (hymba 25, llama4 40) does not divide 'model' (16): "
              "the port computes every head's scores and values on every "
              "'model' rank; GSPMD splits the attention products over "
              "d_head or the query positions"),
    "ssd": ("the port runs the SSD scan (the chunk products and the state "
            "readout) for every head on every 'model' rank; GSPMD splits "
            "them by head"),
    "in_proj": ("GSPMD computes the SSM in_proj whole (6448 columns) on "
                "every 'model' rank; the port splits its columns 16 ways"),
    "moe_whole": ("a rank's decode tokens (8) fill no dispatch group (64): "
                  "the port routes the whole batch on every 'data' rank and "
                  "computes its experts' slots of every group there; GSPMD "
                  "splits the expert products over the FSDP d_model"),
    "dh_scores": ("batch 1: the cache's d_head lies over 'model'; GSPMD "
                  "contracts the scores over the rank's d_head slice (5 of "
                  "80) and sums the partials; the port gathers d_head and "
                  "contracts all of it for its 2 heads"),
}
# (arch, shape or None for every shape) -> causes
CELL_CAUSES = {
    ("qwen3-4b", "train_4k"): ("kv_proj", "one_hot"),
    ("h2o-danube-1.8b", "long_500k"): ("dh_scores",),
    ("hymba-1.5b", None): ("heads", "ssd"),
    ("llama4-maverick-400b-a17b", "decode_32k"): ("heads", "moe_whole"),
    ("llama4-maverick-400b-a17b", "prefill_32k"): ("heads",),
    ("qwen3-moe-30b-a3b", "decode_32k"): ("moe_whole",),
    ("mamba2-780m", None): ("in_proj", "ssd", "one_hot"),
}


def explain(rows: dict) -> dict:
    """{cell: its causes' text} of the cells outside the tolerance; raises
    for such a cell that no traced cause names."""
    t = G.FLOPS_TOLERANCE
    out, untraced = {}, []
    for key, row in rows.items():
        if 1 / t <= row["ratio"] <= t:
            continue
        arch, shape, _ = key.split("__")
        causes = (CELL_CAUSES.get((arch, shape))
                  or CELL_CAUSES.get((arch, None)))
        if not causes:
            untraced.append(f"{key} {row['ratio']:.4f}")
            continue
        out[key] = "; ".join(CAUSES[c] for c in causes)
    if untraced:
        raise RuntimeError("cells outside the tolerance with no traced "
                           f"cause (run --trace): {untraced}")
    return out


def all_cells():
    """(arch, shape, mesh) of every golden cell, grouped by arch: the JAX
    launcher's ``--mesh both --include-mars`` order."""
    from repro_torch.configs import ARCHS, SHAPE_ORDER
    groups = []
    for arch in list(ARCHS) + ["mars-rsga"]:
        shapes = ["map_8k"] if arch == "mars-rsga" else list(SHAPE_ORDER)
        groups.append([(arch, s, m) for s in shapes
                       for m in ("single", "multi")])
    return groups


def run_group(cells) -> list:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _CHILD]
                       + [":".join(c) for c in cells],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=3600)
    got = [json.loads(line[len(MARK):]) for line in r.stdout.splitlines()
           if line.startswith(MARK)]
    if r.returncode or len(got) != len(cells):
        raise RuntimeError(f"cells {cells} failed:\n{r.stdout[-3000:]}\n"
                           f"{r.stderr[-6000:]}")
    return got


def build(jobs: int) -> dict:
    import jax
    cells = {}
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(jobs) as ex:
        for got in ex.map(run_group, all_cells()):
            for c in got:
                key = f"{c['arch']}__{c['shape']}__{c['mesh']}"
                cells[key] = c
                print(f"[{c['status']}] {key} flops/dev="
                      f"{c['flops_per_device']:.4e} wire/dev="
                      f"{c['wire_bytes_per_device']:.4e} "
                      f"({time.time() - t0:.0f}s)", flush=True)
    return dict(
        source=("repro.launch.dryrun.lower_cell, layout 2d, "
                "make_production_mesh on Auto axes, 512 host devices, "
                f"jax {jax.__version__}"),
        hw="tpu-v5e", layout="2d", cells=dict(sorted(cells.items())))


# --------------------------------------------------------------------------- #
# The port beside the golden
# --------------------------------------------------------------------------- #
def deviations(arch="all", shape="all", mesh="both") -> dict:
    """{cell: the port's count beside the JAX cell} for the golden's ok
    cells, and {family: (min, max) of the flops ratio}."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    gold = G.load()
    rows, fam = {}, {}
    for key, jc in gold["cells"].items():
        if jc["status"] != "ok" or jc["arch"] == "mars-rsga":
            continue
        if ((arch != "all" and jc["arch"] != arch)
                or (shape != "all" and jc["shape"] != shape)
                or (mesh != "both" and jc["mesh"] != mesh)):
            continue
        t0 = time.time()
        pc = dryrun.count_cell(jc["arch"], jc["shape"], jc["mesh"] == "multi",
                               hw="tpu-v5e")
        ratio = pc.flops_per_device / jc["flops_per_device"]
        f = get_config(jc["arch"]).family
        lo, hi = fam.get(f, (ratio, ratio))
        fam[f] = (min(lo, ratio), max(hi, ratio))
        kinds = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
        rows[key] = dict(
            ratio=ratio, port_flops=pc.flops_per_device,
            jax_flops=jc["flops_per_device"],
            port_bytes=pc.bytes_per_device, jax_bytes=jc["bytes_per_device"],
            port_wire=pc.wire_bytes_per_device,
            jax_wire=jc["wire_bytes_per_device"],
            wire={k: (pc.collective_detail.get(f"bytes_{k}", 0.0),
                      jc["collective_detail"].get(f"bytes_{k}", 0.0))
                  for k in kinds})
        wire = " ".join(f"{k}={p:.3e}/{j:.3e}"
                        for k, (p, j) in rows[key]["wire"].items() if p or j)
        print(f"{key:44s} flops {ratio:.4f} ({pc.flops_per_device:.4e} / "
              f"{jc['flops_per_device']:.4e}) bytes "
              f"{pc.bytes_per_device:.3e}/{jc['bytes_per_device']:.3e} "
              f"wire {wire} ({time.time() - t0:.1f}s)", flush=True)
    for f, (lo, hi) in sorted(fam.items()):
        print(f"[family] {f:7s} flops ratio {lo:.4f} .. {hi:.4f}")
    return dict(cells=rows, families=fam)


def _port_products(arch, shape, multi_pod) -> dict:
    """{"lhs x rhs -> out": (calls, flops)} of the port's counted step."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis import count
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    aten = torch.ops.aten
    prods = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
    agg = {}

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket in prods:
                a, b = args[-2], args[-1]
                fl = 2.0 * out.numel() * a.shape[-1]
                key = f"{list(a.shape)} x {list(b.shape)} -> {list(out.shape)}"
                n, f = agg.get(key, (0, 0.0))
                agg[key] = (n + 1, f + fl)
            return out

    mesh = count.CountingMesh.of(make_production_mesh(multi_pod=multi_pod))
    with FlopCounterMode(display=False) as fc, Products():
        count.count_step(get_config(arch), SHAPES[shape], mesh,
                         with_bytes=False)
    return agg, float(fc.get_total_flops())


def trace(cell: str, top: int = 20) -> None:
    """Print the largest products of one cell on both sides: the JAX
    cell's HLO dots (by operand and result shape, loop trip counts
    applied) and the port's counted matmuls."""
    arch, shape, mesh = cell.split("__")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _TRACE_CHILD,
                        f"{arch}:{shape}:{mesh}"], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=3600)
    got = [json.loads(line[len(MARK):]) for line in r.stdout.splitlines()
           if line.startswith(MARK)]
    if r.returncode or not got:
        raise RuntimeError(r.stderr[-6000:])
    port, total = _port_products(arch, shape, mesh == "multi")
    for side, agg in (("jax", got[0]), ("port", port)):
        tot = sum(f for _, f in agg.values())
        print(f"[{side}] {cell}: {tot:.4e} flops in {len(agg)} shapes")
        for key, (n, f) in sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]:
            print(f"  {f:.4e} {f / tot:6.1%} x{n:<6g} {key}")
    print(f"[port] FlopCounterMode total {total:.4e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--deviations", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--trace", metavar="CELL",
                    help="print one cell's largest products on both sides "
                         "(CELL: arch__shape__mesh)")
    ap.add_argument("--write", action="store_true",
                    help="with --deviations over every cell: record each "
                         "cell's ratio and the explained cells in the "
                         "golden")
    args = ap.parse_args(argv)
    if args.trace:
        trace(args.trace)
        return
    if args.deviations:
        dev = deviations(args.arch, args.shape, args.mesh)
        if args.write:
            gold = G.load()
            if set(dev["cells"]) != {k for k, c in gold["cells"].items()
                                     if c["status"] == "ok"
                                     and c["arch"] != "mars-rsga"}:
                raise SystemExit("--write needs every cell (no filter)")
            gold["flops_tolerance"] = G.FLOPS_TOLERANCE
            gold["flops_ratio"] = {k: r["ratio"]
                                   for k, r in sorted(dev["cells"].items())}
            gold["flops_explained"] = explain(dev["cells"])
            G.PATH.write_text(json.dumps(gold, indent=1) + "\n")
            print(f"wrote {G.PATH}: {len(gold['flops_explained'])} cells "
                  "explained")
        return
    gold = build(args.jobs)
    if G.PATH.exists():
        # the port's side stays until --deviations --write measures it anew
        old = G.load()
        gold.update({k: old[k] for k in ("flops_tolerance", "flops_ratio",
                                          "flops_explained") if k in old})
    G.PATH.write_text(json.dumps(gold, indent=1) + "\n")
    print(f"wrote {G.PATH} ({len(gold['cells'])} cells)")


if __name__ == "__main__":
    main()
