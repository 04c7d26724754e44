"""Roofline terms of a dry-run cell, on a row of a hardware table.

Per (arch x shape x mesh) cell, on hardware row ``hw``:
    compute term    = flops_global       / (chips * peak_flops)
    memory term     = bytes_global       / (chips * hbm_bw)
    collective term = wire_bytes_per_dev / link_bw
                      (== collective_bytes_global / (chips * link_bw))

The reference prices every cell on one TPU v5e-class row (197 TFLOP/s
bf16, 819 GB/s HBM, ~50 GB/s a link of ICI); the port keeps that row,
``tpu-v5e``, so its math can be held exactly against the reference's, and
adds ``h100``: NVIDIA's H100 SXM data sheet, 989 TFLOP/s dense bf16 and
3.35 TB/s of HBM3.  Its link is one 400 Gb/s NDR InfiniBand NIC a card,
one direction: 50 GB/s.  NVLink 4's 450 GB/s a direction (900 GB/s both
directions summed) holds only among the eight cards of a node, and a
256-card (16, 16) mesh spans 32 nodes, so even the 'model' axis crosses
them; the NVLink figure is not used.

The per-device counts are the rank's (``analysis.count`` in the port,
XLA's HLO in the reference); the global numbers scale them by ``chips``.
MODEL_FLOPS uses 6*N*D for training and 2*N*D for forward-only serving
shapes (documented next to the ratio).

One departure from the reference: a cell of no chips (the launcher's
error cell, ``chips=0``) prices every term, the useful-flops ratio and the
roofline fraction at 0 where the reference divides by zero.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, NamedTuple, Optional


class Hardware(NamedTuple):
    name: str
    peak_flops: float        # bf16 FLOP/s a chip
    hbm_bw: float            # B/s a chip
    link_bw: float           # B/s a link
    onchip: str              # the on-chip scratch the suggestions name


HARDWARE: Dict[str, Hardware] = {
    "tpu-v5e": Hardware("tpu-v5e", 197e12, 819e9, 50e9, "VMEM"),
    "h100": Hardware("h100", 989e12, 3.35e12, 50e9, "shared memory"),
}
DEFAULT_HW = "h100"


def hardware(name: str) -> Hardware:
    if name not in HARDWARE:
        raise KeyError(f"unknown hardware {name!r}; known: "
                       f"{sorted(HARDWARE)}")
    return HARDWARE[name]


def suggest(arch: str, bottleneck: str, basis: str,
            hw: str = DEFAULT_HW) -> str:
    """One sentence: what would move the dominant term down."""
    mem = hardware(hw).onchip
    serve = basis != "6ND"
    if arch == "mars-rsga":
        return ("fuse the integer pipeline into the Pallas kernels "
                f"({mem}-resident intermediates); the jnp fallback "
                "materializes every stage")
    if bottleneck == "collective":
        if "moe" in arch or "maverick" in arch:
            return ("shrink EP all-to-all payloads: larger token GROUP, "
                    "int8 dispatch masks, fewer expert shards per group")
        if serve:
            return ("shard the KV cache over more axes; batch decode "
                    "requests to amortize weight gathers")
        return ("reduce TP degree / FSDP layout: activation collectives "
                "dominate, weights-only gathers are ~3x params")
    if bottleneck == "memory":
        if serve:
            return ("int8 KV cache + larger decode batch (cache and "
                    "weight reads amortize over tokens)")
        return ("fused attention/SSD kernel keeping score/decay tensors "
                f"in {mem}; bf16 intermediates; tuned kv_chunk")
    return ("raise per-chip arithmetic intensity: larger microbatch or "
            "wider per-shard layers")


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collective_detail: Dict[str, float]
    peak_memory_per_device: Optional[float]
    model_flops: float
    model_flops_basis: str        # "6ND" or "2ND"
    tokens: int
    status: str = "ok"
    note: str = ""
    hw: str = DEFAULT_HW          # the row of HARDWARE the terms use

    # ---- derived ----------------------------------------------------------
    @property
    def hardware(self) -> Hardware:
        return hardware(self.hw)

    @property
    def flops_global(self) -> float:
        return self.flops_per_device * self.chips

    @property
    def bytes_global(self) -> float:
        return self.bytes_per_device * self.chips

    @property
    def t_compute(self) -> float:
        if not self.chips:
            return 0.0
        return self.flops_global / (self.chips * self.hardware.peak_flops)

    @property
    def t_memory(self) -> float:
        if not self.chips:
            return 0.0
        return self.bytes_global / (self.chips * self.hardware.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / self.hardware.link_bw

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.t_compute, memory=self.t_memory,
                     collective=self.t_collective)
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        if self.flops_global <= 0:
            return 0.0
        return self.model_flops / self.flops_global

    @property
    def suggestion(self) -> str:
        return suggest(self.arch, self.bottleneck, self.model_flops_basis,
                       self.hw)

    @property
    def roofline_fraction(self) -> float:
        """useful work / time-at-bottleneck: MODEL_FLOPS/(chips*peak) over
        the dominant term — the MFU-analogue the perf loop maximizes."""
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        if t_dom <= 0 or not self.chips:
            return 0.0
        t_useful = self.model_flops / (self.chips * self.hardware.peak_flops)
        return t_useful / t_dom

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction,
                 flops_global=self.flops_global,
                 bytes_global=self.bytes_global,
                 suggestion=self.suggestion)
        return d


def save_cell(result: CellResult, out_dir) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    f = out_dir / f"{result.arch}__{result.shape}__{result.mesh}.json"
    f.write_text(json.dumps(result.to_dict(), indent=1))
    return f


def load_cells(out_dir) -> Dict[str, Dict]:
    out = {}
    for f in sorted(pathlib.Path(out_dir).glob("*.json")):
        out[f.stem] = json.loads(f.read_text())
    return out


def format_table(cells: Dict[str, Dict]) -> str:
    hdr = (f"{'arch':28s} {'shape':12s} {'mesh':9s} "
           f"{'t_comp(s)':>10s} {'t_mem(s)':>10s} {'t_coll(s)':>10s} "
           f"{'bound':>7s} {'useful':>7s} {'roofline':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for key in sorted(cells):
        c = cells[key]
        if c.get("status") != "ok":
            lines.append(f"{c['arch']:28s} {c['shape']:12s} {c['mesh']:9s} "
                         f"{c.get('note', c['status'])}")
            continue
        lines.append(
            f"{c['arch']:28s} {c['shape']:12s} {c['mesh']:9s} "
            f"{c['t_compute']:10.3e} {c['t_memory']:10.3e} "
            f"{c['t_collective']:10.3e} {c['bottleneck']:>7s} "
            f"{c['useful_flops_ratio']:7.2%} {c['roofline_fraction']:9.2%}")
    return "\n".join(lines)


def format_suggestions(cells: Dict[str, Dict]) -> str:
    """Per-cell 'what moves the dominant term down' (deliverable g)."""
    seen, lines = set(), []
    for key in sorted(cells):
        c = cells[key]
        if c.get("status") != "ok":
            continue
        s = c.get("suggestion") or suggest(c["arch"], c["bottleneck"],
                                           c.get("model_flops_basis", "6ND"),
                                           c.get("hw", "tpu-v5e"))
        tag = (c["arch"], c["shape"], c["bottleneck"])
        if tag in seen:
            continue
        seen.add(tag)
        lines.append(f"{c['arch']:28s} {c['shape']:12s} "
                     f"[{c['bottleneck']:>10s}] {s}")
    return "\n".join(lines)
