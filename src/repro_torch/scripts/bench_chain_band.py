"""Report the resources of the chaining DP's band kernel
(``chain_dp_band_kernel`` in ``csrc/chain_dp.cu``, any ``chain_band`` but
32) as built for the card.

    PYTHONPATH=src python -m repro_torch.scripts.bench_chain_band \
        [--out results/bench_torch/cuda/bench_chain_band.json]

Prints the card's name and power limit; ptxas's registers, spills, stack
and shared memory for each instance of the band kernel; and the SASS of
its anchor loop (instructions a step, by opcode).  Its times on the card
come from ``chip_smoke.py``'s kernels phase.  Needs a card; raises
without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys


def instance(mangled: str):
    """"KR=k[ far][ wide]" for an instance of the band kernel, else
    None."""
    m = re.search(r"chain_dp_band_kernelILi(\d+)ELb([01])ELb([01])E",
                  mangled)
    if not m:
        return None
    return (f"KR={m.group(1)}" + (" far" if m.group(2) == "1" else "")
            + (" wide" if m.group(3) == "1" else ""))


def ptxas_band(log: str) -> dict:
    """Registers, stack, spills and shared memory of each band instance in
    chain_dp.cu's ``nvcc -Xptxas -v`` output, keyed by instance()."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = instance(m.group(1))
            if key:
                out[key] = {}
            continue
        if key is None:
            continue
        for pat, names in ((r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads",
                            ("stack", "spill_stores", "spill_loads")),
                           (r"Used (\d+) registers", ("registers",)),
                           (r"(\d+) bytes smem", ("smem",))):
            m = re.search(pat, line)
            if m:
                out[key].update(zip(names, map(int, m.groups())))
    return out


def sass_band(lib_path) -> dict:
    """Per instance: the anchor loop's instructions a step (the loop that
    holds the REDUX, less the loop over the sets read back nested in it),
    and its shuffles, REDUX and I2F a step."""
    from repro_torch.kernels import build
    text = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = instance(m.group(1))
            if name:
                funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2),
                                m.group(3)))
    out = {}
    for name, ins in funcs.items():
        spans = []
        for i, (addr, op, rest) in enumerate(ins):
            m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if m and int(m.group(1), 16) < addr:
                target = int(m.group(1), 16)
                spans.append((next(j for j, x in enumerate(ins)
                                   if x[0] >= target), i))

        def ops_in(a, b, op):
            return sum(1 for _, o, _ in ins[a:b + 1] if o.startswith(op))
        loops = [(a, b) for a, b in spans if ops_in(a, b, "REDUX")]
        if not loops:
            continue
        a, b = min(loops, key=lambda ab: ab[1] - ab[0])
        far = [(c, d) for c, d in spans if a < c and d < b
               and ops_in(c, d, "LDG")]
        # the loop over the sets read back may be unrolled and keep a
        # remainder loop: count every nested loop's body that loads once
        n_far = sum(d - c + 1 for c, d in far)
        steps = ops_in(a, b, "REDUX") // 2
        total = b - a + 1 - n_far
        inner = {i for c, d in far for i in range(c, d + 1)}
        by_op = {}
        for j in range(a, b + 1):
            if j not in inner:
                op = ins[j][1].split(".")[0]
                by_op[op] = by_op.get(op, 0) + 1
        out[name] = dict(steps_a_pass=steps, per_step=total / steps,
                         shfl=ops_in(a, b, "SHFL") / steps,
                         redux=ops_in(a, b, "REDUX") / steps,
                         i2f=ops_in(a, b, "I2F") / steps,
                         far_loop_instructions=n_far,
                         ops_a_step={k: v / steps for k, v in sorted(
                             by_op.items(), key=lambda kv: -kv[1])})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--out", default="results/bench_torch/cuda/bench_chain_band.json")
    args = ap.parse_args(argv)
    from repro_torch.core.pipeline import check_device
    check_device("cuda")
    from repro_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib_path = build.build()
    build.lib()
    record = {"device": smi, "ptxas": ptxas_band(
        build.BUILD_LOG.get("chain_dp.cu", "")), "sass": sass_band(lib_path)}
    for k, v in record["ptxas"].items():
        print(f"[ptxas] {k}: {v}", flush=True)
    for k, v in record["sass"].items():
        print(f"[sass] {k}: {v}", flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": True, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
