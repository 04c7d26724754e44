"""LLM token-serving launcher: batched prefill + decode loop with KV cache.

This drives the *language-model* side of the port (``repro_torch.models``,
``repro_torch.train.steps``) — it has nothing to do with raw-signal read
mapping, whose serving launcher is ``repro_torch.launch.serve_rsga``.  It
runs on the CUDA card unless ``--device cpu`` is given (no card and no
``--device cpu`` raises).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --reduced --batch 4 --prompt-len 64 --gen 32 [--device cpu]

The weights are random, drawn from a torch generator seeded 0 (the
reference draws its own from ``jax.random.key(0)``); the prompt and the
context stub come from numpy's generator seeded 0, as in the reference.

``--mesh`` names the reference's mesh: ``auto`` is (n/2, 2) over the n
cards (one card, or ``--device cpu``: one device), ``2x2`` and the like
are explicit.  A mesh of several devices spawns one process a rank
(``launch.mesh.run_ranks``): gloo where ranks share a card or run on the
CPU, NCCL with a card a rank (``mesh._check_backend``).  Every rank draws
the same weights and keeps its blocks, serves its rows of the batch, and
sees the whole logits; rank 0 prints the lines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --reduced --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.pipeline import check_device
from repro_torch.launch.mesh import (_check_backend, make_mesh, parse_mesh,
                                     run_ranks)
from repro_torch.models import model as M
from repro_torch.train import steps as steps_lib


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="LLM token-serving launcher (batched prefill + decode "
                    "with KV cache). For RSGA read-mapping serving, see "
                    "`python -m repro_torch.launch.serve_rsga --help`.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mesh", default="auto")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (MARS arithmetic-conversion analogue)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> Dict:
    """The launcher's body: prints its four lines and returns the sampled
    tokens (batch, gen), the host-clock seconds of the prefill and of the
    decode loop, and the config, parameters and cache it served with.  On
    a mesh of several devices it spawns the ranks (each runs
    ``serve_rank``) and returns rank 0's tokens and seconds, and every
    rank's collective counts and peak device memory."""
    device = check_device(args.device)
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    spec = parse_mesh(args.mesh, n_devices)
    if spec is None:
        return serve(args, None)
    shape, axes = spec
    world = math.prod(shape)
    backend = _check_backend(device, None, world)
    ranks = run_ranks(serve_rank, world, args, shape, axes, backend=backend,
                      timeout=RANK_TIMEOUT_S)
    return dict(ranks[0], ranks=ranks)


# a spawned mesh's whole run, set-up included, before run_ranks gives up
RANK_TIMEOUT_S = 1800.0


def serve_rank(args: argparse.Namespace, shape, axes) -> Dict:
    """One rank of a mesh (spawned by ``run``): the launcher's body on the
    rank's mesh; its tokens, seconds, ``Mesh.stats``, backend and peak
    device memory (picklable)."""
    mesh = make_mesh(shape, axes, device=args.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    res = serve(args, mesh)
    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else None)
    return dict(tokens=res["tokens"], prefill_s=res["prefill_s"],
                decode_s=res["decode_s"], rank=mesh.rank,
                backend=mesh.backend, device=str(mesh.device),
                stats=dict(mesh.stats), peak_bytes=peak)


def serve(args: argparse.Namespace, mesh) -> Dict:
    """The launcher's body on one device (``mesh`` None) or on this rank of
    ``mesh``; rank 0 alone prints."""
    device = mesh.device if mesh is not None else check_device(args.device)
    # exact f32 products and f32 reductions in cuBLAS, as the reference's
    # dots accumulate
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_len = args.prompt_len + args.gen
    kv_dtype = torch.int8 if args.kv_int8 else torch.bfloat16
    if args.kv_int8:
        # as the reference's launcher: the int8 cache stores pre-scaled
        # values; the demo keeps bf16 math (quantize-at-rest is
        # models.layers.attention's int8 layout)
        kv_dtype = torch.bfloat16

    _, jit_prefill, _ = steps_lib.make_prefill_step(cfg, mesh, max_len,
                                                    args.batch, kv_dtype)
    _, jit_decode, _ = steps_lib.make_decode_step(cfg, mesh, max_len,
                                                  args.batch, kv_dtype)
    b_abs_p = steps_lib.make_batch_abstract(
        cfg, ShapeSpec("p", args.prompt_len, args.batch, "prefill"))
    b_abs_d = steps_lib.make_batch_abstract(
        cfg, ShapeSpec("d", max_len, args.batch, "decode"))
    prefill_fn = jit_prefill(b_abs_p)
    decode_fn = jit_decode(b_abs_d)

    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device, mesh)
    cache = M.init_cache(cfg, args.batch, max_len, kv_dtype, device, mesh)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len), np.int64),
        dtype=torch.int32, device=device)
    ctx = (torch.as_tensor(rng.normal(0, 1, (args.batch, cfg.n_ctx_tokens,
                                             cfg.d_model)),
                           dtype=torch.bfloat16, device=device)
           if cfg.n_ctx_tokens else None)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, tokens, cache, ctx)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for i in range(args.gen):
        logits, cache = decode_fn(params, tok, cache, args.prompt_len + i,
                                  ctx)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok[:, 0].cpu().numpy())
    t_decode = time.perf_counter() - t0
    toks = np.stack(out, 1)
    if mesh is None or mesh.rank == 0:
        print(f"arch={cfg.name} batch={args.batch} "
              f"prompt={args.prompt_len} gen={args.gen}")
        print(f"prefill: {t_prefill*1e3:.0f} ms "
              f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
        print(f"decode : {t_decode*1e3:.0f} ms "
              f"({args.batch*args.gen/t_decode:.1f} tok/s)")
        print("sample tokens:", toks[0][:16])
    return dict(tokens=toks, prefill_s=t_prefill, decode_s=t_decode,
                cfg=cfg, params=params, cache=cache)


def main(argv=None) -> np.ndarray:
    return run(parse_args(argv))["tokens"]


if __name__ == "__main__":
    main()
