"""Training launcher: the loop with checkpoint/resume and straggler
monitoring, as ``repro.launch.train`` runs it, on one device or over a
mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir CKPT \
        [--mesh 2x2] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given (no card and no
``--device cpu`` raises).  Restarting the same command resumes from the
latest valid checkpoint under ``--ckpt-dir``, the token stream included
(the checkpoint carries its state), on the same ``--mesh`` or another:
reshard-on-restore.  The checkpoints are in the reference's format, so
either package resumes the other's.  The weights are random, drawn from a
torch generator seeded ``--seed`` on the device (the reference draws its
own from ``jax.random.key(seed)``); the token stream is the reference's,
batch for batch.

``--mesh`` names the reference's mesh: ``auto`` is (n/2, 2) over the n
cards (one card, or ``--device cpu``: one device), ``2x2`` and the like
are explicit.  A mesh of several devices spawns one process a rank
(``launch.mesh.run_ranks``): gloo where ranks share a card or run on the
CPU, NCCL with a card a rank.  Every rank draws the same weights and
keeps its blocks (its moments beside them, ZeRO-3), takes the whole
batch of the stream and computes its rows (``train.steps``), and saves
its blocks into one checkpoint that rank 0 writes; rank 0 prints the
lines.  A rank that fails fails the run: nothing falls back to one
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --reduced --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import math
from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.pipeline import check_device
from repro_torch.data.tokens import TokenStream, TokenStreamState
from repro_torch.launch.mesh import (_check_backend, make_mesh, parse_mesh,
                                     run_ranks)
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import steps as steps_lib
from repro_torch.train.monitor import StepMonitor

# a spawned mesh's whole run, set-up included, before run_ranks gives up
RANK_TIMEOUT_S = 3600.0


def mesh_shape(spec: str, n_devices: int) -> Dict[str, int]:
    """The mesh ``--mesh`` names, as the reference prints it (its axes and
    sizes)."""
    if spec == "auto":
        dims = (1, 1) if n_devices == 1 else (n_devices // 2, 2)
        return dict(zip(("data", "model"), dims))
    dims = tuple(int(x) for x in spec.split("x"))
    return dict(zip(("pod", "data", "model")[-len(dims):], dims))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--mesh", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> Dict:
    """The launcher: prints the reference's lines and returns the final
    parameters and optimizer state, the metrics of every step run
    (floats), the step times and the monitor.  On a mesh of several
    devices it spawns the ranks (each runs ``train_rank``) and returns
    rank 0's metrics and times, and every rank's (``ranks``): no
    parameters."""
    device = check_device(args.device)
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    spec = parse_mesh(args.mesh, n_devices)
    if spec is None:
        return train(args, None)
    shape, axes = spec
    world = math.prod(shape)
    backend = _check_backend(device, None, world)
    ranks = run_ranks(train_rank, world, args, shape, axes, backend=backend,
                      timeout=RANK_TIMEOUT_S)
    return dict(ranks[0], ranks=ranks)


def train_rank(args: argparse.Namespace, shape, axes) -> Dict:
    """One rank of a mesh (spawned by ``run``): the launcher's body on the
    rank's mesh; its metrics, step times, ``Mesh.stats``, backend and peak
    device memory (picklable)."""
    mesh = make_mesh(shape, axes, device=args.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    res = train(args, mesh)
    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else None)
    return dict(history=res["history"], times=res["times"],
                start_step=res["start_step"],
                rank=mesh.rank, backend=mesh.backend,
                device=str(mesh.device), stats=dict(mesh.stats),
                peak_bytes=peak)


def train(args: argparse.Namespace, mesh) -> Dict:
    """The launcher's body on one device (``mesh`` None) or on this rank of
    ``mesh``; rank 0 alone prints."""
    device = mesh.device if mesh is not None else check_device(args.device)
    lead = mesh is None or mesh.rank == 0
    say = ((lambda *a: print(*a, flush=True)) if lead
           else (lambda *a: None))
    # exact f32 products and f32 reductions in cuBLAS, as the reference's
    # dots accumulate
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if mesh is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    else:
        n_devices = mesh.size
    say(f"arch={cfg.name} devices={n_devices} "
        f"mesh={mesh_shape(args.mesh, n_devices)}")

    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                            total_steps=args.steps)
    _, jit_for, sh = steps_lib.make_train_step(cfg, mesh, adamw)
    shards = None if mesh is None else (sh["params"], sh["opt"])
    shape = ShapeSpec("train", args.seq, args.batch, "train")
    fn = jit_for(steps_lib.make_batch_abstract(cfg, shape))

    # init or resume
    start_step = 0
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed,
                         n_ctx=cfg.n_ctx_tokens, d_model=cfg.d_model)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        params_abs = M.abstract_params(cfg)
        state_abs = (params_abs, opt.abstract_state(params_abs))
        (params, opt_state), start_step, ds, _ = ckpt.restore(
            args.ckpt_dir, state_abs, device=device, shardings=shards)
        stream.state = TokenStreamState.from_dict(ds)
        say(f"resumed from step {start_step}")
    else:
        params = M.init_params(
            cfg, torch.Generator(device).manual_seed(args.seed), device, mesh)
        opt_state = opt.init_state(params)

    mon = StepMonitor(on_straggler=lambda ev: say(
        f"[straggler] step={ev.step} {ev.step_time:.2f}s = {ev.ratio:.1f}x ema"))
    tokens_per_step = args.batch * args.seq
    history, times, metrics = [], [], None
    for step in range(start_step, args.steps):
        batch = steps_lib.device_batch(stream.next_batch(), device)
        mon.start()
        params, opt_state, metrics = fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}   # a host sync
        dt = mon.stop()
        history.append(metrics)
        times.append(dt)
        if (step + 1) % args.log_every == 0 or step == start_step:
            say(f"step {step+1:5d} loss={metrics['loss']:.4f} "
                f"gnorm={metrics['grad_norm']:.2f} "
                f"{dt:.2f}s {mon.tokens_per_sec(tokens_per_step):.0f} tok/s")
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, (params, opt_state),
                      data_state=stream.state.as_dict(), shardings=shards)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (params, opt_state),
                  data_state=stream.state.as_dict(), shardings=shards)
    final = metrics["loss"] if metrics else math.nan
    say(f"done: {args.steps} steps, final loss "
        f"{final:.4f}, stragglers={len(mon.events)}")
    _sync(device)
    return dict(params=params, opt_state=opt_state, history=history,
                times=times, monitor=mon, cfg=cfg, start_step=start_step)


def main(argv=None):
    """The launcher; returns the final parameters (None from a mesh of
    several devices: each rank held its blocks)."""
    return run(parse_args(argv)).get("params")


if __name__ == "__main__":
    main()
