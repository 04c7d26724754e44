"""Training launcher: the loop with checkpoint/resume and straggler
monitoring, as ``repro.launch.train`` runs it, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir CKPT \
        [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given (no card and no
``--device cpu`` raises).  Restarting the same command resumes from the
latest valid checkpoint under ``--ckpt-dir``, the token stream included
(the checkpoint carries its state).  The checkpoints are in the reference's
format, so either package resumes the other's.  The weights are random,
drawn from a torch generator seeded ``--seed`` on the device (the
reference draws its own from ``jax.random.key(seed)``); the token stream
is the reference's, batch for batch.
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
from repro_torch.launch.mesh import AbstractMesh, parse_mesh
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import steps as steps_lib
from repro_torch.train.monitor import StepMonitor


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
    """The launcher's body: prints the reference's lines and returns the
    final parameters and optimizer state, the metrics of every step run
    (floats), the step times and the monitor."""
    device = check_device(args.device)
    # exact f32 products and f32 reductions in cuBLAS, as the reference's
    # dots accumulate
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    spec = parse_mesh(args.mesh, n_devices)
    # a mesh of several devices: make_train_step refuses it (next slice)
    mesh = None if spec is None else AbstractMesh(*spec)
    print(f"arch={cfg.name} devices={n_devices} "
          f"mesh={mesh_shape(args.mesh, n_devices)}")

    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                            total_steps=args.steps)
    _, jit_for, sh = steps_lib.make_train_step(cfg, mesh, adamw)
    shape = ShapeSpec("train", args.seq, args.batch, "train")
    fn = jit_for(steps_lib.make_batch_abstract(cfg, shape))

    # init or resume
    start_step = 0
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed,
                         n_ctx=cfg.n_ctx_tokens, d_model=cfg.d_model)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state_abs = (sh["params"], sh["opt"])
        (params, opt_state), start_step, ds, _ = ckpt.restore(
            args.ckpt_dir, state_abs, device=device)
        stream.state = TokenStreamState.from_dict(ds)
        print(f"resumed from step {start_step}")
    else:
        params = M.init_params(
            cfg, torch.Generator(device).manual_seed(args.seed), device)
        opt_state = opt.init_state(params)

    mon = StepMonitor(on_straggler=lambda ev: print(
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
            print(f"step {step+1:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.2f} "
                  f"{dt:.2f}s {mon.tokens_per_sec(tokens_per_step):.0f} tok/s")
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, (params, opt_state),
                      data_state=stream.state.as_dict())
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (params, opt_state),
                  data_state=stream.state.as_dict())
    final = metrics["loss"] if metrics else math.nan
    print(f"done: {args.steps} steps, final loss "
          f"{final:.4f}, stragglers={len(mon.events)}")
    _sync(device)
    return dict(params=params, opt_state=opt_state, history=history,
                times=times, monitor=mon, cfg=cfg, start_step=start_step)


def main(argv=None):
    return run(parse_args(argv))["params"]


if __name__ == "__main__":
    main()
