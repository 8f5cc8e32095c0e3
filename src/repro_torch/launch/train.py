"""Training driver: ``python -m repro_torch.launch.train --arch <id> ...``

The reference's driver (``repro.launch.train``) with its flags: builds
the model and the train step from the launch specs (``model_cfg_for``,
``train_cfg_for``), then drives the fault-tolerant loop (checkpoint /
restart, straggler guard, heartbeat) of ``launch.cluster`` on
``TokenPipeline`` batches.  Params come from a seeded generator (seed
0).  Without ``--device`` it runs on the CUDA device and raises when
there is none.  After a restore inside the loop the pipeline resumes at
the restored checkpoint's cursor.

On several ranks (``torchrun``, or a process group the caller started)
it trains on the mesh ``make_host_mesh(--model-axis)`` of shape
``(world / M, M)``: the activation policy of ``launch.sharding`` is
installed, as the reference's launcher does; the params and the optimizer
state are ``DTensor`` s placed by ``param_shardings`` /
``state_shardings`` (FSDP x TP storage); each batch is sharded over
'data'; the step is ``make_train_step``'s FSDP x TP form, its compute
split over 'model' (``models/tensor_parallel.py``).  The process group
is NCCL on the card and gloo on the CPU; rank 0 prints and writes the
checkpoints, from whole tensors, so either package restores them.
``--model-axis`` other than 1 without a process group raises.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="TP axis size of the host mesh")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from ..data.tokens import TokenPipeline
    from ..engine.adaptive import resolve_device
    from ..models import init_params
    from ..train import (get_optimizer, init_state, make_train_step,
                         warmup_cosine)
    from ..train import checkpoint as ckpt
    from ..models import sharding_ctx
    from . import sharding as shd
    from .cluster import Heartbeat, StepGuard, run_resilient
    from .mesh import init_world, make_host_mesh
    from .specs import model_cfg_for, train_cfg_for, train_batch

    dev = resolve_device(args.device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dev = init_world("nccl" if dev.type == "cuda" else "gloo",
                         device=args.device)
    if not dist.is_initialized() and args.model_axis != 1:
        raise ValueError(f"--model-axis {args.model_axis} needs a process "
                         "group: run it under torchrun")
    mesh = (make_host_mesh(args.model_axis, dev.type)
            if dist.is_initialized() else None)
    rank = dist.get_rank() if mesh is not None else 0
    cfg = model_cfg_for(args.arch, smoke=args.smoke)
    tcfg = train_cfg_for(args.arch)
    if args.optimizer:
        tcfg = dataclasses.replace(tcfg, optimizer=args.optimizer)
    if args.microbatches:
        tcfg = dataclasses.replace(tcfg, microbatches=args.microbatches)
    tcfg = dataclasses.replace(tcfg, peak_lr=args.lr,
                               total_steps=args.steps,
                               warmup_steps=max(args.steps // 10, 1))

    opt = get_optimizer(tcfg.optimizer)
    lr_fn = warmup_cosine(tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps)
    step_fn = make_train_step(cfg, tcfg, opt, lr_fn, mesh=mesh)

    pipe = TokenPipeline(cfg.vocab_size, args.seq_len, args.batch, seed=0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = init_state(cfg, tcfg, opt, params)
    if mesh is not None:
        sharding_ctx.set_policy(shd.activation_specs(cfg, mesh))
        state = shd.place_tree(state, shd.state_shardings(cfg, mesh, state))
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state, extra = ckpt.restore(args.ckpt_dir, state, device=dev)
        if "pipeline" in extra:
            pipe = TokenPipeline.from_state(
                cfg.vocab_size, args.seq_len, args.batch, extra["pipeline"])
        if rank == 0:
            print(f"resumed from step {int(state['step'])}")

    def on_restore(extra):
        nonlocal pipe
        if "pipeline" in extra:
            pipe = TokenPipeline.from_state(
                cfg.vocab_size, args.seq_len, args.batch, extra["pipeline"])

    hb = Heartbeat(args.ckpt_dir, host_id=rank)
    t0 = time.time()
    losses = []

    def on_metrics(i, m):
        hb.beat()
        losses.append(float(m["loss"]))
        if i % args.log_every == 0 and rank == 0:
            dt = time.time() - t0
            toks = args.batch * args.seq_len * i
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  grad_norm "
                  f"{float(m['grad_norm']):.3f}  tok/s {toks / dt:,.0f}",
                  flush=True)

    def next_batch():
        batch = train_batch(cfg, pipe.next_batch()["tokens"], dev)
        if mesh is None:
            return batch
        return shd.place_tree(batch, shd.batch_shardings(cfg, mesh, batch))

    state, ran = run_resilient(
        state, step_fn, next_batch, ckpt_dir=args.ckpt_dir,
        num_steps=args.steps, ckpt_every=args.ckpt_every,
        guard=StepGuard(factor=50.0),
        pipeline_state=lambda: {"pipeline": pipe.state()},
        on_metrics=on_metrics, on_restore=on_restore)
    if rank != 0:
        return
    if not losses:
        print(f"done: {ran} steps (already at step {int(state['step'])})")
        return
    print(f"done: {ran} steps, final loss {losses[-1]:.4f} "
          f"(first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
