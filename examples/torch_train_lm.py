"""End-to-end driver through the PyTorch/CUDA port: train a ~100M-param
qwen2-family LM.

    PYTHONPATH=src python examples/torch_train_lm.py            # ~100M, 300 steps
    PYTHONPATH=src python examples/torch_train_lm.py --quick    # CI-scale
    PYTHONPATH=src python examples/torch_train_lm.py --quick --steps 80 --resume

The twin of ``examples/train_lm.py`` through ``repro_torch`` only.
Exercises the full production path: config -> init (params from a
seeded ``torch.Generator``) -> train step -> fault-tolerant loop with
async checkpoints -> resume: a fresh state restored from the last
checkpoint equals the trained one, and ``--resume`` continues from the
latest checkpoint in ``--ckpt-dir`` at its data cursor.  On several ranks the
same step runs on a mesh (``repro_torch.launch.train --model-axis``);
the --quick preset keeps it to a couple of minutes on a CPU.  Without
``--device`` it runs on the CUDA device and raises when there is none.
"""

import argparse
import os
import tempfile
import time


def lm_100m():
    """~100M params: qwen2-style dense decoder."""
    from repro_torch.models.config import LMConfig
    return LMConfig(
        name="lm-100m", family="dense",
        num_layers=10, d_model=640, num_heads=10, num_kv_heads=2,
        head_dim=64, d_ff=2560, vocab_size=32000,
        qkv_bias=True, tie_embeddings=True, rope_theta=1e6, ce_chunk=128,
    )


def lm_10m():
    from repro_torch.models.config import LMConfig
    return LMConfig(
        name="lm-10m", family="dense",
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=1024, vocab_size=8192,
        qkv_bias=True, tie_embeddings=True, rope_theta=1e6, ce_chunk=64,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.engine import resolve_device
    from repro_torch.launch.cluster import StepGuard, run_resilient
    from repro_torch.launch.specs import train_batch
    from repro_torch.models import count_params, init_params
    from repro_torch.train import (TrainCfg, get_optimizer, init_state,
                                   make_train_step, warmup_cosine)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import flatten

    dev = resolve_device(args.device)
    cfg = lm_10m() if args.quick else lm_100m()
    steps = args.steps or (60 if args.quick else 300)
    batch = args.batch or (8 if args.quick else 16)
    seq = args.seq_len or (128 if args.quick else 512)

    n = count_params(cfg)
    print(f"model {cfg.name}: {n/1e6:.1f}M params, "
          f"{steps} steps @ batch {batch} x seq {seq} on {dev}")

    tcfg = TrainCfg(optimizer="adamw", peak_lr=3e-3,
                    warmup_steps=max(steps // 10, 1), total_steps=steps)
    opt = get_optimizer(tcfg.optimizer)
    lr_fn = warmup_cosine(tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps)
    step_fn = make_train_step(cfg, tcfg, opt, lr_fn)

    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = init_state(cfg, tcfg, opt, params)
    resumed = None
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        state, extra = ckpt.restore(args.ckpt_dir, state, device=dev)
        if "pipeline" in extra:
            pipe = TokenPipeline.from_state(cfg.vocab_size, seq, batch,
                                            extra["pipeline"])
        resumed = int(state["step"])
        print(f"resumed at step {resumed}")

    t0 = time.time()
    losses = []

    def on_metrics(i, m):
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"tok/s {batch * seq * len(losses) / (time.time() - t0):,.0f}",
                  flush=True)

    def next_batch():
        return train_batch(cfg, pipe.next_batch()["tokens"], dev)

    state, ran = run_resilient(
        state, step_fn, next_batch, ckpt_dir=args.ckpt_dir,
        num_steps=steps, ckpt_every=max(steps // 5, 10),
        guard=StepGuard(factor=100.0),
        pipeline_state=lambda: {"pipeline": pipe.state()},
        on_metrics=on_metrics)

    print(f"finished {ran} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss did not decrease"

    # resume: what a restarted process does -- a fresh state restored
    # from the latest checkpoint equals the trained one bit for bit, and
    # the pipeline picks up at the saved cursor
    fresh = init_state(cfg, tcfg, opt, init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), dev))
    back, extra = ckpt.restore(args.ckpt_dir, fresh, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(flatten(back)[0],
                                                 flatten(state)[0]))
    cursor = TokenPipeline.from_state(cfg.vocab_size, seq, batch,
                                      extra["pipeline"]).state()
    print(f"resumed from the checkpoint at step {int(back['step'])}: "
          f"params and optimizer state equal to the trained ones: {same}; "
          f"data cursor equal: {cursor == pipe.state()}")
    assert same and int(back["step"]) == steps and cursor == pipe.state()
    return dict(device=str(dev), ran=ran, step=int(state["step"]),
                resumed=resumed, losses=losses, restored_equal=same)


if __name__ == "__main__":
    main()
