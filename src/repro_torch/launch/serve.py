"""Serving loop: batched prefill + greedy decode.

``python -m repro_torch.launch.serve --arch <id> [--smoke] [--device cpu]``
(``<id>`` any arch of the registry: qwen2-1.5b, qwen1.5-0.5b,
stablelm-3b, gemma2-27b, mixtral-8x7b, arctic-480b, zamba2-2.7b,
rwkv6-3b, whisper-small, internvl2-1b) serves a few requests from
randomly initialised weights (``launch.specs.model_cfg_for``: arctic's
params in bfloat16 outside ``--smoke``): requests arrive with different
prompt lengths, get left-padded into a batch of ``--batch-slots`` rows,
are prefilled once (through the flash-attention kernel: the entry point
sets ``use_flash_kernel``), then decoded step by step with argmax.  The
loop is the reference's (``repro.launch.serve``), kept as it is: prompts
are left-padded with token 0 and no padding mask, every row of a batch
shares one cache position, decoding is greedy, and the stub frontends
get zeros: whisper ``frames [B, enc_seq, d]``, internvl2 ``patches [B,
num_patches, d]`` ahead of the prompt (its cache holds ``max_len +
num_patches`` positions).
Without ``--device`` it runs on the CUDA device and raises when there is
none.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..engine.adaptive import resolve_device
from ..models import decode_step, init_cache, init_params, prefill
from ..models.config import LMConfig
from ..models.layers import dtype_of
from .specs import model_cfg_for


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)


def _pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (prefill shapes bucket to pow2, as in
    the reference, whose jit cache converges that way)."""
    return 1 << max(0, int(n) - 1).bit_length()


def serve_requests(cfg: LMConfig, params: dict, requests: List[Request], *,
                   batch_slots: int, max_len: int, device=None,
                   stats: Optional[dict] = None) -> List[Request]:
    """Serve ``requests`` in arrival order, ``batch_slots`` at a time.

    Each batch is left-padded to a power-of-two length, prefilled (with
    :func:`stub_inputs`) into a fresh cache of ``max_len`` positions (vlm:
    plus ``num_patches``), then decoded for the batch's
    largest ``max_new`` minus one steps; a request keeps its first
    ``max_new`` tokens.  Returns the served requests (their ``out``
    filled).  ``stats``, when given, receives per batch the prefill
    seconds and length and per decode step its seconds (host clock; each
    ends in reading the step's tokens back to the host)."""
    dev = resolve_device(device)
    reqs = list(requests)
    B = batch_slots
    done: List[Request] = []
    if stats is not None:
        stats.update(prefill_s=[], prefill_len=[], decode_s=[])
    while reqs:
        active = reqs[:B]
        reqs = reqs[B:]
        # left-pad prompts to a common pow2-bucketed length -> one
        # batched prefill per bucket
        plen = _pow2_at_least(max(len(r.prompt) for r in active))
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(active):
            toks[i, plen - len(r.prompt):] = r.prompt
        t0 = time.perf_counter()
        cache = init_cache(cfg, B, cache_len(cfg, max_len), dev)
        logits, cache = prefill(cfg, params,
                                {"tokens": torch.from_numpy(toks).to(dev),
                                 **stub_inputs(cfg, B, dev)}, cache)
        cur = torch.argmax(logits, dim=-1)
        cur_host = cur.cpu().numpy()
        if stats is not None:
            stats["prefill_s"].append(time.perf_counter() - t0)
            stats["prefill_len"].append(plen)
        for r, t in zip(active, cur_host):
            r.out.append(int(t))
        # decode until every slot hit its max_new (slots simply retire)
        for _ in range(max(r.max_new for r in active) - 1):
            t0 = time.perf_counter()
            logits, cache = decode_step(cfg, params, cur, cache)
            cur = torch.argmax(logits, dim=-1)
            cur_host = cur.cpu().numpy()
            if stats is not None:
                stats["decode_s"].append(time.perf_counter() - t0)
            for i, r in enumerate(active):
                if len(r.out) < r.max_new:
                    r.out.append(int(cur_host[i]))
        done.extend(active)
    return done


def stub_inputs(cfg: LMConfig, batch: int, device) -> dict:
    """The reference CLI's stub frontend inputs, zeros in ``cfg.dtype``:
    whisper's audio frame embeddings, internvl2's patch embeddings."""
    n = {"encdec": ("frames", cfg.enc_seq),
         "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if n is None:
        return {}
    return {n[0]: torch.zeros((batch, n[1], cfg.d_model),
                              dtype=dtype_of(cfg.dtype), device=device)}


def cache_len(cfg: LMConfig, max_len: int) -> int:
    """Cache positions for prompts plus new tokens of ``max_len``: a vlm's
    patches take ``num_patches`` more."""
    return max_len + (cfg.num_patches if cfg.family == "vlm" else 0)


def cli_requests(cfg: LMConfig, num_requests: int,
                 max_new: int) -> List[Request]:
    """The reference CLI's traffic: prompts of 4 - 16 tokens drawn from
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [Request(i, list(rng.integers(0, cfg.vocab_size,
                                         size=rng.integers(4, 17))),
                    max_new)
            for i in range(num_requests)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_cfg_for(args.arch, smoke=args.smoke).with_overrides(
        use_flash_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    reqs = cli_requests(cfg, args.num_requests, args.max_new)

    t0 = time.time()
    done = serve_requests(cfg, params, reqs, batch_slots=args.batch_slots,
                          max_len=args.max_len, device=dev)
    dt = time.time() - t0
    tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")


if __name__ == "__main__":
    main()
