#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--n 1000000] [--seed 0] [--baseline-pairwise PATH]

Needs one CUDA device and ``nvcc``; imports nothing of JAX.  Prints one
JSON object per line, one per phase, and fails (non-zero exit, no
result line) as soon as a phase fails:

  env      torch / CUDA versions, the card's name and power limit
  build    compiles the CUDA kernels of ``repro_torch/kernels/csrc``
  fit      ``cluster(points, eps, min_pts, engine="device-kernels")`` on
           the blobs-3d generator at ``--n`` integer-rounded points
           (MinPts 64, eps by the catalogue's scaling rule): the host
           cap estimate timed alone, the counted main-path run (cold),
           a warm run on the final caps, and a
           run with per-stage timing during which the largest kernel
           call of every candidate width is captured
  kernels  every kernel wrapper against its plain PyTorch version on the
           card: on the captured main-path inputs, on ragged shapes, on
           integer lattices (counts and argmins must be equal) and on
           random reals (d2 within rtol 1e-6), and on the edge shapes of
           the warp-per-slot distance kernels (rows around the lane
           counts, unaligned slabs, 50,000 slots, dead slots between live
           ones, rows saturating stop_at at different candidates, ties
           across phase boundaries, ragged unbatched slots, d = 7);
           eager times (CUDA events around wrapper calls) beside the
           least time the card could take for the same work (with
           stop_at, the work the exit leaves) and, for the
           distance kernels, device times of CUDA-graph replays over
           copies of the operands that exceed the L2 cache
           (``graph_ms``) and an instruction-count estimate of the
           issue-rate floor of their exact arithmetic (``floor_ms``); the
           staging route of each case and the registers and spills of
           every kind of the distance kernel (it fails on a spill at
           d = 3); with ``--baseline-pairwise PATH`` that build of
           ``pairwise.cu`` timed both ways beside this one, in turns
           (``parent_ms``, ``parent_graph_ms``)
  check    (a) engine "device" (plain plane) gives equal labels and core
           flags; (b) the same generator at n = 20,000 conformant to the
           port's brute engine
  serve    the fitted index on the same data: ``cluster(...,
           return_index=True)`` (fit and attach timed apart), eight
           batches of 2,048 mixed queries in each predict mode (device
           equal to host bit for bit, kernel equal to host on every
           decidable query, host held to the nearest-core rule in float64
           on the card), ``MUTATION_STEPS`` = 2 steps of 85 % predict /
           10 % insert / 5 % delete on a host-serving index and a
           device-resident twin (equal after every step) and a third with
           the resident stages' gates at 0, each stage's flat-gather and host-twin runs
           counted, and a snapshot round trip
  brute    the chunked float64 brute DBSCAN on the card
           (``core/validate.py::check_conformant_brute``: torch
           primitives only, nothing of the code under test, no
           tolerance) over (a) the cold fit of phase ``fit``, every one
           of its points, and (b) the device-plane index after the last
           mutation step of phase ``serve``, over its live points,
           labels and core flags: core flags equal, the core partition
           identical, noise sets identical, every border valid, labels
           equal on every uncontested point; each check's pairs per
           sweep, core-core pairs, propagation rounds, contested points
           and seconds per stage.  The sharded and mesh fits are held
           raw-equal to the single-device fit on the card (phases
           ``sharded`` and ``mesh``), so (a) covers them too; no kernel
           is launched
  server   the serve phase's index through ``snapshot()``, restored
           twice, behind two ``ClusterServer``s (8 slots of 2,048
           queries) on one scripted stream from ``--seed``: 48 predict
           requests of log-uniform 1 - 2,048 ``_queries_mixed`` queries,
           two inserts of 204 points and a delete of 104 live arrival
           ids at fixed positions.  A serves in device mode on a
           resident state, B in kernel mode from a read replica that
           catches up from B's mutation log (B must launch
           ``row_min_batch``; its largest call is held against the plain
           version).  Tracing is on for that run: the labels of every
           predict request equal between A and B, the replica's state
           equal to its primary's and the two planes equal, the
           ``serve.step.*`` and ``delta.*`` spans recorded, and per
           server the steps, latency percentiles, queries/s, slot fill,
           the step log's kernel / pack seconds, the growth events and
           the attribution of ``serve.step`` to its children; the Chrome
           trace goes to ``build/chip_smoke_server_trace.json``.  Then
           the stream's predicts again on A with tracing off (no event
           recorded) and on, their median step seconds side by side
  syncs    the port's invariant linter (``repro_torch.analysis``) over
           ``src/repro_torch`` on this machine: clean, its active (0) and
           suppressed findings per rule; then phase ``server``'s stream
           once more through fresh servers A and B (restores of the same
           snapshot, tracing off) under
           ``torch.cuda.set_sync_debug_mode("warn")``: each sync's site
           (the innermost frame under ``src/repro_torch``), the syncs per
           server step and per 2,048-query predict batch, the labels of
           every predict request equal to phase ``server``'s, and
           ``missed``, the runtime sites that the static
           ``hot-path-sync`` rule does not report (active or
           suppressed), which must be empty
  sharded  the fit's points in ``SHARDS`` = 4 slab shards on the one card:
           ``cluster(..., engine="distributed", n_shards=4)`` cold (the
           path's first counted run), warm with the final caps, staged
           under tracing (``halo_exchange`` / ``local_cluster``, each
           shard's pipeline timed apart / ``reconcile``), and on the plain
           plane (labels, core flags, grid rows and owning shards equal
           to the kernel plane's); held to the single-device fit (core
           flags equal, the core points' partition equal, every other
           label equal under the partition map or a contested border,
           recomputed in float64 on the card); ``fit_sharded(...,
           engine="distributed")`` served the serve phase's mixed batches
           and eight of ``_queries_slab_band`` in host and kernel mode
           (host held to the float64 rule over every core, kernel equal
           to host on every decidable query, single-label answers equal
           to the unsharded index's under the partition map); the first
           two steps of the serve phase's mutation stream on the sharded
           index and on the unsharded one restored from the serve phase's
           snapshot before its stream, a split of the fullest shard and a
           merge of the emptiest adjacent pair, the same checks again, a
           snapshot round trip; last, the stream's third step, then
           server C (kernel mode, ``RebalancePolicy(period=4)``) on phase
           ``server``'s stream (the path's second counted run), each
           request's labels equal to server A's as a partition and the
           index equal to A's after it.  The path's launches are those
           two runs', each with the counts set to 0 just before it and
           read just after; the fit must launch both distance kernels,
           server C ``row_min_batch``
  mesh     one process per rank (``launch.mesh.spawn_ranks``: spawned
           processes, a ``FileStore`` under the git-ignored ``build/``,
           every rank killed and the script failed past its time limit);
           the kernels were built before, so the ranks only load them.
           One line a part: ``fit``, the sharded phase's points on
           ``MESH_RANKS`` = 4 gloo ranks of a 2 x 2 ``DeviceMesh`` on
           the one card (host staging of every collective), each rank
           running its slab through the kernel plane with phase
           sharded's final caps, every rank's result raw-equal to phase
           sharded's in-process 4-shard fit; each rank's cold (counted:
           launches, bytes each move sent) and warm seconds; then one
           NCCL rank per card through ``cluster(engine="distributed",
           mesh=...)``, its core flags, core partition and noise equal to
           the single-device fit's and every other differing label a
           contested border; ``moe``, mixtral-8x7b's MoE block at its
           published width (d 4,096, ff 14,336, 8 experts, top-2) on 4 x
           256 tokens in float32 and bfloat16, both explicit-collective
           variants on the gloo 2 x 2 and the NCCL mesh, held to
           ``moe_forward`` at capacity factor E / K (nothing dropped):
           within 1e-4 (float32) / 3e-2 (bfloat16) of the largest |y|;
           ``train``, qwen2-1.5b at its published width, 2 of 28 layers
           (``reduced``), float32, on the NCCL mesh with DTensor state:
           two steps of 8 x 512 tokens equal to two single-device steps
           (loss within 1e-4, params within rtol 2e-4 + atol 1e-5);
           ``tp``, tensor-parallel compute on the gloo 2 x 2 mesh (in the
           fit's spawn): qwen2-1.5b at its published width, 2 of 28
           layers, two float32 TP train steps of 8 x 512 tokens against
           two single-device steps: the losses within 1e-4, the first
           step's gradients within 1e-4 of each leaf's largest |g|, the
           params after both steps within rtol 2e-4 + atol 1e-5 on every
           entry whose first-step |g| exceeds 1e-5 (AdamW normalises each
           entry, so one whose gradient is near 0 moves by up to lr with
           the summation order); a bfloat16 prefill of 4 x 2,048 tokens
           plus 4 decode steps with the flash kernel on each rank's 6
           local heads and 1 KV head, the ranks' last-position logits
           within 3e-2 of the largest |logit| of a single-device run with
           plain attention; per rank the step and prefill seconds, the
           bytes each move sent, the peak memory, and flash at a rank's
           own call [2, 6 (1 KV), 2,048, 2,048, 128] (the 4 prompts split
           over 'data') timed in turns against its bound and SDPA's time
           (the flash launches of the TP prefills are the path's, counted
           in each rank with the counts set to 0 just before its
           prefill); then, on a 1 x 4 mesh over the same ranks, through
           ``prefill_on_mesh`` / ``decode_on_mesh`` on placed params,
           batch and cache: qwen2-1.5b (``MESH_SEQ_LAYERS`` = 14 of 28
           layers, in ``reduced``) in
           bfloat16 with flash, a 4 x 2,048 prefill plus 4 decode steps
           over a cache of 2,064 positions whose sequence is sharded
           over 'model' (its 2 KV heads do not split 4 ways: 516
           positions a rank, a decode step's attention split over them),
           and rwkv6-3b, whisper-small and zamba2-2.7b at their published
           widths (rwkv6 8 of 32 layers and zamba2 12 of 54, in
           ``reduced``: ``MESH_FAMILIES``), a 2 x 256 prefill plus 2 decode
           steps each (whisper under seeded frames): every rank's logits
           within 3e-2 of the largest |logit| of one device's run with
           plain attention, the returned cache the placed tree itself, no
           decode all-gather of a local KV cache leaf (a dispatch mode over
           the ``_c10d_functional`` ops), flash on
           the rank's heads at the calls of ``MESH_SEQ_FLASH`` /
           ``MESH_FAMILY_FLASH`` (rows in phase ``flash``); per rank and
           model the seconds, the bytes each move sent, the cache leaves'
           local shapes and the peak memory;
           ``dryrun``, ``dryrun.run_cell`` of qwen2-1.5b x train_4k on
           16 x 16 and 2 x 16 x 16 and of mixtral-8x7b x decode_32k with
           ``moe_alltoall`` on 16 x 16 over a fake process group: per-rank
           param bytes equal to ``param_pspec``'s, collectives counted;
           and ``dryrun.run_cluster_cell`` on both meshes: rank 1's
           distributed GriT-DBSCAN step on a seeded 4,096-point shard on
           the card (kernel plane, caps grown until the report is clean),
           counted: the counted permute equal to the bytes the halo
           exchange sent, collectives counted, each distance kernel's
           counted FLOPs equal to 3·d per (row, candidate) slot summed
           over its counted calls, both kernels launched
  guard_band  the two guard-band kernels (the same warp-per-task kernel
           as the distance kernels, kinds band and min2) against their
           plain versions on the largest kernel-mode predict call, on the
           fit's captured ``eps_count_batch`` inputs with the served
           index's band thresholds (with and without the per-row MinPts
           bar), on integer lattices and on the edge shapes of phase
           ``kernels`` with and without bars (equal), and on random
           reals (a row whose bar is <= 0 must count 0); at the predict
           call and at every fit width (with and without the bar)
           ``ms``, ``graph_ms`` and ``floor_ms`` as in phase
           ``kernels``, bound and floor with the bar counting the (row,
           candidate) pairs each row needs to reach it (``pairs``), and
           with ``--baseline-pairwise`` that build's ``parent_ms`` /
           ``parent_graph_ms``
  flash    the flash-attention kernel against its plain version (float32
           within 2e-4; bfloat16 within 2^-7·|want| + 1e-4 elementwise,
           one bf16 ulp of the output; both with a mean error under 1e-3
           of the mean |want|) at the LM path's shapes
           (qwen2-1.5b prefill with its 2 KV heads read in place and
           after a broadcast to 12, 8,192-token prefill, gemma2's
           windowed soft-capped layer, mixtral's 8,192-token prefill with
           its 4,096 window on 8 KV heads, and the families phase's
           prefill calls of its batch of 4 x 2,048: mixtral's, arctic's
           and zamba2's; whisper-small's encoder self-attention over
           1,500 frames and its cross-attention of a 256-token bucket to
           them, both non-causal, a cross-attention with more queries
           than keys, and internvl2-1b's prefill of 256 patches + 2,048
           tokens on 2 KV heads) and at ragged, non-causal, decode,
           chunked-prefix and small-head shapes; each case's route
           (``wgmma`` for bf16, ``scalar`` for float32) as the library
           reports it; CUDA-event times beside the bound and, where one
           call computes the same function,
           ``F.scaled_dot_product_attention`` (``vs_library`` = ms over
           its ms; where a window binds, the library call is dense
           masked SDPA, and ``library_causal_ms`` times causal SDPA over
           the same tokens beside it); the bf16 head-dim-128 kernel's
           registers and spills as ptxas reported them and its HGMMA
           count in the SASS
  lm       qwen2-1.5b at full width (float32 params from a seeded
           generator, bfloat16 activations) served through
           ``launch.serve.serve_requests`` with the flash kernel: (a) the
           reference CLI's traffic (8 requests of 4 - 16 tokens, 4 slots,
           16 new tokens), (b) 4 prompts of 1,500 - 2,048 tokens and one
           of 8,192; 28 flash launches per prefill; then one prefill of
           (b) again with the plain attention path (last-position logits
           within 3e-2 of the largest logit in bfloat16, 1e-3 in float32
           at 4 layers), the flash prefill making no broadcast copy of
           the KV heads; last, (b)'s two batches prefilled again warm, three
           timed calls and one under ``torch.profiler`` (device ms of all
           kernels and of the flash kernel, the device's idle share)
  families the other families at their published widths, one line
           each, each model freed before the next: mixtral-8x7b (8 of 32
           layers, float32 params), arctic-480b (2 of 35 layers, bfloat16
           params), zamba2-2.7b (12 of 54 layers) and rwkv6-3b (8 of
           32; both cut for the script's wall time), whisper-small and
           internvl2-1b (all layers), float32 params, the depth cut
           otherwise only where one 80 GB card forces it (``reduced``);
           params from a seeded
           generator, bfloat16 activations, served through
           ``launch.serve.serve_requests`` with the flash kernel (whisper
           on the reference CLI's zero frames, internvl2 on its zero
           patches ahead of the prompt): the lm phase's traffic (a) and
           (b) without its 8,192-token prompt, which only mixtral serves
           (past its window: flash's window mask and the ring cache);
           whisper's (b) is 4 prompts of 128 - 256 tokens (its decoder's
           context is 448); flash launches per prefill 8 / 2 / 2 / 0 /
           36 / 24 (one per attention application: whisper's 12 encoder
           layers, 12 decoder self- and 12 cross-attentions) and none in
           a decode step; (b) prefilled again warm as in phase lm; flash
           against the plain attention path for mixtral, zamba2, whisper
           and internvl2 at (b), whisper and internvl2 on seeded frames /
           patches (last-position logits in bfloat16: within 3e-2 of the
           largest logit, mixtral at its 8 layers, zamba2 at 6, one
           application of its shared block; all, at the depth run, no
           farther than 1.1 times the plain path from the float32 plain
           logits; float32 within 1e-3, the scalar route; whisper's
           encoder output in bfloat16 within 3e-2 of its largest value);
           for the two MoE models the first
           layer's MoE input at (b) through the sparse dispatch at a
           capacity that drops nothing against the dense oracle (within
           2e-2 of the largest |y|), the share of (token, choice) pairs
           the config's capacity factor 1.25 drops and the per-expert
           load; for zamba2 and rwkv6 the first recurrent layer in
           float32 on 256 (zamba2 also 512) prompt tokens, its chunked
           scan against the sequential oracle (rtol = atol = 1e-4)
  train    the training path (``train.make_train_step``, no kernel: the
           flash kernel has no backward and refuses grad), one line a
           part: (a) qwen2-1.5b at its published width and depth, float32
           master params from a seeded generator, bfloat16 activations,
           remat, AdamW, 5 steps on ``TokenPipeline(seed=0)`` batches of
           train_4k's 4,096 tokens, the global batch cut to 8 and run as
           2 microbatches of 4: each step's loss / CE / grad norm / lr,
           the median step seconds of steps 2 - 5 (CUDA events), tokens/s,
           peak memory, then one step under ``torch.profiler`` (idle
           share, top kernels); finite loss and grad norm, a first-step
           CE within 0.5 of ln V, params that changed; (b) the resilient
           loop of ``launch.train`` (``run_resilient``, ``StepGuard``,
           ``Heartbeat``, async checkpoints under the git-ignored
           ``build/``, ``gc_checkpoints``) at full width and 2 layers: 6
           steps, a checkpoint every 2, a failure injected at step 3 that
           restores step 2 and rewinds the pipeline to its saved cursor;
           the final params equal an uninterrupted run's bit for bit
           under ``torch.use_deterministic_algorithms(True)`` (cuBLAS's
           workspace set to ``:4096:8`` before CUDA starts); (c) two steps
           (the second warm) of mixtral-8x7b (1 layer; its aux loss > 0),
           zamba2-2.7b (one group of 6), rwkv6-3b (8 layers),
           whisper-small and internvl2-1b (whole) at their published
           widths, batch 1 x 1,024 (whisper 1 x 256 under its 1,500
           seeded frames; internvl2 behind 256 seeded patches): step
           seconds, peak memory, loss, aux and grad norm.  Every cut is
           in ``reduced``; arctic-480b trains on the CPU tests only
  cost     the accountant (``launch/costs.py``) on the programs the card
           already ran, each line beside the card's name and power
           limit: (a) qwen2-1.5b's warm prefill of 4 x 2,048 (flash on),
           a decode step of the CLI traffic (4 x 128 positions) and
           phase train's step (8 x 4,096 in 2 microbatches), each counted
           over a real run and over ``build_cell``'s fake run of the same
           program: FLOPs by class and bytes equal, the kernels' counted
           calls equal to their launches; (b) each timed apart without
           the accountant (CUDA events, median), its roofline bound
           (``launch/roofline.py``) a share in (0, 1.05] of the time; (c)
           one warm fit at n under the accountant (labels unchanged): the
           distance kernels' counted FLOPs equal 3·d per (row, candidate)
           slot summed over their launches, the fit's bound and share of
           the warm wall; (d) ``dryrun.run_cell`` of qwen2-1.5b x
           train_4k / prefill_32k / decode_32k / long_500k on the card
           (fake tensors, flash on outside training; ``fits_card``:
           arguments + temp within its memory); (e) the dot FLOPs beside
           2 (8 for the train step) x params x tokens and the weight
           products alone, which they must reach

Each phase that drives a path of the port sets the kernels' launch
counts to 0 just before it and reads them just after; the summary's
``launches`` is the sum over the fit's cold run, the serve phase, the
server phase, the sharded phase, the mesh phase (its ranks' counts,
each read in the rank's own process, and the cluster dry run's), the lm
phase, the families phase
and the train phase (which must launch none); phases syncs and cost drive
no new path (their runs count in ``launches_script`` only), and phase
brute launches no kernel at all.

The line before the last but one is the kernels' summary object, the
line before the last is the card's name and power limit as nvidia-smi
prints them, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores, bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12
# instruction issue of the card's CUDA cores: 132 SMs x 128 lanes at the
# H100 SXM's 1.98 GHz boost clock, lane-instructions per second (an
# assumption: the clock under load is not read); its L2 cache, bytes
PEAK_ISSUE_S = 132 * 128 * 1.98e9
L2_BYTES = 50 * 2 ** 20
MIN_PTS = 64
PAIRWISE_SOURCE = "src/repro_torch/kernels/csrc/pairwise.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {
    "eps_count_batch": "src/repro/kernels/pairwise.py:164",
    "row_min_batch": "src/repro/kernels/pairwise.py:317",
    "eps_count": "src/repro/kernels/pairwise.py:76",
    "row_min": "src/repro/kernels/pairwise.py:120",
    "eps_count_band_batch": "src/repro/kernels/pairwise.py:208",
    "row_min2_batch": "src/repro/kernels/pairwise.py:270",
    "flash_attention": "src/repro/kernels/flash_attention.py:120",
}
# serving traffic: batches of the serve bench's size, and its mix per
# mutation step (85 % predict, 10 % insert, 5 % delete)
SERVE_BATCH = 2048
SERVE_BATCHES = 8
# the serve bench mix's steps on each plane (then one more with the resident
# gates at 0); 4 before the script's wall time had to stay within 970 s
MUTATION_STEPS = 2
# phase server: the scripted stream and the servers' admission shape
# the scripted stream's predict requests; 96 before the script's wall time
# had to stay within 970 s (server B's kernel-mode predicts ran twice, in
# phases server and syncs, some 45 s each on an H100's host)
SERVER_PREDICTS = 48
SERVER_INSERT = 204
SERVER_DELETE = 104
SERVER_SLOTS = 8
SERVER_QUERY_CAP = 2048
# phase sharded: slab shards of the distributed fit, all on the one card
SHARDS = 4


def _plain(x):
    """numpy scalars and arrays as JSON values."""
    return x.tolist() if isinstance(x, (np.ndarray, np.generic)) else str(x)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=_plain), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fns, reps: int = 20, replays: int = 3) -> float:
    """Mean device milliseconds of one call: ``reps`` calls captured in a
    CUDA graph (so no host time lies between the launches), taking the
    closures of ``fns`` in turn, the graph replayed ``replays`` times
    between CUDA events after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def distance_call(lib, name, a, b, vb, *rest):
    """``fn()`` that launches ``lib``'s C entry of a distance kernel on
    these operands into outputs allocated once: the same launch as the
    wrapper's, without its host-side checks, so that two builds of
    ``pairwise.cu`` are timed alike.  ``rest`` holds the kernel's own
    operands: ``eps_count_batch`` (valid_a, eps, stop_at),
    ``eps_count_band_batch`` (stop_row, eps_lo, eps_hi), none for
    ``row_min_batch`` and ``row_min2_batch``.  2-d operands (a [M, d],
    b [N, d]) take the unbatched functions' launch: slots of
    ``ROWS_PER_SLOT`` rows sharing b."""
    from repro_torch.kernels.ops import ROWS_PER_SLOT, _eps2
    if a.dim() == 2:
        M, d = a.shape
        C = b.shape[0]
        B, P, rows, b_stride, vb_stride = ((M + ROWS_PER_SLOT - 1)
                                           // ROWS_PER_SLOT, ROWS_PER_SLOT,
                                           M, 0, 0)
    else:
        B, P, d = a.shape
        C = b.shape[1]
        rows, b_stride, vb_stride = B * P, C * d, C
    vbu = vb.view(torch.uint8)
    ptr = lambda x: None if x is None else x.data_ptr()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    new = lambda dtype: torch.empty((rows,), dtype=dtype, device=a.device)

    def checked(launch):
        def fn():
            err = launch()
            require(err == 0, f"{name}: launch failed ({err})")
        return fn

    if name == "eps_count_batch":
        va, eps, stop_at = rest
        vau = None if va is None else va.view(torch.uint8)
        out, eps2 = new(torch.int32), _eps2(eps)
        return checked(lambda: lib.grit_eps_count_batch(
            a.data_ptr(), b.data_ptr(), vbu.data_ptr(), ptr(vau),
            out.data_ptr(), B, P, rows, C, d, b_stride, vb_stride, eps2,
            0 if stop_at is None else int(stop_at), stream()))
    if name == "eps_count_band_batch":
        stop_row, eps_lo, eps_hi = rest
        lo, hi = new(torch.int32), new(torch.int32)
        lo2, hi2 = _eps2(eps_lo), _eps2(eps_hi)
        return checked(lambda: lib.grit_eps_count_band_batch(
            a.data_ptr(), b.data_ptr(), vbu.data_ptr(), ptr(stop_row),
            lo.data_ptr(), hi.data_ptr(), B, P, C, d, lo2, hi2, stream()))
    mins, args = new(torch.float32), new(torch.int32)
    if name == "row_min2_batch":
        mins2 = new(torch.float32)
        return checked(lambda: lib.grit_row_min2_batch(
            a.data_ptr(), b.data_ptr(), vbu.data_ptr(), mins.data_ptr(),
            mins2.data_ptr(), args.data_ptr(), B, P, C, d, stream()))
    return checked(lambda: lib.grit_row_min_batch(
        a.data_ptr(), b.data_ptr(), vbu.data_ptr(), mins.data_ptr(),
        args.data_ptr(), B, P, rows, C, d, b_stride, vb_stride, stream()))


def rotation(args):
    """Copies of a distance call's tensor operands (scalars shared) that
    together touch three times the card's L2 cache, so that launches
    taking them in turn read device memory as the main path does, not the
    previous launch's bytes from L2.  Touched bytes: every tensor operand
    but the candidates (rows, masks, bars), and the coordinates of the
    valid candidates."""
    a, b, vb = args[:3]
    d = a.shape[-1]
    touched = (sum(x.numel() * x.element_size() for x in args
                   if isinstance(x, torch.Tensor) and x is not b)
               + 4 * d * int(vb.sum()))
    k = max(1, min(16, -(-3 * L2_BYTES // max(touched, 1))))
    clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
    return [args] + [tuple(clone(x) for x in args) for _ in range(k - 1)]


@contextlib.contextmanager
def pairwise_lib(lib):
    """The distance wrappers of ``kernels.ops`` launching ``lib`` (another
    build of ``pairwise.cu``) instead of the port's library."""
    from repro_torch.kernels import ops
    saved = ops._lib()
    ops._LIB = lib
    try:
        yield
    finally:
        ops._LIB = saved


def time_distance(lib, baseline, name, args, wrapper):
    """Times of one distance call on ``args`` (``distance_call``'s
    operands): ``ms``, the eager ``wrapper()`` by CUDA events (host work
    included; the time this script reports for every kernel), and
    ``graph_ms``, the C entry of ``lib`` launched back to back in a CUDA
    graph over the operands' ``rotation``.  With a ``baseline`` build also
    ``parent_ms`` and ``parent_graph_ms`` the same ways, the two builds
    timed in turns (new, parent, new, parent) and averaged."""
    rot = rotation(args)
    new = [distance_call(lib, name, *x) for x in rot]
    if baseline is None:
        return {"ms": cuda_ms(wrapper), "graph_ms": graph_ms(new)}
    old = [distance_call(baseline, name, *x) for x in rot]
    t = {"ms": [], "graph_ms": [], "parent_ms": [], "parent_graph_ms": []}
    for _ in range(2):
        t["ms"].append(cuda_ms(wrapper))
        t["graph_ms"].append(graph_ms(new))
        with pairwise_lib(baseline):
            t["parent_ms"].append(cuda_ms(wrapper))
        t["parent_graph_ms"].append(graph_ms(old))
    return {k: float(np.mean(v)) for k, v in t.items()}


# instructions of a (row, candidate) pair's decision, per kernel kind
DECISION_INSTR = {"eps_count": 2, "row_min": 3, "eps_count_band": 4,
                  "row_min2": 5}


def floor_ms(name: str, pairs: float, d: int, P: int) -> float:
    """An estimate, from an instruction count, of the issue-rate floor of
    the exact distance form: ``pairs`` (live row, valid candidate) pairs
    at 3d - 1 f32 instructions each (d subtractions, d multiplies, d - 1
    adds: no fused multiply-add, so each term is rounded as in the plain
    version) plus the decision (``DECISION_INSTR``: eps_count a hit test
    and its add, eps_count_band two of each, row_min a compare and two
    selects, row_min2 those and a min and a max) plus a share of the
    broadcast candidate load (1/2 where a lane holds two of a slot's
    P > 32 rows, else 1): 11.5 instructions a pair for row_min_batch at
    d = 3, over ``PEAK_ISSUE_S`` lane-instructions a second, which
    assumes the boost clock (the SM clock under load is not read)."""
    per_pair = (3 * d - 1 + DECISION_INSTR[name.removesuffix("_batch")]
                + (0.5 if P > 32 else 1.0))
    return pairs * per_pair / PEAK_ISSUE_S * 1e3


# the kinds of ``dist_kernel<K, D>`` in the order of ``pairwise.cu``'s
# ``enum Kind``
PAIRWISE_KINDS = ("eps_count", "row_min", "eps_count_band", "row_min2")


def pairwise_build_report():
    """The distance kernels as built: per instantiation of
    ``dist_kernel<K, D>`` (kind K of ``PAIRWISE_KINDS``, D = 0 the
    generic d > 5 one) its registers, stack and spill bytes from the
    ptxas report that the build keeps beside the library."""
    from repro_torch.kernels import build
    rep = {}
    lines = build.log_path("pairwise").read_text().splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*dist_kernelILi(\d)ELi(\d)E",
                      line)
        if not m:
            continue
        key = f"{PAIRWISE_KINDS[int(m.group(1))]}_d{m.group(2)}"
        row = {}
        for nxt in lines[i + 1:i + 4]:
            s = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", nxt)
            if s:
                row.update(stack_bytes=int(s.group(1)),
                           spill_store_bytes=int(s.group(2)),
                           spill_load_bytes=int(s.group(3)))
            r = re.search(r"Used (\d+) registers", nxt)
            if r:
                row["registers"] = int(r.group(1))
        rep[key] = row
    for key in (f"{kind}_d3" for kind in PAIRWISE_KINDS):
        require(key in rep and "registers" in rep[key],
                f"no ptxas report of {key} in the build log")
        require(rep[key]["spill_store_bytes"] == 0
                and rep[key]["spill_load_bytes"] == 0,
                f"the d = 3 {key} kernel spills registers: {rep[key]}")
    return rep


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def make_points(n: int, seed: int):
    """blobs-3d at ``n`` points on the integer domain [0, 1e5]^3, eps by
    the catalogue's occupancy-preserving rule eps * (n_ref / n)^(1/d)."""
    from repro_torch.data.scenarios import get_scenario
    sc = get_scenario("blobs-3d")
    eps = sc.eps * (sc.n / n) ** (1.0 / sc.d)
    eps = math.floor(eps) + 0.5          # 150.9 -> 150.5 at n = 1e6
    pts = np.rint(sc.points(seed=seed, n=n))
    return pts, float(eps)


# --------------------------------------------------------------------------
# kernels vs their plain versions
# --------------------------------------------------------------------------

def _needed_work(a_rows_live, n_valid, B, P, C, d, with_va):
    """(bytes, f32 operations) the function needs on these inputs: every
    input read once, every output written once; distances only between
    live rows and valid candidates."""
    pairs = float((a_rows_live * n_valid).sum())
    nbytes = (4.0 * d * float(a_rows_live.sum()) + 4.0 * d * float(n_valid.sum())
              + B * C + (B * P if with_va else 0) + 4.0 * B * P)
    return nbytes, 3.0 * d * pairs


def _work_to_bars(a, b, vb, eps, bar, row_bytes, n_out, slots=256):
    """(bound ms, by, pairs) of a count kernel that ends a row's scan at
    a per-row bar on its count at ``eps`` (``eps_count_batch``'s stop_at
    on the rows that valid_a marks, the band's stop_row): the work these
    inputs need.  A row needs its valid candidates in ascending order up
    to the one at which its count reaches its bar (all of them if it
    never does, none if its bar is <= 0); a slot needs the mask bytes and
    the candidates' coordinates up to the last candidate any of its rows
    needs; ``row_bytes`` a row are read for every row (valid_a or the
    bar), the coordinates of the rows with a bar above 0, and ``n_out``
    int32 outputs are written a row."""
    from repro_torch.kernels.ops import _eps2, sq_dists_direct
    B, P, d = a.shape
    C = b.shape[1]
    e2 = _eps2(eps)
    pairs = cand = mask = 0.0
    for s in range(0, B, slots):
        vs = vb[s:s + slots]
        bs = bar[s:s + slots].to(torch.int64)
        hit = (sq_dists_direct(a[s:s + slots], b[s:s + slots]) <= e2) \
            & vs[:, None, :]
        reach = hit.cumsum(-1) >= bs[..., None]
        last = torch.where(reach.any(-1), reach.int().argmax(-1), C - 1)
        last = torch.where(bs > 0, last, -1)         # no bar: nothing
        vcum = torch.nn.functional.pad(vs.to(torch.int64).cumsum(-1), (1, 0))
        pairs += float(vcum.gather(1, last + 1).sum().item())
        span = last.max(dim=1).values + 1            # positions per slot
        cand += float(vcum.gather(1, span[:, None]).sum().item())
        mask += float(span.sum().item())
    rows = float((bar > 0).sum().item())
    nbytes = 4.0 * d * rows + 4.0 * d * cand + mask \
        + (row_bytes + 4.0 * n_out) * B * P
    return (*_bound(nbytes, 3.0 * d * pairs), pairs)


def _bound(nbytes: float, ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def compare_eps_count(ops_mod, a, b, eps, vb, va, stop_at, batched):
    """Launch the wrapper, hold it against the plain version (both
    saturated at ``stop_at``).  Returns the max abs count difference on
    live rows."""
    from repro_torch.kernels.ops import eps_count_batch_plain
    if batched:
        got = ops_mod.eps_count_batch(a, b, eps, vb, va, stop_at=stop_at)
        a3, b3, vb3 = a, b, vb
    else:
        got = ops_mod.eps_count(a, b, eps, vb)[None]
        a3, b3, vb3 = a[None], b[None], None if vb is None else vb[None]
    torch.cuda.synchronize()
    want = eps_count_batch_plain(a3, b3, eps, vb3)
    live = torch.ones_like(want, dtype=torch.bool) if va is None else va
    if stop_at is not None:
        got, want = got.clamp(max=stop_at), want.clamp(max=stop_at)
    diff = ((got - want).abs() * live).max().item() if want.numel() else 0
    return int(diff)


def compare_row_min(ops_mod, a, b, vb, batched):
    from repro_torch.kernels.ops import row_min_batch_plain
    if batched:
        gm, gi = ops_mod.row_min_batch(a, b, vb)
        a3, b3, vb3 = a, b, vb
    else:
        gm, gi = ops_mod.row_min(a, b, vb)
        gm, gi = gm[None], gi[None]
        a3, b3, vb3 = a[None], b[None], None if vb is None else vb[None]
    torch.cuda.synchronize()
    wm, wi = row_min_batch_plain(a3, b3, vb3)
    require(bool((torch.isinf(gm) == torch.isinf(wm)).all()),
            "row_min: (inf, -1) rows differ from the plain version")
    fin = ~torch.isinf(wm)
    err = ((gm - wm).abs() * fin).nan_to_num(0.0).max().item() \
        if wm.numel() else 0.0
    rel_ok = bool((((gm - wm).abs() <= 1e-6 * wm.abs()) | ~fin).all())
    arg_mismatch = int((gi != wi).sum().item())
    return err, rel_ok, arg_mismatch


def lattice_inputs(B, P, C, d, seed, dev, dup=False, dead_every=0,
                   pair_dups=False):
    """Integer coordinates (float32-exact distances), random masks, one
    all-masked slot when B > 1, optional duplicated candidates (the
    second half repeating the first; with ``pair_dups`` also each odd
    candidate repeating the even one before it, so a tie straddles every
    phase boundary), and with ``dead_every`` = k every k-th slot without
    a live row and every k-th (shifted by one) without a valid candidate,
    interleaved with live ones."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-40, 40, size=(B, P, d)).astype(np.float32)
    b = rng.integers(-40, 40, size=(B, C, d)).astype(np.float32)
    if dup and C > 1:
        b[:, C // 2:] = b[:, :C - C // 2]
    if pair_dups and C > 1:
        b[:, 1::2] = b[:, 0:C - 1:2]
    vb = rng.uniform(size=(B, C)) > 0.3
    va = rng.uniform(size=(B, P)) > 0.2
    if B > 1:
        vb[0] = False
    if dead_every:
        va[::dead_every] = False
        vb[1::dead_every] = False
    t = lambda x: torch.as_tensor(x).to(dev)
    return t(a), t(b), t(vb), t(va)


# edge shapes of the warp-per-slot design: (B, P, C, d, dead_every,
# pair_dups); rows per slot around the lane counts (8: rows x phases,
# 31 / 32 / 33: one or two rows a lane, 63 / 127 / 200: several 64-row
# tasks), candidate widths that leave every slot's slab unaligned (37,
# 513), more slots than resident warps, d = 7 (planes, generic route)
EDGE_SHAPES = [(6, 8, 301, 3, 2, True), (6, 31, 300, 3, 3, True),
               (6, 32, 513, 3, 2, False), (6, 33, 37, 3, 2, True),
               (5, 63, 1029, 3, 2, True), (4, 127, 600, 3, 2, False),
               (3, 200, 700, 3, 0, True), (50_000, 8, 37, 3, 2, True),
               (4, 40, 301, 7, 2, True), (3, 5, 1100, 7, 0, True),
               (4, 63, 777, 4, 2, True), (4, 33, 515, 5, 2, True)]


def stop_lattice(dev):
    """Rows that reach stop_at at different candidates and in different
    slots (so different warps): 1-d candidates 0 .. C-1, slot g's rows
    spread along the line with an offset of its own."""
    B, P, C = 64, 40, 1500
    b = np.broadcast_to(np.arange(C, dtype=np.float32)[None, :, None],
                        (B, C, 1)).copy()
    rng = np.random.default_rng(11)
    a = (rng.integers(0, C, size=(B, P, 1))).astype(np.float32)
    vb = np.ones((B, C), bool)
    va = rng.uniform(size=(B, P)) > 0.1
    t = lambda x: torch.as_tensor(x).to(dev)
    return t(a), t(b), t(vb), t(va)


def kernels_phase(captured, dev, baseline=None):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import (eps_count_batch_plain,
                                         row_min_batch_plain)
    shapes = [(1, 1, 1, 1), (3, 5, 7, 2), (2, 17, 130, 3), (4, 127, 129, 4),
              (2, 64, 1300, 5), (3, 63, 600, 3), (2, 9, 260, 7)]
    cases = 0
    routes = {}
    # 1. integer lattices: everything equal, whatever the thread layout
    for i, (B, P, C, d) in enumerate(shapes):
        routes[f"{B}x{P}x{C}x{d}"] = ops.pairwise_route(d)
        for dup in (False, True):
            a, b, vb, va = lattice_inputs(B, P, C, d, 100 + i, dev, dup)
            eps = 17.0
            for stop_at in (None, 1, 5):
                diff = compare_eps_count(ops, a, b, eps, vb, va, stop_at,
                                         True)
                require(diff == 0, f"eps_count_batch differs on lattice "
                        f"{(B, P, C, d)} stop_at={stop_at}: {diff}")
            err, _, mism = compare_row_min(ops, a, b, vb, True)
            require(err == 0.0 and mism == 0, f"row_min_batch differs on "
                    f"lattice {(B, P, C, d)} dup={dup}: err={err} "
                    f"argmin mismatches={mism}")
            diff = compare_eps_count(ops, a[-1], b[-1], eps, vb[-1], None,
                                     None, False)
            require(diff == 0, f"eps_count differs on lattice {(P, C, d)}")
            err, _, mism = compare_row_min(ops, a[-1], b[-1], vb[-1], False)
            require(err == 0.0 and mism == 0,
                    f"row_min differs on lattice {(P, C, d)}")
            cases += 4
    # 1b. the edge shapes of the warp-per-slot design, on lattices
    for i, (B, P, C, d, dead, pairs) in enumerate(EDGE_SHAPES):
        routes[f"{B}x{P}x{C}x{d}"] = ops.pairwise_route(d)
        a, b, vb, va = lattice_inputs(B, P, C, d, 300 + i, dev, True, dead,
                                      pairs)
        for stop_at in (None, 1, 5, 40):
            diff = compare_eps_count(ops, a, b, 17.0, vb, va, stop_at, True)
            require(diff == 0, f"eps_count_batch differs on edge lattice "
                    f"{(B, P, C, d)} stop_at={stop_at}: {diff}")
        err, _, mism = compare_row_min(ops, a, b, vb, True)
        require(err == 0.0 and mism == 0, f"row_min_batch differs on edge "
                f"lattice {(B, P, C, d)}: err={err} argmin={mism}")
        cases += 5
    a, b, vb, va = stop_lattice(dev)
    for stop_at in (1, 3, 7, 20):
        diff = compare_eps_count(ops, a, b, 6.0, vb, va, stop_at, True)
        require(diff == 0, f"eps_count_batch differs where rows saturate "
                f"at different candidates, stop_at={stop_at}: {diff}")
        cases += 1
    for M in (33, 1000):                # the unbatched pair, ragged slots
        a, b, vb, _ = lattice_inputs(1, M, 777, 3, 400 + M, dev, True, 0,
                                     True)
        diff = compare_eps_count(ops, a[0], b[0], 17.0, vb[0], None, None,
                                 False)
        err, _, mism = compare_row_min(ops, a[0], b[0], vb[0], False)
        require(diff == 0 and err == 0.0 and mism == 0,
                f"unbatched pair differs at M = {M}: count {diff}, "
                f"d2 {err}, argmin {mism}")
        cases += 2
    # 2. the exact-eps tie lattice: d2 == eps2 counts as a hit, and the
    # nearest candidate at exactly eps is found
    n = 700
    bl = torch.zeros((n, 2), device=dev)
    bl[:, 0] = torch.arange(n, device=dev, dtype=torch.float32)
    al = torch.zeros((2, 2), device=dev)
    al[0, 0], al[1, 0] = 6.0, 515.0
    want = ((al[:, None, 0] - bl[None, :, 0]) ** 2 <= 36.0).sum(1).to(torch.int32)
    require(torch.equal(ops.eps_count(al, bl, 6.0), want)
            and torch.equal(ops.eps_count_batch(al[None], bl[None], 6.0)[0],
                            want), "exact-eps ties are not counted as hits")
    only = (torch.arange(n, device=dev) == 521)
    m, i = ops.row_min_batch(al[None], bl[None], only[None])
    require(float(m[0, 1]) == 36.0 and int(i[0, 1]) == 521,
            "row_min_batch misses the candidate at exactly eps")
    cases += 3
    # thresholds that the kernels' integer hit test takes only as the C
    # entries map them: a NaN eps counts nothing, eps 0 the d2 == 0 hits
    from repro_torch.kernels.ops import eps_count_band_batch_plain
    nan = float("nan")
    require(torch.equal(ops.eps_count_batch(al[None], bl[None], nan),
                        eps_count_batch_plain(al[None], bl[None], nan))
            and torch.equal(ops.eps_count_batch(al[None], bl[None], 0.0),
                            eps_count_batch_plain(al[None], bl[None], 0.0)),
            "eps_count_batch differs from its plain version at eps NaN or 0")
    got = ops.eps_count_band_batch(al[None], bl[None], nan, 0.0)
    want = eps_count_band_batch_plain(al[None], bl[None], nan, 0.0)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "eps_count_band_batch differs from its plain version at "
            "thresholds NaN and 0")
    cases += 3
    # 3. random reals: d2 within rtol 1e-6; count differences only on
    # rows that hold a candidate within that band of eps^2
    band_rows = 0
    for i, (B, P, C, d) in enumerate(shapes):
        rng = np.random.default_rng(200 + i)
        a = torch.as_tensor(rng.normal(size=(B, P, d)) * 10,
                            dtype=torch.float32).to(dev)
        b = torch.as_tensor(rng.normal(size=(B, C, d)) * 10,
                            dtype=torch.float32).to(dev)
        vb = torch.as_tensor(rng.uniform(size=(B, C)) > 0.3).to(dev)
        eps = 6.0
        got = ops.eps_count_batch(a, b, eps, vb)
        want = eps_count_batch_plain(a, b, eps, vb)
        d2 = ops.sq_dists_direct(a, b)
        near = ((d2 - 36.0).abs() <= 36.0 * 1e-6) & vb[:, None, :]
        in_band = near.any(dim=2)
        band_rows += int(in_band.sum().item())
        require(bool(((got == want) | in_band).all()),
                f"eps_count_batch differs outside the eps band {(B, P, C, d)}")
        err, rel_ok, mism = compare_row_min(ops, a, b, vb, True)
        require(rel_ok, f"row_min_batch d2 beyond rtol 1e-6 {(B, P, C, d)}")
        cases += 2

    # 4. main-path inputs (the largest call of every candidate width the
    # fit swept, captured from it) and the unbatched pair at a size of
    # its own: compare, then time (``time_distance``: ms eager as for
    # every kernel, graph_ms device time over rotated copies, parent_*
    # beside them when a baseline build is given).  floor_ms is an
    # instruction-count estimate (``floor_ms``), not a measurement.  The
    # summary row of a batched kernel is the width the fit called most
    # often (the widest among equals); main_path sums calls x each time
    # over the widths.
    lib = ops._lib()
    rows, tiers = [], {"eps_count_batch": [], "row_min_batch": []}

    def timed(name, args, wrapper, plain, row):
        row.update(time_distance(lib, baseline, name, args, wrapper))
        row["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
        return row

    for C in sorted(captured["eps_count_batch"]):
        (a, b, vb, va, eps, stop_at), calls = captured["eps_count_batch"][C]
        B, P, d = a.shape
        diff = compare_eps_count(ops, a, b, eps, vb, va, stop_at, True)
        require(diff == 0, f"eps_count_batch differs from its plain version "
                f"on the main path's inputs at width {C}: {diff}")
        if stop_at:     # the work the exit at stop_at leaves
            bound, by, pairs = _work_to_bars(
                a, b, vb, eps, torch.where(va, int(stop_at), 0), 1, 1)
        else:
            live, valid = va.sum(1).double(), vb.sum(1).double()
            bound, by = _bound(*_needed_work(live, valid, B, P, C, d, True))
            pairs = float((live * valid).sum())
        tiers["eps_count_batch"].append(timed(
            "eps_count_batch", (a, b, vb, va, eps, stop_at),
            lambda: ops.eps_count_batch(a, b, eps, vb, va, stop_at=stop_at),
            lambda: eps_count_batch_plain(a, b, eps, vb),
            dict(name="eps_count_batch", shape=[B, P, C, d], calls=calls,
                 kernel_route=ops.pairwise_route(d), max_abs_err=float(diff),
                 bound_ms=bound, bound_by=by,
                 floor_ms=floor_ms("eps_count_batch", pairs, d, P))))
    for C in sorted(captured["row_min_batch"]):
        (a, b, vb), calls = captured["row_min_batch"][C]
        B, P, d = a.shape
        err, rel_ok, mism = compare_row_min(ops, a, b, vb, True)
        require(err == 0.0 and mism == 0, f"row_min_batch differs from its "
                f"plain version on the main path's inputs at width {C}: "
                f"err={err} argmin={mism}")
        valid = vb.sum(1).double()
        nbytes, nops = _needed_work(
            torch.full((B,), float(P), device=dev).double(), valid, B, P, C,
            d, False)
        bound, by = _bound(nbytes + 4.0 * B * P, nops)    # second output
        tiers["row_min_batch"].append(timed(
            "row_min_batch", (a, b, vb),
            lambda: ops.row_min_batch(a, b, vb),
            lambda: row_min_batch_plain(a, b, vb),
            dict(name="row_min_batch", shape=[B, P, C, d], calls=calls,
                 kernel_route=ops.pairwise_route(d), max_abs_err=float(err),
                 bound_ms=bound, bound_by=by,
                 floor_ms=floor_ms("row_min_batch",
                                   float(P * valid.sum()), d, P))))
    main_path = {}
    for name in ("eps_count_batch", "row_min_batch"):
        rows.append(dict(max(tiers[name],
                             key=lambda r: (r["calls"], r["shape"][2]))))
        main_path[name] = {key: sum(t["calls"] * t[key] for t in tiers[name])
                           for key in ("ms", "graph_ms", "parent_ms",
                                       "parent_graph_ms", "bound_ms",
                                       "floor_ms")
                           if key in tiers[name][0]}

    M, N, d = 65536, 4096, 3
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.integers(0, 4000, size=(M, d)).astype(np.float32)).to(dev)
    b = torch.as_tensor(rng.integers(0, 4000, size=(N, d)).astype(np.float32)).to(dev)
    vb = torch.as_tensor(rng.uniform(size=N) > 0.2).to(dev)
    eps = 300.5
    diff = compare_eps_count(ops, a, b, eps, vb, None, None, False)
    require(diff == 0, f"eps_count differs from its plain version: {diff}")
    live = torch.full((1,), float(M), device=dev).double()
    nbytes, nops = _needed_work(live, vb.sum().double()[None], 1, M, N, d, False)
    bound, by = _bound(nbytes, nops)
    pairs = float(M * vb.sum())
    rows.append(dict(
        name="eps_count", shape=[M, N, d], max_abs_err=float(diff),
        **time_distance(lib, baseline, "eps_count_batch",
                        (a, b, vb, None, eps, None),
                        lambda: ops.eps_count(a, b, eps, vb)),
        plain_ms=cuda_ms(lambda: eps_count_batch_plain(a[None], b[None], eps,
                                                       vb[None]),
                         reps=2, warmup=1),
        bound_ms=bound, bound_by=by,
        floor_ms=floor_ms("eps_count", pairs, d, ops.ROWS_PER_SLOT)))
    err, rel_ok, mism = compare_row_min(ops, a, b, vb, False)
    require(err == 0.0 and mism == 0,
            f"row_min differs from its plain version: err={err} argmin={mism}")
    rows.append(dict(
        name="row_min", shape=[M, N, d], max_abs_err=float(err),
        **time_distance(lib, baseline, "row_min_batch", (a, b, vb),
                        lambda: ops.row_min(a, b, vb)),
        plain_ms=cuda_ms(lambda: row_min_batch_plain(a[None], b[None],
                                                     vb[None]),
                         reps=2, warmup=1),
        bound_ms=_bound(nbytes + 4.0 * M, nops)[0],
        bound_by=_bound(nbytes + 4.0 * M, nops)[1],
        floor_ms=floor_ms("row_min", pairs, d, ops.ROWS_PER_SLOT)))
    return rows, tiers, main_path, cases, band_rows, routes


# --------------------------------------------------------------------------
# serve: the fitted index
# --------------------------------------------------------------------------

def nearest_cores(q64: np.ndarray, cpts: torch.Tensor, clab: torch.Tensor,
                  chunk: int = 256):
    """float64 on the card, against every core point: per query the
    least squared distance and the least / greatest label among the
    cores within a relative 1e-12 (exact ties) and 1e-5 (ties a float32
    kernel may resolve either way) of it."""
    big = torch.iinfo(torch.int64).max
    out = {k: [] for k in ("dmin", "lo", "hi", "lo5", "hi5")}
    for s in range(0, len(q64), chunk):
        qq = torch.as_tensor(q64[s:s + chunk], device=cpts.device)
        d2 = (qq[:, None, 0] - cpts[None, :, 0]) ** 2
        for k in range(1, cpts.shape[1]):
            d2 += (qq[:, None, k] - cpts[None, :, k]) ** 2
        dmin = d2.min(dim=1).values
        out["dmin"].append(dmin)
        for tag, rel in (("", 1e-12), ("5", 1e-5)):
            near = d2 <= dmin[:, None] * (1.0 + rel)
            out["lo" + tag].append(
                torch.where(near, clab[None, :], big).min(dim=1).values)
            out["hi" + tag].append(
                torch.where(near, clab[None, :], -1).max(dim=1).values)
        del d2
    return {k: torch.cat(v).cpu().numpy() for k, v in out.items()}


def check_host_rule(q64, host, near, cpts_np, clab_np, eps2):
    """The oracle rule for host-mode labels: noise exactly where no core
    lies within eps, else the label of a core at the least distance.  A
    query whose card distance is within the exact-tie window of eps^2 or
    of another cluster's core is decided again on the host with the
    host's own float64 expression."""
    dmin = near["dmin"]
    amb = (near["lo"] != near["hi"]) | (np.abs(dmin - eps2) <= 1e-12 * eps2)
    clear = ~amb
    bad = int(((host[clear] == -1) != (dmin[clear] > eps2)).sum())
    inside = clear & (dmin <= eps2)
    bad += int((host[inside] != near["lo"][inside]).sum())
    for i in np.flatnonzero(amb):
        d2 = ((cpts_np - q64[i]) ** 2).sum(axis=1)
        dm = d2.min()
        ok = (host[i] == -1) if dm > eps2 else \
            (host[i] in set(clab_np[d2 == dm].tolist()))
        bad += int(not ok)
    return bad, int(amb.sum())


def mutation_step(plane, ds, step, forced, rng, pts, sc, n_ins, n_del,
                  n_pred, drift, step_s, split, record):
    """One step of the serve bench's mix on both planes: insert, delete,
    predict; the planes' stats, states, answers and the resident mirror
    must be equal afterwards.  Appends the step's seconds and split, and
    its (insert batch, delete ids, queries) to ``record``; returns the
    mirror check."""
    from repro_torch.data.scenarios import _insert_drift, _queries_mixed
    nonsemantic = {"dist_evals", "t_total", "t_pack", "t_kernel",
                   "band_fallback"}
    ins = _insert_drift(rng, pts, sc, n_ins, drift, MUTATION_STEPS)
    kill = rng.choice(plane["host"].arrival_live(), n_del, replace=False)
    q = _queries_mixed(rng, pts, sc, n_pred)
    record.append((ins, kill, q))
    got = {}
    for name, ix in plane.items():
        runs0 = copy.deepcopy(ds.stage_runs)
        secs0 = copy.deepcopy(ds.stage_s)
        t0 = time.perf_counter()
        si = ix.insert(ins)
        sd = ix.delete(kill)
        lab, d2 = ix.predict(q, mode=name, return_d2=True)
        torch.cuda.synchronize()
        step_s[name].append(time.perf_counter() - t0)
        got[name] = (si, sd, lab, d2)
        row = dict(
            gates="0" if forced else "default",
            insert_s=si["t_total"], delete_s=sd["t_total"],
            affected_grids=si["affected_grids"] + sd["affected_grids"],
            band_fallback=si["band_fallback"] + sd["band_fallback"])
        if name == "device":
            row["routes"] = {
                st: {r: dict(runs=ds.stage_runs[st][r] - runs0[st][r],
                             s=ds.stage_s[st][r] - secs0[st][r])
                     for r in ("flat", "host_twin")}
                for st in ds.stage_runs}
        split[name].append(row)
    h, d = plane["host"], plane["device"]
    for k in (0, 1):
        for key in set(got["host"][k]) - nonsemantic:
            require(np.array_equal(got["host"][k][key],
                                   got["device"][k][key]),
                    f"step {step}: stats {key} differ between planes")
    require(np.array_equal(h.labels_arrival(), d.labels_arrival())
            and np.array_equal(h.core_arrival(), d.core_arrival())
            and np.array_equal(h.merge_edges, d.merge_edges),
            f"step {step}: the planes' states differ")
    require(np.array_equal(got["host"][2], got["device"][2])
            and np.array_equal(got["host"][3], got["device"][3]),
            f"step {step}: the planes' answers differ")
    mm = d.device_state.mirror_matches(d)
    require(all(mm.values()), f"step {step}: resident mirror {mm}")
    return mm


def serve_phase(pts, eps, caps, fit_labels, seed, dev):
    """Fit with the index, predict in three modes, the mutation stream
    on two planes, a snapshot round trip.  Returns (summary, launches
    of this path, the largest kernel-mode predict call, the index, and
    for phase ``sharded``: the index's snapshot before the mutation
    stream, the query batches with their host-mode labels, and the
    stream's steps)."""
    from repro_torch.data.scenarios import _queries_mixed, get_scenario
    from repro_torch.engine import cluster, registry
    from repro_torch.index import GritIndex, device_state
    from repro_torch.kernels import ops

    n = len(pts)
    sc = dataclasses.replace(get_scenario("blobs-3d"), eps=eps, n=n)
    rng = np.random.default_rng(seed + 30_000)
    batches = [_queries_mixed(rng, pts, sc, SERVE_BATCH)
               for _ in range(SERVE_BATCHES)]
    n_pred = int(0.85 * SERVE_BATCH)
    n_ins = int(0.10 * SERVE_BATCH)
    n_del = SERVE_BATCH - n_pred - n_ins

    captured = []                        # the largest kernel-mode call
    real_min = ops.row_min_batch

    def keep_min(a, b, valid_b=None):
        if not captured or b.numel() > captured[0][1].numel():
            captured[:] = [(a, b, valid_b)]
        return real_min(a, b, valid_b)

    attach_s = []
    real_attach = registry._attach_index

    def timed_attach(*a, **k):
        t0 = time.perf_counter()
        out = real_attach(*a, **k)
        attach_s.append(time.perf_counter() - t0)
        return out

    ops.reset_launches()
    registry._attach_index = timed_attach
    try:
        t0 = time.perf_counter()
        res = cluster(pts, eps, MIN_PTS, engine="device-kernels", caps=caps,
                      return_index=True)
        fit_attach_s = time.perf_counter() - t0
    finally:
        registry._attach_index = real_attach
    fit_launches = dict(ops.LAUNCHES)
    idx = res.index
    require(np.array_equal(res.labels, fit_labels)
            and np.array_equal(idx.labels_arrival(), fit_labels),
            "the fit with the index gave other labels")
    require(np.array_equal(idx.core_arrival(), res.core),
            "the index holds other core flags than the fit")

    # ---- predict in three modes ----------------------------------------
    out = {m: [] for m in ("host", "kernel", "device")}
    secs = {m: [] for m in out}
    stats = {m: [] for m in out}

    def run(mode):
        for q in batches:
            st = {}
            t0 = time.perf_counter()
            lab, d2 = idx.predict(q, mode=mode, return_d2=True, stats=st)
            torch.cuda.synchronize()
            secs[mode].append(time.perf_counter() - t0)
            out[mode].append((lab, d2))
            stats[mode].append(st)

    run("host")
    ops.row_min_batch = keep_min
    try:
        run("kernel")
    finally:
        ops.row_min_batch = real_min
    t0 = time.perf_counter()
    idx.ensure_merge_graph()
    merge_graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.ensure_device_state()
    torch.cuda.synchronize()
    attach_device_s = time.perf_counter() - t0
    run("device")

    q_all = np.concatenate(batches)
    host = np.concatenate([o[0] for o in out["host"]])
    host_d2 = np.concatenate([o[1] for o in out["host"]])
    dev_lab = np.concatenate([o[0] for o in out["device"]])
    dev_d2 = np.concatenate([o[1] for o in out["device"]])
    require(np.array_equal(dev_lab, host) and np.array_equal(dev_d2, host_d2),
            f"device-mode predict differs from host mode on "
            f"{int((dev_lab != host).sum())} labels / "
            f"{int((dev_d2 != host_d2).sum())} distances")
    core = idx.core_arrival()
    cpts_np = pts[core]
    clab_np = idx.labels_arrival()[core]
    near = nearest_cores(q_all, torch.as_tensor(cpts_np, device=dev),
                         torch.as_tensor(clab_np, device=dev))
    eps2 = eps * eps
    bad_rule, ambiguous = check_host_rule(q_all, host, near, cpts_np,
                                          clab_np, eps2)
    require(bad_rule == 0, f"{bad_rule} host-mode labels break the "
            f"nearest-core rule")
    kern = np.concatenate([o[0] for o in out["kernel"]])
    dmin = np.sqrt(near["dmin"])
    decidable = (np.abs(dmin - eps) > 1e-5 * eps) & (near["lo5"] == near["hi5"])
    mism = int((kern[decidable] != host[decidable]).sum())
    require(mism == 0, f"kernel-mode predict differs from host mode on "
            f"{mism} decidable queries")

    def per_mode(mode):
        med = float(np.median(secs[mode]))
        return dict(median_s=med, queries_per_s=SERVE_BATCH / med,
                    batch_s=secs[mode],
                    candidates=[s.get("candidates") for s in stats[mode]])

    predict = {m: per_mode(m) for m in out}
    predict["kernel"]["caps"] = dataclasses.asdict(idx.predict_caps)
    predict["kernel"]["groups"] = [s["groups"] for s in stats["kernel"]]
    predict["device"]["uncertain"] = [s["uncertain"] for s in stats["device"]]
    # host packing + upload + enqueue, then block + host reduce + band
    # fallback (predict_device_async's own split of each batch)
    predict["device"]["pack_s"] = [s["t_pack"] for s in stats["device"]]
    predict["device"]["resolve_s"] = [s["t_kernel"] for s in stats["device"]]
    predict["device"]["flat_dispatches"] = \
        idx.device_state.stage_runs["predict"]["flat"]
    require(predict["device"]["flat_dispatches"] > 0,
            "device-mode predict never enqueued its flat gather")
    # share of the packed [group_cap, cand_cap] candidate slots that are
    # padding, per batch
    predict["kernel"]["padded_share"] = [
        1.0 - s["candidates"] / (s["caps"]["group_cap"] * s["caps"]["cand_cap"])
        for s in stats["kernel"]]
    predict_launches = dict(ops.LAUNCHES)

    # ---- mutation stream: host-serving index vs device-resident twin ----
    fit_snap = {k: np.array(v, copy=True)
                for k, v in idx.snapshot().items()}
    plane = {"host": GritIndex.restore(idx.snapshot()), "device": idx}
    require(plane["host"].device_state is None, "the host plane has a "
            "resident state")
    step_s = {"host": [], "device": []}
    # per step and plane: where the mutation time went (the stats' own
    # wall times); on the device plane also, per stage, how many runs
    # enqueued a flat gather on the card and how many the gates sent to
    # the host float64 twin, with the seconds of each route
    split = {"host": [], "device": []}
    ds = idx.device_state
    mirror, record = [], []
    # the steps of the mix under the default gates, then one more
    # with the gates at 0, so that every write-half stage of the resident
    # plane runs its flat gather on the card at least once
    plan = [(s, False) for s in range(MUTATION_STEPS)] + [(0, True)]
    gates = (device_state.MIN_FLAT_T, device_state.EDGE_MIN_FLAT_T)
    try:
        for step, (drift, forced) in enumerate(plan):
            if forced:
                device_state.MIN_FLAT_T = device_state.EDGE_MIN_FLAT_T = 0
            mirror.append(mutation_step(plane, ds, step, forced, rng, pts, sc,
                                        n_ins, n_del, n_pred, drift, step_s,
                                        split, record))
    finally:
        device_state.MIN_FLAT_T, device_state.EDGE_MIN_FLAT_T = gates
    for st in ("cores", "edges", "border"):
        require(ds.stage_runs[st]["flat"] > 0, f"the resident plane never "
                f"ran the {st} stage's flat gather on the card")
    launches = {k: v for k, v in ops.LAUNCHES.items()}

    # ---- snapshot round trip -------------------------------------------
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        t0 = time.perf_counter()
        plane["host"].save(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = GritIndex.load(path)
        load_s = time.perf_counter() - t0
    require(not os.path.exists(path), "the snapshot file was not removed")
    sa, sb = plane["host"].snapshot(), back.snapshot()
    require(set(sa) == set(sb) and all(np.array_equal(sa[k], sb[k])
                                       for k in sa),
            "the snapshot does not round-trip")
    lb, db = back.predict(batches[0], mode="host", return_d2=True)
    la, da = plane["host"].predict(batches[0], mode="host", return_d2=True)
    require(np.array_equal(la, lb) and np.array_equal(da, db),
            "the loaded snapshot answers otherwise")

    summary = dict(
        n=n, fit_attach_s=fit_attach_s, attach_s=attach_s[0],
        fit_s=fit_attach_s - attach_s[0], grids=int(idx.num_grids),
        queries=int(len(q_all)), predict=predict,
        row_min_batch_launches_predict=(predict_launches["row_min_batch"]
                                        - fit_launches["row_min_batch"]),
        device_state_attach_s=attach_device_s,
        oracle=dict(rule_violations=bad_rule, decided_on_host=ambiguous,
                    kernel_decidable=int(decidable.sum()),
                    kernel_mismatches=mism,
                    noise=int((host == -1).sum())),
        reduced=[dict(key="mutation_steps", published=4,
                      run=MUTATION_STEPS,
                      why="the script's wall time: within 970 s (with 4 it "
                          "took up to 1,158 s on an H100 machine)")],
        mutation=dict(steps=len(plan), steps_gates_0=1, predict=n_pred,
                      insert=n_ins, delete=n_del, merge_graph_s=merge_graph_s,
                      merge_edges=int(len(idx.merge_edges)),
                      step_s=step_s, step_split=split, planes_equal=True,
                      mirror_matches=all(all(m.values()) for m in mirror)),
        snapshot=dict(bytes=nbytes, save_s=save_s, load_s=load_s,
                      roundtrip=True))
    carry = dict(fit_snap=fit_snap, batches=batches, host=host,
                 stream=record)
    return summary, launches, captured[0], idx, carry


# --------------------------------------------------------------------------
# brute: the float64 brute DBSCAN on the card
# --------------------------------------------------------------------------

def brute_phase(pts, eps, fit, index, dev):
    """Phase ``brute``: ``check_conformant_brute`` on the card over (a)
    the cold fit (``fit``: its labels and core flags) and (b) ``index``,
    the device plane after phase serve's last mutation step (its live
    points, labels and core flags by arrival).  Each check raises on a
    failure; each report's counts must agree with the labelling's own.
    No kernel may launch (the check uses torch primitives only)."""
    from repro_torch.core.validate import check_conformant_brute
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    out = {}
    live = (index.points_arrival(), index.labels_arrival(),
            index.core_arrival())
    for tag, (p, lab, core) in (("fit", (pts, fit.labels, fit.core)),
                                ("mutated_index", live)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = check_conformant_brute(p, eps, MIN_PTS, lab, core, device=dev)
        rep["check_s"] = time.perf_counter() - t0
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        require(rep["n"] == len(lab) and rep["cores"] == int(core.sum())
                and rep["clusters"] == len(np.unique(lab[lab >= 0]))
                and rep["noise"] == int((lab < 0).sum()),
                f"brute/{tag}: the report's counts differ from the "
                f"labelling's: {rep}")
        out[tag] = rep
    require(dict(ops.LAUNCHES) == before, "brute: the check launched a "
            "kernel of the code under test")
    out["mutated_index"]["dead_rows"] = int(index.n - index.n_live)
    return dict(out, checks="core flags equal, core partition identical, "
                            "noise sets identical, borders valid, labels "
                            "equal on uncontested points; float64, no "
                            "tolerance")


# --------------------------------------------------------------------------
# server: the continuous-batching ClusterServer with a read replica
# --------------------------------------------------------------------------

def server_script(pts, sc, live, rng):
    """The scripted stream of phase ``server``: ``SERVER_PREDICTS``
    predict requests of log-uniform 1 - 2,048 queries from
    ``_queries_mixed``, two inserts of ``SERVER_INSERT`` points and one
    delete of ``SERVER_DELETE`` live arrival ids at fixed positions."""
    from repro_torch.data.scenarios import _insert_drift, _queries_mixed
    sizes = np.clip(np.rint(np.exp(rng.uniform(
        0.0, math.log(SERVER_QUERY_CAP), SERVER_PREDICTS))), 1,
        SERVER_QUERY_CAP).astype(int)
    mutations = {
        SERVER_PREDICTS // 4: ("insert", _insert_drift(
            rng, pts, sc, SERVER_INSERT, 0, 2)),
        SERVER_PREDICTS // 2: ("delete", rng.choice(
            live, SERVER_DELETE, replace=False)),
        3 * SERVER_PREDICTS // 4: ("insert", _insert_drift(
            rng, pts, sc, SERVER_INSERT, 1, 2)),
    }
    script = []
    for i, m in enumerate(sizes):
        if i in mutations:
            script.append(mutations[i])
        script.append(("predict", _queries_mixed(rng, pts, sc, int(m))))
    return script


def serve_script(srv, script):
    """Submit the stream, drain it; returns the requests by id."""
    for kind, payload in script:
        {"predict": srv.submit, "insert": srv.submit_insert,
         "delete": srv.submit_delete}[kind](payload)
    srv.run()
    torch.cuda.synchronize()
    return sorted(srv.done, key=lambda r: r.rid)


def server_readings(srv, events):
    """Per server: the summary's numbers, the step log's sums, and the
    attribution of ``serve.step`` to its children and of the delta
    stages (from the run's own span events)."""
    from repro_torch.obs import view
    s = srv.summary()
    att = view.attribution(events, root="serve.step")
    agg = view.span_aggregates(events)
    wall = att["wall_us"]
    return dict(
        steps=s["steps"], requests=s["requests"], queries=s["queries"],
        inserted=s["inserted"], deleted=s["deleted"],
        rejected=s["rejected"],
        latency_ms_p50=s["latency_ms_p50"], latency_ms_p95=s["latency_ms_p95"],
        latency_ms_p99=s["latency_ms_p99"],
        queries_per_s=s["queries_per_s"],
        mean_slot_fill=s["mean_slot_fill"],
        kernel_s=sum(st["kernel_s"] for st in srv.step_log),
        pack_s=sum(st["pack_s"] for st in srv.step_log),
        step_s=[st["seconds"] for st in srv.step_log],
        growth_events=s["growth_events"],
        attribution=dict(
            root="serve.step", wall_ms=wall / 1e3,
            self_ms=agg.get("serve.step", {}).get("self_us", 0.0) / 1e3,
            coverage=att["coverage"],
            children={k: dict(ms=v / 1e3, share=v / wall if wall else 0.0)
                      for k, v in sorted(att["children"].items(),
                                         key=lambda kv: -kv[1])}),
        delta_ms={k: dict(count=int(a["count"]), ms=a["total_us"] / 1e3)
                  for k, a in sorted(agg.items()) if k.startswith("delta.")})


def server_phase(index, pts, eps, seed, smi):
    """Two ``ClusterServer``s over restores of the served index's
    snapshot, on one scripted stream: A in device mode on a resident
    state, B in kernel mode answering from a read replica.  Tracing on
    for that run (Chrome trace to ``build/``), then the stream's
    predicts again on A with tracing off and on.  Returns (the phase
    line's fields, launches of the server path, the largest
    ``row_min_batch`` call of B, and for phase ``sharded``: the script,
    A's labels per request and A's index after the stream)."""
    from repro_torch import obs
    from repro_torch.data.scenarios import get_scenario
    from repro_torch.index import GritIndex
    from repro_torch.kernels import ops
    from repro_torch.serve import ClusterServer

    t_phase = time.perf_counter()
    n = len(pts)
    sc = dataclasses.replace(get_scenario("blobs-3d"), eps=eps, n=n)
    rng = np.random.default_rng(seed + 40_000)
    snap = index.snapshot()
    script = server_script(pts, sc, index.arrival_live(), rng)
    n_pred = sum(k == "predict" for k, _ in script)
    kw = dict(slots=SERVER_SLOTS, query_cap=SERVER_QUERY_CAP)

    captured = []                        # B's largest kernel-mode call
    real_min = ops.row_min_batch

    def keep_min(a, b, valid_b=None):
        if not captured or b.numel() > captured[0][1].numel():
            captured[:] = [(a, b, valid_b)]
        return real_min(a, b, valid_b)

    t0 = time.perf_counter()
    # each restore gets its own arrays: a snapshot holds the index's own,
    # which a delete updates in place
    idx_a, idx_b = (GritIndex.restore({k: v.copy() for k, v in snap.items()})
                    for _ in range(2))
    idx_b.enable_mutation_log()
    restore_s = time.perf_counter() - t0
    reg = obs.registry()
    ctr0 = reg.snapshot()
    was = obs.enabled()
    tracer = obs.enable(clear=True)
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        srv_a = ClusterServer(idx_a, mode="device", device_state=True, **kw)
        torch.cuda.synchronize()
        attach_a_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        done_a = serve_script(srv_a, script)
        run_a_s = time.perf_counter() - t0
        n_a = len(tracer.snapshot_events())
        launches_a = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        srv_b = ClusterServer(idx_b, mode="kernel", replicas=1, **kw)
        replica_s = time.perf_counter() - t0
        ops.row_min_batch = keep_min
        try:
            t0 = time.perf_counter()
            done_b = serve_script(srv_b, script)
            run_b_s = time.perf_counter() - t0
        finally:
            ops.row_min_batch = real_min
        events = tracer.snapshot_events()   # one timeline: A, then B
        ev_a, ev_b = events[:n_a], events[n_a:]
        launches = dict(ops.LAUNCHES)
    finally:
        frozen = obs.disable()
    ctr1 = reg.snapshot()
    trace_path = os.path.join("build", "chip_smoke_server_trace.json")
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    obs.export.write_chrome_trace(os.path.join(root, trace_path), events,
                                  metrics=ctr1, meta=obs.bench_meta())

    # ---- checks ----------------------------------------------------------
    require(len(done_a) == len(done_b) == len(script),
            "the servers did not answer every request")
    diff = [r.rid for r, q in zip(done_a, done_b) if r.kind == "predict"
            and not np.array_equal(r.labels, q.labels)]
    require(not diff, f"servers A and B differ on predict requests {diff}")
    rep = srv_b.replicas[0]
    require(np.array_equal(rep.labels_arrival(), idx_b.labels_arrival())
            and np.array_equal(rep.core_arrival(), idx_b.core_arrival()),
            "the replica's state differs from its primary's")
    require(np.array_equal(idx_a.labels_arrival(), idx_b.labels_arrival())
            and np.array_equal(idx_a.core_arrival(), idx_b.core_arrival()),
            "the device plane and the host plane differ after the stream")
    sa, sb = srv_a.summary(), srv_b.summary()
    require(sa["rejected"] == sb["rejected"], "rejected counts differ")
    b_launches = launches["row_min_batch"] - launches_a["row_min_batch"]
    require(b_launches > 0, "server B never launched row_min_batch")
    require(srv_b._rr == sum(1 for st in srv_b.step_log if st["queries"]),
            "a predict batch of B was not answered by the replica")
    names_a = {e["name"] for e in ev_a}
    names_b = {e["name"] for e in ev_b}
    steps = {f"serve.step.{k}" for k in
             ("mutate", "dispatch", "admit_next", "resolve")}
    delta = {f"delta.{d}.{k}" for d, ks in (
        ("insert", ("identifiers", "splice", "cores", "merge_repair",
                    "reconcile")),
        ("delete", ("tombstone", "demotions", "merge_repair", "components",
                    "compaction"))) for k in ks}
    for tag, names in (("A", names_a), ("B", names_b)):
        require(steps | delta <= names, f"server {tag}'s trace lacks "
                f"{sorted((steps | delta) - names)}")

    # ---- predict-only reruns: tracing off, on, on, off --------------------
    preds = [(k, p) for k, p in script if k == "predict"]
    n_frozen = len(frozen.snapshot_events())
    step_s = {"off": [], "on": []}
    first, n_on = None, []
    for on in (False, True, True, False):
        if on:
            obs.enable(clear=True)
        try:
            srv = ClusterServer(idx_a, mode="device", **kw)
            done = serve_script(srv, preds)
            step_s["on" if on else "off"] += [st["seconds"]
                                              for st in srv.step_log]
            if on:
                n_on.append(len(obs.get_tracer().snapshot_events()))
            else:
                require(obs.get_tracer() is None
                        and len(frozen.snapshot_events()) == n_frozen,
                        "a tracing-off rerun recorded span events")
        finally:
            obs.disable()
        first = first or [r.labels for r in done]
        require(len(done) == len(preds) and all(
            np.array_equal(r.labels, w) for r, w in zip(done, first)),
            "the predict-only reruns answered otherwise")
    if was:
        obs.enable()
    fields = dict(
        n=n, card=smi, slots=SERVER_SLOTS, query_cap=SERVER_QUERY_CAP,
        predicts=n_pred, queries=int(sum(len(p) for _, p in preds)),
        inserts=[SERVER_INSERT, SERVER_INSERT], delete=SERVER_DELETE,
        restore_s=restore_s, attach_device_state_s=attach_a_s,
        make_replica_s=replica_s, run_s={"A": run_a_s, "B": run_b_s},
        A=server_readings(srv_a, ev_a), B=server_readings(srv_b, ev_b),
        row_min_batch_launches_B=b_launches,
        counters={k: v - ctr0.get(k, 0) for k, v in ctr1.items()
                  if isinstance(v, int) and v != ctr0.get(k, 0)},
        labels_equal=True, replica_equal=True,
        rerun_median_step_s={k: float(np.median(v))
                             for k, v in step_s.items()},
        rerun_steps=len(step_s["on"]) // 2, rerun_events_off=0,
        rerun_events_on=n_on, trace=trace_path,
        phase_s=time.perf_counter() - t_phase)
    carry = dict(script=script, labels=[r.labels for r in done_a],
                 kinds=[r.kind for r in done_a],
                 live=idx_a.arrival_live(), final=idx_a.labels_arrival(),
                 core=idx_a.core_arrival())
    return fields, launches, captured[0], carry


# --------------------------------------------------------------------------
# syncs: the hot-path-sync rule against PyTorch's own sync detector
# --------------------------------------------------------------------------

def _call_ends(path, cache):
    """``(line, col) -> last line`` of every call in the file ``path``."""
    if path not in cache:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        cache[path] = {(n.lineno, n.col_offset): n.end_lineno
                       for n in ast.walk(tree) if isinstance(n, ast.Call)}
    return cache[path]


def syncs_phase(index, carry, smi):
    """(a) The linter over the port's tree: clean, its active and
    suppressed findings per rule.  (b) Phase ``server``'s stream through
    fresh servers A and B (restores of the served index's snapshot, as
    in phase ``server``) with tracing off, under
    ``torch.cuda.set_sync_debug_mode("warn")``: each sync's site is the
    innermost frame under ``src/repro_torch``, and a site is *missed*
    when the static ``hot-path-sync`` rule reports no call (active or
    suppressed) whose lines hold it.  Returns the phase line's fields."""
    from repro_torch import analysis, obs
    from repro_torch.index import GritIndex
    from repro_torch.serve import ClusterServer

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(root, "src", "repro_torch")
    t0 = time.perf_counter()
    report = analysis.analyze_paths([pkg])
    lint_s = time.perf_counter() - t0
    require(report.ok, "the linter reports violations in src/repro_torch:\n"
            + report.format())
    by_rule = {r: dict(active=sum(v.rule == r for v in report.active),
                       suppressed=sum(v.rule == r for v in report.suppressed))
               for r in analysis.rule_names()}
    ends, static = {}, {}
    for v in report.violations:
        if v.rule == "hot-path-sync":
            last = _call_ends(v.path, ends).get((v.line, v.col), v.line)
            static.setdefault(os.path.relpath(v.path, root), []).append(
                (v.line, last))

    script = carry["script"]
    snap = index.snapshot()
    idx_a, idx_b = (GritIndex.restore({k: v.copy() for k, v in snap.items()})
                    for _ in range(2))
    idx_b.enable_mutation_log()
    require(not obs.enabled(), "tracing is on at phase syncs")
    kw = dict(slots=SERVER_SLOTS, query_cap=SERVER_QUERY_CAP)
    servers = {"A": ClusterServer(idx_a, mode="device", device_state=True,
                                  **kw),
               "B": ClusterServer(idx_b, mode="kernel", replicas=1, **kw)}
    torch.cuda.synchronize()

    prefix = pkg + os.sep
    show = warnings.showwarning
    seen = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return show(message, category, filename, lineno, file, line)
        site, part = ("outside", 0), "predict"
        for fr in traceback.extract_stack():
            if fr.filename.startswith(prefix):
                site = (os.path.relpath(fr.filename, root), fr.lineno)
                if fr.name in ("insert", "delete"):
                    part = "mutate"
        rec = seen[tag]
        rec["sites"][site] = rec["sites"].get(site, 0) + 1
        rec[part] += 1

    run_s = {}
    for tag, srv in servers.items():
        for kind, payload in script:
            {"predict": srv.submit, "insert": srv.submit_insert,
             "delete": srv.submit_delete}[kind](payload)
        seen[tag] = {"sites": {}, "predict": 0, "mutate": 0}
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = hook
                srv.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        run_s[tag] = time.perf_counter() - t0

    # ---- checks ----------------------------------------------------------
    servers_out, missed = {}, set()
    for tag, srv in servers.items():
        done = sorted(srv.done, key=lambda r: r.rid)
        require(len(done) == len(script) and [r.kind for r in done]
                == carry["kinds"], f"server {tag} did not answer the stream")
        diff = [r.rid for r, want in zip(done, carry["labels"])
                if r.kind == "predict" and not np.array_equal(r.labels, want)]
        require(not diff, f"server {tag}'s labels differ from phase "
                f"server's on predict requests {diff}")
        rec = seen[tag]
        sites = {f"{f}:{ln}": c for (f, ln), c in sorted(rec["sites"].items())
                 if f != "outside"}
        for f, ln in rec["sites"]:
            if f != "outside" and not any(a <= ln <= b
                                          for a, b in static.get(f, ())):
                missed.add(f"{f}:{ln}")
        queries = sum(st["queries"] for st in srv.step_log)
        steps = len(srv.step_log)
        calls = sum(1 for st in srv.step_log if st["queries"])
        total = rec["predict"] + rec["mutate"]
        servers_out[tag] = dict(
            mode=srv.mode, steps=steps, predict_calls=calls,
            queries=queries, syncs=total, syncs_predict=rec["predict"],
            syncs_mutate=rec["mutate"],
            syncs_outside_port=rec["sites"].get(("outside", 0), 0),
            syncs_per_step=total / steps,
            syncs_per_predict_call=rec["predict"] / calls,
            syncs_per_predict_batch_2048=rec["predict"] * SERVE_BATCH
            / queries, sites=sites, run_s=run_s[tag])
    require(not missed, f"runtime sync sites the hot-path-sync rule does "
            f"not report: {sorted(missed)}")
    return dict(card=smi, lint=dict(
        files_checked=report.files_checked, seconds=lint_s, rules=by_rule,
        hot_path_sync_sites=sum(len(v) for v in static.values())),
        servers=servers_out, labels_equal_server=True, missed=[],
        phase_s=time.perf_counter() - t_phase)


# --------------------------------------------------------------------------
# sharded: the distributed fit and the sharded serving plane
# --------------------------------------------------------------------------

def label_map(a, b, mask):
    """Labels ``a`` -> labels ``b`` over the rows of ``mask`` as an
    array indexed by ``a`` (-1 where ``a`` has no row there); None when
    the two labelings do not induce the same partition of those rows."""
    if not mask.any():
        return np.full(1, -1, np.int64)
    a, b = np.asarray(a, np.int64)[mask], np.asarray(b, np.int64)[mask]
    if ((a < 0) != (b < 0)).any():
        return None
    m = a >= 0
    key = np.unique(a[m] * (int(b.max(initial=0)) + 1) + b[m])
    pa, pb = np.divmod(key, int(b.max(initial=0)) + 1)
    if len(np.unique(pa)) != len(pa) or len(np.unique(pb)) != len(pb):
        return None
    out = np.full(int(max(a.max(initial=0), 0)) + 1, -1, np.int64)
    out[pa] = pb
    return out


def mapped(lookup, labels):
    """``lookup[labels]`` with -1 passing through (and -2 for a label
    the map has no entry for)."""
    labels = np.asarray(labels, np.int64)
    ok = (labels >= 0) & (labels < len(lookup))
    out = np.where(labels < 0, -1, -2)
    out[ok] = lookup[labels[ok]]
    return out


def contested_ok(pts64, core_t, lab_t, rows, got, eps2):
    """For non-core rows whose label differs from the reference's under
    the partition map: each must lie within eps of cores of two or more
    clusters (a contested border, which DBSCAN leaves to the order of
    the scan) and within eps of a core of its own cluster (``got``)."""
    cpts, clab = pts64[core_t], lab_t[core_t]
    bad = 0
    for s in range(0, len(rows), 64):
        r = torch.as_tensor(rows[s:s + 64], device=pts64.device)
        g = torch.as_tensor(got[s:s + 64], device=pts64.device)
        d2 = ((pts64[r][:, None, :] - cpts[None, :, :]) ** 2).sum(-1)
        inside = d2 <= eps2
        big = torch.iinfo(clab.dtype).max
        lo = torch.where(inside, clab[None, :], big).min(dim=1).values
        hi = torch.where(inside, clab[None, :], -1).max(dim=1).values
        own = (inside & (clab[None, :] == g[:, None])).any(dim=1)
        bad += int((~((lo != hi) & own)).sum().item())
    return bad


def sharded_checks(sidx, unsharded, batches, eps, dev, lookup=None):
    """Host and kernel predict of each batch on the sharded index against
    the float64 rule over every core of it and, where the rule allows
    one label only, against the unsharded index's host label under the
    map of the two partitions (built from the two indexes' core labels
    when ``lookup`` is None).  Returns the readings, summed over the
    batches (per batch for the seconds)."""
    eps2 = eps * eps
    core = sidx.core_arrival()
    require(np.array_equal(sidx.arrival_live(), unsharded.arrival_live())
            and np.array_equal(core, unsharded.core_arrival()),
            "the sharded and the unsharded index hold other points or "
            "other core flags")
    lab_s = sidx.labels_arrival()
    if lookup is None:
        lookup = label_map(lab_s, unsharded.labels_arrival(), core)
        require(lookup is not None, "the sharded and the unsharded index "
                "partition the core points differently")
    cpts_np = unsharded.points_arrival()[core]
    clab_np = lab_s[core]
    cpts, clab = (torch.as_tensor(cpts_np, device=dev),
                  torch.as_tensor(clab_np, device=dev))
    tot = dict(queries=0, rule_violations=0, decided_on_host=0,
               exact_ties=0, single_label=0, unsharded_mismatches=0,
               kernel_decidable=0, kernel_mismatches_decidable=0,
               kernel_mismatches_all=0, multi_routed=0,
               owned_per_shard=np.zeros(sidx.num_shards, np.int64),
               host_s=[], kernel_s=[])
    for q in batches:
        st_h, st_k = {}, {}
        t0 = time.perf_counter()
        host = sidx.predict(q, mode="host", stats=st_h)
        tot["host_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        kern = sidx.predict(q, mode="kernel", stats=st_k)
        torch.cuda.synchronize()
        tot["kernel_s"].append(time.perf_counter() - t0)
        near = nearest_cores(q, cpts, clab)
        bad_rule, ambiguous = check_host_rule(q, host, near, cpts_np,
                                              clab_np, eps2)
        require(bad_rule == 0, f"{bad_rule} sharded host-mode labels break "
                f"the nearest-core rule")
        dmin = np.sqrt(near["dmin"])
        decidable = (np.abs(dmin - eps) > 1e-5 * eps) & \
            (near["lo5"] == near["hi5"])
        mism = int((kern[decidable] != host[decidable]).sum())
        require(mism == 0, f"sharded kernel-mode predict differs from "
                f"host mode on {mism} decidable queries")
        one = ~((near["lo"] != near["hi"])
                | (np.abs(near["dmin"] - eps2) <= 1e-12 * eps2))
        want = unsharded.predict(q[one], mode="host")
        off = int((mapped(lookup, host[one]) != want).sum())
        require(off == 0, f"{off} sharded labels differ from the "
                f"unsharded index's under the partition map")
        for k, v in (("queries", len(q)), ("decided_on_host", ambiguous),
                     ("exact_ties", int((near["lo"] != near["hi"]).sum())),
                     ("single_label", int(one.sum())),
                     ("kernel_decidable", int(decidable.sum())),
                     ("kernel_mismatches_all", int((kern != host).sum())),
                     ("multi_routed", st_h["multi_routed"])):
            tot[k] += int(v)
        tot["owned_per_shard"] += np.asarray(st_h["owned_per_shard"])
    tot["owned_per_shard"] = tot["owned_per_shard"].tolist()
    for mode in ("host", "kernel"):
        tot[f"{mode}_queries_per_s"] = \
            float(np.median([len(q) for q in batches])
                  / np.median(tot[f"{mode}_s"]))
    return tot


def sharded_phase(pts, eps, fit, serve_carry, server_carry, seed, dev, smi):
    """The distributed fit in four slab shards on the card (cold, warm,
    staged under tracing, the plain plane), held to the single-device
    fit; the sharded index built by ``fit_sharded`` served in host and
    kernel mode against the float64 rule and the unsharded index;
    mutations, a split and a merge against an unsharded twin, a
    snapshot round trip; last, server C (kernel mode, rebalancing) on
    phase ``server``'s stream, held to server A.  Returns (the phase
    line's fields, the launches of the sharded path's two driven runs --
    the cold distributed fit and server C's stream, each counted with
    the counts set to 0 just before it and read just after --, every
    launch of the phase).  Leaves the counts at 0."""
    from repro_torch import obs
    from repro_torch.core import sync
    from repro_torch.core.device_dbscan import GritCaps
    from repro_torch.data.scenarios import _queries_slab_band, get_scenario
    import repro_torch.dist.step as dist_step
    from repro_torch.dist import (ClusterCaps, RebalancePolicy,
                                  census_halo_cap, distributed_fit,
                                  slab_cuts)
    from repro_torch.engine import cluster, estimate_shard_caps
    from repro_torch.index import GritIndex, ShardedGritIndex, fit_sharded
    from repro_torch.kernels import ops
    from repro_torch.obs import view
    from repro_torch.serve import ClusterServer

    t_phase = time.perf_counter()
    n = len(pts)
    shards = SHARDS
    out = dict(n=n, shards=shards, card=smi)
    spent = dict.fromkeys(ops.LAUNCHES, 0)   # every launch of the phase

    def settle():
        """Fold the counts into ``spent`` and set them to 0."""
        for k, v in ops.LAUNCHES.items():
            spent[k] += v
        ops.reset_launches()

    # ---- 1. the distributed fit -----------------------------------------
    t0 = time.perf_counter()
    estimate_shard_caps(pts, eps, MIN_PTS, shards, use_kernels=True)
    census_halo_cap(pts, eps, shards)
    out["estimate_shard_caps_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    settle()
    sync.READS["count"] = 0
    t0 = time.perf_counter()
    cold = cluster(pts, eps, MIN_PTS, engine="distributed", n_shards=shards)
    launches_fit = dict(ops.LAUNCHES)
    settle()
    torch.cuda.synchronize()
    out["cold_s"] = time.perf_counter() - t0
    out["host_reads_cold"] = sync.READS["count"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    require(cold.overflow == (), f"unresolved overflow {cold.overflow}")
    require(cold.stats["use_kernels"] == (dev.type == "cuda")
            and cold.stats["devices"] == [str(dev)] * shards,
            f"the fit ran {cold.stats}")
    last = cold.attempts[-1]["caps"]
    caps = ClusterCaps(grit=GritCaps(**{k: v for k, v in last.items()
                                        if k != "halo_cap"}),
                       halo_cap=last["halo_cap"])
    out["attempts"] = [list(a["overflow"]) for a in cold.attempts]
    out["caps"] = dict(last)
    sync.READS["count"] = 0
    t0 = time.perf_counter()
    warm = cluster(pts, eps, MIN_PTS, engine="distributed", n_shards=shards,
                   caps=caps)
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    out["host_reads_warm"] = sync.READS["count"]
    require(np.array_equal(warm.labels, cold.labels)
            and np.array_equal(warm.core, cold.core),
            "a warm distributed fit gave other labels")
    # staged under tracing: the stages on the synchronised host clock,
    # each shard's local pipeline timed apart
    real_dbscan = dist_step.device_dbscan
    shard_s = []

    def timed_dbscan(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real_dbscan(*a, **k)
        torch.cuda.synchronize()
        shard_s.append(time.perf_counter() - t)
        return r

    was = obs.enabled()
    tracer = obs.enable(clear=True)
    dist_step.device_dbscan = timed_dbscan
    try:
        t0 = time.perf_counter()
        kfit = distributed_fit(pts, eps, MIN_PTS, caps=caps,
                               n_shards=shards, traced=True)
        out["traced_s"] = time.perf_counter() - t0
        events = tracer.snapshot_events()
    finally:
        dist_step.device_dbscan = real_dbscan
        obs.disable()
        if was:
            obs.enable()
    agg = view.span_aggregates(events)
    out["stage_s"] = {k.rsplit(".", 1)[-1]: agg[k]["total_us"] / 1e6
                      for k in sorted(agg) if k.startswith("dist.fit.")}
    out["stage_s"]["local_cluster_per_shard"] = shard_s
    reg = obs.registry().snapshot()
    out["halo"] = {k: (v["value"] if isinstance(v, dict) else v)
                   for k, v in reg.items()
                   if k.startswith(("dist.halo.", "dist.pack."))}
    _, cut_idx, cut_coords = slab_cuts(pts, eps, shards)
    out["points_per_shard"] = np.diff(np.concatenate(
        [[0], cut_idx, [n]])).tolist()
    out["cut_coords"] = cut_coords.tolist()
    require(np.array_equal(kfit.labels, cold.labels), "the traced fit "
            "gave other labels")
    t0 = time.perf_counter()
    pfit = distributed_fit(pts, eps, MIN_PTS, caps=dataclasses.replace(
        caps, grit=dataclasses.replace(caps.grit, use_kernels=False)),
        n_shards=shards, traced=False)
    torch.cuda.synchronize()
    out["plain_plane_s"] = time.perf_counter() - t0
    for f in ("labels", "core", "point_grid", "shard_of"):
        require(np.array_equal(getattr(kfit, f), getattr(pfit, f)),
                f"the plain plane gives another {f} than the kernel plane")
    del pfit
    # ---- 2. against the single-device fit -------------------------------
    require(np.array_equal(cold.core, fit.core),
            "core flags differ from the single-device fit")
    lookup = label_map(cold.labels, fit.labels, fit.core)
    require(lookup is not None, "the core points' partition differs from "
            "the single-device fit's")
    require(np.array_equal(cold.labels == -1, fit.labels == -1),
            "the noise differs from the single-device fit's")
    got = mapped(lookup, cold.labels)
    rows = np.flatnonzero(got != fit.labels)
    require(not fit.core[rows].any(), "a core point is labelled otherwise")
    pts64 = torch.as_tensor(pts, dtype=torch.float64, device=dev)
    bad = contested_ok(pts64, torch.as_tensor(fit.core, device=dev),
                       torch.as_tensor(fit.labels, device=dev), rows,
                       got[rows], eps * eps)
    require(bad == 0, f"{bad} border labels differ from the single-device "
            f"fit's without being contested")
    del pts64
    out["vs_single_device"] = dict(core_equal=True, partition_equal=True,
                                   clusters=int(len(np.unique(
                                       cold.labels[cold.labels >= 0]))),
                                   contested_borders_differing=int(
                                       len(rows)))
    # ---- 3. sharded serving ---------------------------------------------
    t0 = time.perf_counter()
    sidx = fit_sharded(pts, eps, MIN_PTS, n_shards=shards,
                       engine="distributed", caps=caps)
    out["fit_sharded_s"] = time.perf_counter() - t0
    require(sidx.num_shards == shards, "fit_sharded built "
            f"{sidx.num_shards} shards")
    t0 = time.perf_counter()
    unsharded = GritIndex.restore({k: np.array(v, copy=True) for k, v in
                                   serve_carry["fit_snap"].items()})
    out["unsharded_restore_s"] = time.perf_counter() - t0
    sc = dataclasses.replace(get_scenario("blobs-3d"), eps=eps, n=n)
    rng = np.random.default_rng(seed + 50_000)
    mixed = np.concatenate(serve_carry["batches"])
    band = np.concatenate([_queries_slab_band(rng, pts, sc, SERVE_BATCH)
                           for _ in range(SERVE_BATCHES)])
    require(np.array_equal(unsharded.predict(mixed, mode="host"),
                           serve_carry["host"]),
            "the restored unsharded index answers otherwise than phase "
            "serve's")
    out["serving"] = {
        name: sharded_checks(
            sidx, unsharded, [q[i:i + SERVE_BATCH]
                              for i in range(0, len(q), SERVE_BATCH)],
            eps, dev, lookup)
        for name, q in (("mixed", mixed), ("slab_band", band))}
    # ---- 4. mutations and topology --------------------------------------
    stream = serve_carry["stream"]
    t0 = time.perf_counter()
    for shard in sidx.shards:
        shard.ensure_merge_graph()
    out["merge_graph_s"] = time.perf_counter() - t0
    steps = []
    for i, (ins, kill, q) in enumerate(stream[:2]):
        row = {}
        for tag, ix in (("sharded", sidx), ("unsharded", unsharded)):
            t0 = time.perf_counter()
            si = ix.insert(ins)
            sd = ix.delete(kill)
            ix.predict(q, mode="host")
            row[tag] = dict(s=time.perf_counter() - t0,
                            insert_s=si["t_total"], delete_s=sd["t_total"],
                            deleted=sd["deleted"],
                            newly_core=si["newly_core"],
                            demoted=sd["demoted"])
        for k in ("deleted", "newly_core", "demoted"):
            require(row["sharded"][k] == row["unsharded"][k],
                    f"mix step {i}: {k} differs from the unsharded twin")
        steps.append(row)
    counts = [len(g) for g in sidx.own_gids]
    k_split = int(np.argmax(counts))
    t0 = time.perf_counter()
    split = sidx.split_shard(k_split)
    split_s = time.perf_counter() - t0
    counts = np.asarray([len(g) for g in sidx.own_gids])
    k_merge = int(np.argmin(counts[:-1] + counts[1:]))
    t0 = time.perf_counter()
    merge = sidx.merge_shards(k_merge)
    merge_s = time.perf_counter() - t0
    q4 = np.concatenate([serve_carry["batches"][0], band[:SERVE_BATCH]])
    after_ops = sharded_checks(sidx, unsharded, [q4], eps, dev)
    t0 = time.perf_counter()
    snap = {k: np.array(v, copy=True) for k, v in sidx.snapshot().items()}
    snap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ShardedGritIndex.restore(snap)
    restore_s = time.perf_counter() - t0
    require(np.array_equal(back.predict(q4, mode="host"),
                           sidx.predict(q4, mode="host"))
            and np.array_equal(back.labels_arrival(), sidx.labels_arrival()),
            "the restored sharded index answers otherwise")
    del back, snap, unsharded
    out["mutation"] = dict(
        steps=steps, split=dict(shard=k_split, cut=split["cut"],
                                n_left=split["n_left"],
                                n_right=split["n_right"], s=split_s),
        merge=dict(shard=k_merge, cut=merge["cut"],
                   n_merged=merge["n_merged"], s=merge_s),
        shards_after=sidx.num_shards, after_ops=after_ops,
        snapshot_s=snap_s, restore_s=restore_s, roundtrip=True)
    # ---- 5. server C on phase server's stream ----------------------------
    # the rest of phase serve's stream, so that C starts where A did
    t0 = time.perf_counter()
    for ins, kill, _ in stream[2:]:
        sidx.insert(ins)
        sidx.delete(kill)
    out["catch_up_s"] = time.perf_counter() - t0
    srv = ClusterServer(sidx, mode="kernel",
                        rebalance=RebalancePolicy(period=4),
                        slots=SERVER_SLOTS, query_cap=SERVER_QUERY_CAP)
    tracer = obs.enable(clear=True)
    try:
        settle()
        t0 = time.perf_counter()
        done = serve_script(srv, server_carry["script"])
        launches_server = dict(ops.LAUNCHES)
        settle()
        run_s = time.perf_counter() - t0
        events = tracer.snapshot_events()
    finally:
        obs.disable()
        if was:
            obs.enable()
    require(len(done) == len(server_carry["labels"]), "server C did not "
            "answer every request")
    diff = [r.rid for r, want, kind in zip(done, server_carry["labels"],
                                           server_carry["kinds"])
            if kind == "predict" and label_map(
                r.labels, want, np.ones(len(want), bool)) is None]
    require(not diff, f"server C's labels differ from server A's as a "
            f"partition on requests {diff}")
    require(np.array_equal(sidx.arrival_live(), server_carry["live"])
            and np.array_equal(sidx.core_arrival(), server_carry["core"])
            and label_map(sidx.labels_arrival(), server_carry["final"],
                          server_carry["core"]) is not None,
            "after the stream, the sharded index differs from server A's")
    slab = {k: v["value"] for k, v in srv.metrics.snapshot().items()
            if k.startswith("serve.slab")}
    out["server_c"] = dict(
        run_s=run_s, readings=server_readings(srv, events),
        topology_events=[{k: v for k, v in e.items()}
                         for e in srv.topology_events],
        shards=sidx.num_shards, slab_gauges=slab, labels_equal=True)
    # the sharded path's two driven runs: the fit launches both kernels
    # (core and border), server C's kernel-mode predicts row_min_batch
    for k in ("eps_count_batch", "row_min_batch"):
        require(launches_fit[k] > 0, f"the distributed fit never launched "
                f"{k}")
    require(launches_server["row_min_batch"] > 0, "server C's kernel-mode "
            "predicts never launched row_min_batch")
    out["launches_fit"] = launches_fit
    out["launches_server_c"] = launches_server
    settle()
    out["launches_phase"] = dict(spent)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, {k: launches_fit[k] + launches_server[k]
                 for k in launches_fit}, spent, (caps, kfit)


# --------------------------------------------------------------------------
# the mesh: one process per rank
# --------------------------------------------------------------------------

MESH_RANKS = 4                  # gloo ranks on the one card: a 2 x 2 mesh
MESH_MOE_ARCH = "mixtral-8x7b"
MESH_MOE_TOKENS = (4, 256)      # the MoE block's input, batch x sequence
MESH_TRAIN_LAYERS = 2           # qwen2-1.5b's 28 layers cut to 2
MESH_TRAIN_TOKENS = (8, 512)
MESH_TP_PROMPT = (4, 2048)      # part tp's bf16 prefill, batch x sequence
MESH_TP_DECODE = 4
MESH_TP_LOGIT_TOL = 3e-2        # of the largest |logit|, bf16
# a float32 gradient leaf's distance from the single-device one, as a share
# of its largest |g| (tests/test_torch_train.py's float32 tolerance)
MESH_TP_GRAD_TOL = 1e-4
# the params after two AdamW steps are held at rtol 2e-4 + atol 1e-5 on
# every entry whose first-step |g| exceeds this floor: AdamW divides each
# gradient entry by its own magnitude, so an entry whose gradient is near
# 0 moves by up to lr in a direction the summation order decides
MESH_TP_PARAM_GRAD_FLOOR = 1e-5
# a rank's own flash call in the TP prefill on the 2 x 2 mesh: its half of
# the prompts (the batch split over 'data'), 6 of qwen2's 12 heads, 1 of
# its 2 KV heads (batch, heads, KV heads, Sq, Sk, head dim)
MESH_TP_FLASH = (MESH_TP_PROMPT[0] // 2, 6, 1, MESH_TP_PROMPT[1],
                 MESH_TP_PROMPT[1], 128)
# part tp on a 1 x 4 mesh over the same four gloo ranks: qwen2's 2 KV heads
# do not split 4 ways, so its cache's sequence is sharded over 'model' (a
# length the 4 ranks divide: 516 positions a rank); each rank's prefill
# runs flash on the 4 prompts, 3 of the 12 heads and the 1 KV head they read
MESH_SEQ_LAYERS = 14            # of 28: the script's wall time
MESH_SEQ_WHY = ("the script's wall time: at 28 layers a rank's decode step "
                "took up to 2.75 s of host-staged collectives on an H100")
MESH_SEQ_CACHE = MESH_TP_PROMPT[1] + 16
MESH_SEQ_FLASH = (MESH_TP_PROMPT[0], 3, 1, MESH_TP_PROMPT[1],
                  MESH_TP_PROMPT[1], 128)
# the other families on the 1 x 4 mesh: (arch, layers run (None: all), why
# cut, activation dtype); a prefill of MESH_FAMILY_PROMPT plus
# MESH_FAMILY_DECODE steps each.  The recurrent families run in float32:
# in bfloat16 their scans amplify the rounding that the split's partial
# sums change (rwkv6's TP logits 11 % of max |logit| from one device's,
# as far as bf16 itself moves them), which would hide a wrong split
_SHARE = ("four ranks share the one 80 GB card, each with its placed params, "
          "its local view and (rank 0) one device's copy")
MESH_FAMILIES = (("rwkv6-3b", 8, f"{_SHARE}: 32 float32 layers ran it out "
                  "of memory (a rank's local view gathers the channel mix's "
                  "w_v / w_r whole)", "float32"),
                 ("whisper-small", None, None, "bfloat16"),
                 ("zamba2-2.7b", 12, f"{_SHARE}; 2 of the shared block's 9 "
                  "applications, as phase train's step runs 1", "float32"))
MESH_FAMILY_PROMPT = (2, 256)
MESH_FAMILY_DECODE = 2
# a rank's flash calls in those prefills (batch, heads, KV heads, Sq, Sk,
# head dim, causal): whisper's 12 heads and zamba2's 32 a quarter each
_FB, _FS = MESH_FAMILY_PROMPT
MESH_FAMILY_FLASH = {
    "whisper-small": ((_FB, 3, 3, 1500, 1500, 64, False),
                      (_FB, 3, 3, _FS, _FS, 64, True),
                      (_FB, 3, 3, _FS, 1500, 64, False)),
    "zamba2-2.7b": ((_FB, 8, 8, _FS, _FS, 80, True),),
    "rwkv6-3b": (),
}


def _mesh_moe_case(dtype, dev, seed):
    """mixtral-8x7b's MoE block at its published width (d 4,096, ff
    14,336, 8 experts, top-2): float32 weights from a seeded generator
    on ``dev`` (the same on every rank), x [4, 256, d] in ``dtype``, and
    the config at capacity factor E / K, which drops nothing."""
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.moe import moe_params
    cfg = model_cfg_for(MESH_MOE_ARCH)
    m = cfg.moe
    cfg = cfg.with_overrides(
        dtype=dtype, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    gen = torch.Generator(device=dev).manual_seed(seed + 120_000)
    p = moe_params(cfg, gen, dev)
    x = torch.randn((*MESH_MOE_TOKENS, cfg.d_model), generator=gen,
                    device=dev, dtype=torch.float32).to(dtype_of(dtype))
    return cfg, p, x


def _mesh_moe_rank(mesh, dev, seed):
    """Both explicit-collective MoE variants on ``mesh`` in float32 and
    bfloat16: this rank's y block (host) and aux, and the seconds of a
    warm call."""
    from repro_torch.models import moe as M
    out = {}
    n_data = mesh.size(0)
    r = mesh.get_local_rank("data")
    for dtype in ("float32", "bfloat16"):
        cfg, p, x = _mesh_moe_case(dtype, dev, seed)
        B = x.shape[0]
        xb = x[r * B // n_data:(r + 1) * B // n_data]
        for fn in ("moe_forward_shardmap", "moe_forward_shardmap_ep"):
            call = lambda: getattr(M, fn)(cfg, p, xb, mesh, ("data",),  # noqa: E731
                                          "model")
            y, aux = call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            out[f"{fn}/{dtype}"] = dict(
                y=y.float().cpu().numpy(), aux=float(aux),
                warm_s=time.perf_counter() - t0)
        del p, x
        torch.cuda.empty_cache()
    return out


def _mesh_fit_rank(mesh, dev, pts, eps, caps):
    """The distributed fit of this rank's slab: cold (the first in the
    process, counted: the kernels' launches and the bytes each move
    sent) and warm; returns the result's arrays too."""
    from repro_torch.dist import comm, distributed_fit
    from repro_torch.kernels import ops
    ops.reset_launches()
    for k in comm.SENT:
        comm.SENT[k] = 0
    t0 = time.perf_counter()
    fit = distributed_fit(pts, eps, MIN_PTS, caps=caps, mesh=mesh,
                          device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, sent = dict(ops.LAUNCHES), dict(comm.SENT)
    t0 = time.perf_counter()
    warm = distributed_fit(pts, eps, MIN_PTS, caps=caps, mesh=mesh,
                           device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    fields = ("labels", "core", "point_grid", "shard_of", "cut_coords")
    require(all(np.array_equal(getattr(fit, f), getattr(warm, f))
                for f in fields), "a warm mesh fit gave another result")
    return dict(cold_s=cold_s, warm_s=warm_s, launches=launches,
                sent_bytes=sent, report=fit.report.as_vector().tolist(),
                **{f: getattr(fit, f) for f in fields})


def mesh_gloo_rank(rank, world, dev, pts_path, eps, caps, seed):
    """One of ``MESH_RANKS`` gloo ranks on the card (a 2 x 2 mesh): the
    fit, the MoE variants, then tensor-parallel compute (part tp)."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, "cuda")
    out = {"fit": _mesh_fit_rank(mesh, dev, np.load(pts_path), eps, caps)}
    out["moe"] = _mesh_moe_rank(mesh, dev, seed)
    torch.cuda.empty_cache()
    out["tp"] = _mesh_tp_rank(mesh, dev, seed)
    return out


def _tp_cfg(dtype, flash=False):
    from repro_torch.launch.specs import model_cfg_for
    return model_cfg_for(TRAIN_ARCH).with_overrides(
        num_layers=MESH_TRAIN_LAYERS, dtype=dtype, remat=False,
        use_flash_kernel=flash)


def _sent():
    from repro_torch.dist import comm
    from repro_torch.models import tensor_parallel as tp
    return {**{f"tp.{k}": v for k, v in tp.SENT.items()},
            **{f"comm.{k}": v for k, v in comm.SENT.items()}}


def _zero_sent():
    from repro_torch.dist import comm
    from repro_torch.models import tensor_parallel as tp
    for d in (tp.SENT, comm.SENT):
        d.update(dict.fromkeys(d, 0))


def _tp_train(mesh, dev, seed):
    """qwen2-1.5b (``MESH_TRAIN_LAYERS`` layers, float32) on ``mesh``:
    the TP step's gradients of the first batch (``train.step``'s mesh
    gradients, gathered), then two TP train steps; on rank 0 the same on
    one device, the gradients' and the losses' distance from them, and
    the params' after the two steps: how far each leaf's worst entry
    lies outside rtol 2e-4 + atol 1e-5, how many entries do, and the
    largest first-step |g| among them."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding as shd
    from repro_torch.models import init_params
    from repro_torch.train import (TrainCfg, get_optimizer, init_state,
                                   make_train_step)
    from repro_torch.train.step import _mesh_grads, grads_of
    cfg = _tp_cfg("float32")
    tcfg, opt = TrainCfg(), get_optimizer("adamw", weight_decay=0.0)
    B, S = MESH_TRAIN_TOKENS
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=0)
    batches = [{"tokens": torch.as_tensor(pipe.next_batch()["tokens"]).to(
        device=dev, dtype=torch.int32)} for _ in range(2)]

    def run(mesh_):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed + 130_000), dev)
        state = init_state(cfg, tcfg, opt, params)
        step = make_train_step(cfg, tcfg, opt, lambda s: 1e-3, mesh=mesh_)
        if mesh_ is None:
            grads = grads_of(cfg, params, batches[0])[2]
        else:
            state = shd.place_tree(state, shd.state_shardings(cfg, mesh_,
                                                              state))
            grads = shd.gather_tree(_mesh_grads(
                cfg, mesh_, lambda p, b: grads_of(cfg, p, b),
                state["params"], shd.place_tree(
                    batches[0], shd.batch_shardings(cfg, mesh_,
                                                    batches[0])))[2])
        grads = shd.keyed_leaves(grads)[0]
        losses, secs, sent = [], [], []
        for b in batches:
            if mesh_ is not None:
                b = shd.place_tree(b, shd.batch_shardings(cfg, mesh_, b))
            _zero_sent()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
            sent.append(_sent())
        params = state["params"]
        if mesh_ is not None:
            params = shd.gather_tree(params)
        return losses, secs, sent, grads, shd.keyed_leaves(params)[0]

    ml, ms, sent, mg, mp = run(mesh)
    out = dict(losses_tp=ml, step_s_tp=ms, sent_bytes=sent)
    if dist.get_rank() == 0:
        sl, ss, _, sg, sp = run(None)
        grad_err = {k: float((a - b).abs().max() / b.abs().max())
                    for (k, a), (_, b) in zip(mg, sg)}
        excess, outside, g_outside = {}, 0, 0.0
        for (k, a), (_, b), (_, g) in zip(mp, sp, sg):
            over = (a - b).abs() - (1e-5 + 2e-4 * b.abs())
            excess[k] = float(over.max())
            if excess[k] > 0:
                outside += int((over > 0).sum())
                g_outside = max(g_outside, float(g[over > 0].abs().max()))
        worst = max(excess, key=excess.get)
        out.update(losses_one=sl, step_s_one=ss,
                   loss_err=max(abs(a - b) for a, b in zip(ml, sl)),
                   grad_rel_err=max(grad_err.values()),
                   grad_worst_leaf=max(grad_err, key=grad_err.get),
                   param_max_abs_err=max(float((a - b).abs().max())
                                         for (_, a), (_, b) in zip(mp, sp)),
                   param_tolerance_excess=excess[worst],
                   param_worst_leaf=worst,
                   params_outside=outside,
                   params=sum(b.numel() for _, b in sp),
                   grad_max_abs_outside=g_outside)
        del sp, sg
    del mp, mg
    dist.barrier()
    return out


def _tp_serve(mesh, dev, seed):
    """qwen2-1.5b (``MESH_TRAIN_LAYERS`` layers, bf16, flash on): this
    rank's rows of a ``MESH_TP_PROMPT`` prefill plus ``MESH_TP_DECODE``
    decode steps under tensor parallelism, from a cache ``init_cache``
    made under the TP context, its flash calls' shapes and launches;
    rank 0 then runs every row on one device with plain attention."""
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill, sharding_ctx)
    from repro_torch.models import tensor_parallel as tp
    cfg = _tp_cfg("bfloat16", flash=True)
    B, S = MESH_TP_PROMPT
    rng = np.random.default_rng(seed + 131_000)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (MESH_TP_DECODE, B)),
                           dtype=torch.int32, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 132_000), dev)
    placed = shd.place_tree(params, shd.param_shardings(cfg, mesh, params))
    n_data, r = mesh.size(0), mesh.get_local_rank("data")
    rows = slice(r * B // n_data, (r + 1) * B // n_data)
    shapes = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        shapes.append([*q.shape, k.shape[1]])
        return real(q, k, v, **kw)

    def serve(cfg, p, rows_):
        cache = init_cache(cfg, prompt[rows_].shape[0], S + MESH_TP_DECODE,
                           dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, p, {"tokens": prompt[rows_]}, cache)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        got = [logits.float().cpu().numpy()]
        t0 = time.perf_counter()
        for t in toks:
            logits, cache = decode_step(cfg, p, t[rows_], cache)
            got.append(logits.float().cpu().numpy())
        return got, pre_s, (time.perf_counter() - t0) / MESH_TP_DECODE, \
            cache["slots"][0]["k"].shape[2]

    _zero_sent()
    with torch.no_grad(), sharding_ctx.tensor_parallel((mesh, "model")):
        local = tp.local_params(cfg, placed)
        ops.flash_attention = spy
        ops.reset_launches()
        try:
            got, pre_s, dec_s, heads = serve(cfg, local, rows)
        finally:
            ops.flash_attention = real
        launches = dict(ops.LAUNCHES)
    out = dict(rows=[rows.start, rows.stop], logits=got, prefill_s=pre_s,
               decode_step_s=dec_s, cache_kv_heads=heads,
               flash_shapes=shapes, launches=launches, sent_bytes=_sent())
    del local
    if dist.get_rank() == 0:
        with torch.no_grad():
            one, one_pre, one_dec, _ = serve(
                cfg.with_overrides(use_flash_kernel=False), params,
                slice(0, B))
        out.update(one_logits=one, one_prefill_s=one_pre,
                   one_decode_step_s=one_dec)
    dist.barrier()
    return out


def _tp_flash(dev, seed):
    """Flash at a rank's local-head shape ``MESH_TP_FLASH``, timed in
    turns (one rank on the card at a time), its bound and SDPA's time."""
    from repro_torch.kernels import ops
    B, H, Hkv, Sq, Sk, D = MESH_TP_FLASH
    gen = torch.Generator(device=dev).manual_seed(seed + 133_000)
    q, k, v = (torch.randn((B, h, Sq, D), generator=gen, device=dev)
               .to(torch.bfloat16) for h in (H, Hkv, Hkv))
    nbytes = 2.0 * 2 * B * (H * Sq + Hkv * Sk) * D
    nops = 4.0 * D * B * H * ops.live_pairs(Sq, Sk, True, None)
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_BF16_OPS_S * 1e3
    lib = sdpa_call(q, k, v, True, None, None)
    out = {}
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn == dist.get_rank():
            out = dict(shape=[B, H, Sq, Sk, D], kv_heads=Hkv,
                       ms=cuda_ms(lambda: ops.flash_attention(q, k, v)),
                       library_ms=cuda_ms(lib), bound_ms=max(tb, to),
                       bound_by="bytes" if tb >= to else "operations")
        torch.cuda.synchronize()
    dist.barrier()
    return out


class _Gathers(torch.utils._python_dispatch.TorchDispatchMode):
    """The input dims, sorted, of every ``_c10d_functional`` all-gather
    dispatched under it (``gather_leaf`` sends a leaf whole with the
    gathered dim moved first)."""

    def __init__(self):
        super().__init__()
        self.dims = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name == "_c10d_functional::all_gather_into_tensor":
            self.dims.append(tuple(sorted(args[0].shape)))
        return func(*args, **(kwargs or {}))


def _seq_model(arch, layers, flash, dtype="bfloat16"):
    from repro_torch.launch.specs import model_cfg_for
    cfg = model_cfg_for(arch).with_overrides(
        dtype=dtype, remat=False, use_flash_kernel=flash)
    return cfg if layers is None else cfg.with_overrides(num_layers=layers)


def _mesh_serve(mesh, dev, cfg, k, batch, toks, max_len, seed):
    """``cfg`` served through ``prefill_on_mesh`` and a ``decode_on_mesh``
    per step of ``toks``, on params placed by ``param_shardings`` (drawn
    from one seed on every rank, in turns, so that one rank at a time
    holds a whole copy beside the placed ones), the batch by
    ``batch_shardings`` and a cache made whole and placed by
    ``cache_shardings``; each step on the cache the last call returned.
    This rank's logits, seconds, bytes sent, the local shapes of its
    cache leaves, whether every returned leaf is the placed tree's own,
    the decode steps' all-gathers of a local KV cache leaf, its flash
    calls and launches, and its peak memory; on rank 0
    also one device's logits with plain attention."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import decode_on_mesh, prefill_on_mesh
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill)
    from repro_torch.train.tree import flatten
    me = dist.get_rank()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = placed = None
    for turn in range(dist.get_world_size()):
        if turn == me:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(
                seed + 134_000 + k), dev)
            placed = shd.place_tree(params, shd.param_shardings(cfg, mesh,
                                                                params))
            if me:
                params = None
            torch.cuda.synchronize()
        dist.barrier()
    placed_bytes = torch.cuda.memory_allocated()
    # rank 0 alone keeps its whole params (one device's run below)
    kept_bytes = 0 if params is None else sum(
        t.numel() * t.element_size() for t in flatten(params)[0])
    pb = shd.place_tree(batch, shd.batch_shardings(cfg, mesh, batch))
    whole = init_cache(cfg, batch["tokens"].shape[0], max_len, dev)
    pc = shd.place_tree(whole, shd.cache_shardings(cfg, mesh, whole))
    del whole
    shapes, real = [], ops.flash_attention

    def spy(q, k_, v, **kw):
        shapes.append([*q.shape, k_.shape[1], bool(kw.get("causal"))])
        return real(q, k_, v, **kw)

    gathers = _Gathers()
    _zero_sent()
    ops.flash_attention = spy
    ops.reset_launches()
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, c = prefill_on_mesh(cfg, mesh, placed, pb, pc)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            sent_prefill = _sent()
            got = [logits.float().cpu().numpy()]
            t0 = time.perf_counter()
            for t in toks:
                tt = shd.place_tree({"tokens": t}, shd.batch_shardings(
                    cfg, mesh, {"tokens": t}))
                with gathers:
                    logits, c = decode_on_mesh(cfg, mesh, placed,
                                               tt["tokens"], c)
                got.append(logits.float().cpu().numpy())
            dec_s = (time.perf_counter() - t0) / len(toks)
    finally:
        ops.flash_attention = real
    launches = dict(ops.LAUNCHES)
    back = flatten(c["slots"])[0]
    leaves = flatten(pc["slots"])[0]
    names = [n for slot in pc["slots"] for n in sorted(slot)]
    local = {n: list(t.to_local().shape) for n, t in zip(names, back)}
    kv_dims = {tuple(sorted(t.to_local().shape)) for n, t in zip(names, back)
               if n in ("k", "v", "xk", "xv")}
    out = dict(logits=got, prefill_s=pre_s, decode_step_s=dec_s,
               sent_prefill=sent_prefill, sent_prefill_decode=_sent(),
               cache_local=local,
               cache_placed=all(a is b and isinstance(a, DTensor)
                                for a, b in zip(back, leaves)),
               pos=c["pos"], decode_gathers=len(gathers.dims),
               cache_gathers=sum(d in kv_dims for d in gathers.dims),
               flash_shapes=shapes, launches=launches,
               allocated_after_placing=placed_bytes,
               whole_params_kept=kept_bytes,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    del placed, pc, pb, c, back, leaves
    torch.cuda.empty_cache()
    if me == 0:
        plain = cfg.with_overrides(use_flash_kernel=False)
        with torch.no_grad():
            cache = init_cache(plain, batch["tokens"].shape[0], max_len, dev)
            logits, cache = prefill(plain, params, batch, cache)
            one = [logits.float().cpu().numpy()]
            for t in toks:
                logits, cache = decode_step(plain, params, t, cache)
                one.append(logits.float().cpu().numpy())
        out["one_logits"] = one
        del cache
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _tp_seq_serve(mesh, dev, seed):
    """Part tp on the 1 x 4 mesh: qwen2-1.5b (``MESH_SEQ_LAYERS``,
    bf16, flash on) on a ``MESH_TP_PROMPT`` prefill plus
    ``MESH_TP_DECODE`` steps over a sequence-sharded cache of
    ``MESH_SEQ_CACHE`` positions, then each of ``MESH_FAMILIES`` on
    ``MESH_FAMILY_PROMPT`` plus ``MESH_FAMILY_DECODE`` steps (whisper
    under seeded frames N(0, 1))."""
    from repro_torch.launch.specs import model_cfg_for
    out = {}
    B, S = MESH_TP_PROMPT
    rng = np.random.default_rng(seed + 135_000)
    cfg = _seq_model(TRAIN_ARCH, MESH_SEQ_LAYERS, True)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=dev)}
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (MESH_TP_DECODE, B)),
                           dtype=torch.int32, device=dev)
    out[TRAIN_ARCH] = _mesh_serve(mesh, dev, cfg, 0, batch, toks,
                                  MESH_SEQ_CACHE, seed)
    B, S = MESH_FAMILY_PROMPT
    for k, (arch, layers, _, dtype) in enumerate(MESH_FAMILIES, start=1):
        cfg = _seq_model(arch, layers, True, dtype)
        full = model_cfg_for(arch)
        require((cfg.d_model, cfg.num_heads, cfg.d_ff) ==
                (full.d_model, full.num_heads, full.d_ff),
                f"mesh/tp: {arch} not at its published width")
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=dev)}
        batch.update({n: v.to(getattr(torch, dtype)) for n, v in
                      _seeded_stubs(cfg, B, dev, seed + 136_000 + k).items()})
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (MESH_FAMILY_DECODE, B)),
                               dtype=torch.int32, device=dev)
        out[arch] = _mesh_serve(mesh, dev, cfg, k, batch, toks,
                                S + MESH_FAMILY_DECODE, seed)
    return out


def _mesh_tp_rank(mesh, dev, seed):
    """Part tp on this rank: the TP train steps, the TP prefill and
    decode, flash at the local-head shape, the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    out = {"train": _tp_train(mesh, dev, seed)}
    torch.cuda.empty_cache()
    out["serve"] = _tp_serve(mesh, dev, seed)
    torch.cuda.empty_cache()
    out["flash"] = _tp_flash(dev, seed)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    from repro_torch.launch.mesh import make_host_mesh
    out["seq"] = _tp_seq_serve(make_host_mesh(MESH_RANKS, "cuda"), dev,
                               seed)
    return out


def _mesh_train(mesh, dev, seed):
    """qwen2-1.5b at its published width, ``MESH_TRAIN_LAYERS`` layers,
    float32, remat off, AdamW without weight decay at lr 1e-3: two
    steps with DTensor state on ``mesh`` and two single-device steps,
    same params and batch."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models import init_params
    from repro_torch.train import (TrainCfg, get_optimizer, init_state,
                                   make_train_step)
    from repro_torch.train.tree import flatten
    cfg = model_cfg_for(TRAIN_ARCH).with_overrides(
        num_layers=MESH_TRAIN_LAYERS, dtype="float32", remat=False)
    tcfg, opt = TrainCfg(), get_optimizer("adamw", weight_decay=0.0)
    B, S = MESH_TRAIN_TOKENS
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=0)
    batches = [{"tokens": torch.as_tensor(pipe.next_batch()["tokens"]).to(
        device=dev, dtype=torch.int32)} for _ in range(2)]

    def run(mesh_):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed + 130_000), dev)
        state = init_state(cfg, tcfg, opt, params)
        step = make_train_step(cfg, tcfg, opt, lambda s: 1e-3, mesh=mesh_)
        if mesh_ is not None:
            state = shd.place_tree(state, shd.state_shardings(cfg, mesh_,
                                                              state))
        losses, secs = [], []
        for b in batches:
            if mesh_ is not None:
                b = shd.place_tree(b, shd.batch_shardings(cfg, mesh_, b))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        return (losses, secs,
                [t.detach() for t in flatten(shd.gather_tree(
                    state["params"]))[0]])

    ml, ms, mp = run(mesh)
    sl, ss, sp = run(None)
    worst = 0.0
    for a, b in zip(mp, sp):
        excess = ((a - b).abs() - (1e-5 + 2e-4 * b.abs())).max()
        worst = max(worst, float(excess))
    return dict(reduced=f"{MESH_TRAIN_LAYERS} of 28 layers",
                losses_mesh=ml, losses_one=sl, step_s_mesh=ms,
                step_s_one=ss,
                loss_err=max(abs(a - b) for a, b in zip(ml, sl)),
                param_max_abs_err=max(float((a - b).abs().max())
                                      for a, b in zip(mp, sp)),
                param_tolerance_excess=worst)


def mesh_nccl_rank(rank, world, dev, pts_path, eps, seed):
    """A rank of an NCCL group of one rank per card: the distributed
    fit through ``cluster``, the MoE variants and the train step on its
    ``(world, 1)`` mesh."""
    from repro_torch.engine import cluster
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, "cuda")
    pts = np.load(pts_path)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = cluster(pts, eps, MIN_PTS, engine="distributed", mesh=mesh,
                  device=dev)
    torch.cuda.synchronize()
    out = {"fit": dict(s=time.perf_counter() - t0,
                       launches=dict(ops.LAUNCHES), labels=res.labels,
                       core=res.core, overflow=list(res.overflow),
                       attempts=len(res.attempts),
                       use_kernels=res.stats["use_kernels"])}
    out["moe"] = _mesh_moe_rank(mesh, dev, seed)
    out["train"] = _mesh_train(mesh, dev, seed)
    return out


def _mesh_tp_check(ranks, smi, t_script):
    """Part tp's checks and line; returns the TP prefills' launches (the
    ranks', summed)."""
    from repro_torch.kernels import ops
    train0 = ranks[0]["tp"]["train"]
    for r in ranks:
        require(r["tp"]["train"]["losses_tp"] == train0["losses_tp"],
                "mesh/tp: the ranks' TP losses differ")
    require(train0["loss_err"] < 1e-4
            and train0["grad_rel_err"] <= MESH_TP_GRAD_TOL
            and train0["grad_max_abs_outside"] <= MESH_TP_PARAM_GRAD_FLOOR,
            f"mesh/tp: the TP train steps differ from the single-device "
            f"steps: {train0}")
    serve0 = ranks[0]["tp"]["serve"]
    B, H, Hkv, Sq, _, D = MESH_TP_FLASH
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    errs = []
    for r in ranks:
        sv = r["tp"]["serve"]
        lo, hi = sv["rows"]
        for step, (got, want) in enumerate(zip(sv["logits"],
                                               serve0["one_logits"])):
            want = want[lo:hi]
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            require(np.isfinite(got).all() and got.shape == want.shape,
                    f"mesh/tp: step {step}: logits {got.shape}")
            require(err <= MESH_TP_LOGIT_TOL * scale,
                    f"mesh/tp: step {step}: the TP logits are {err} from "
                    f"the single-device run's (tolerance "
                    f"{MESH_TP_LOGIT_TOL} x {scale})")
            errs.append(err / scale)
        require(sv["cache_kv_heads"] == Hkv,
                f"mesh/tp: the rank's cache holds {sv['cache_kv_heads']} "
                f"KV heads")
        require(len(sv["flash_shapes"]) == MESH_TRAIN_LAYERS and all(
            sh == [B, H, Sq, D, Hkv] for sh in sv["flash_shapes"]),
            f"mesh/tp: flash ran at {sv['flash_shapes']}, not on the "
            f"rank's {H} local heads and {Hkv} KV head")
        require(sv["launches"]["flash_attention"] == MESH_TRAIN_LAYERS,
                f"mesh/tp: {sv['launches']['flash_attention']} flash "
                f"launches in a rank's TP prefill")
        for k, v in sv["launches"].items():
            launches[k] += v
    emit("mesh", part="tp", card=smi, backend="gloo", ranks=MESH_RANKS,
         mesh="2x2", device="cuda:0", arch=TRAIN_ARCH,
         reduced=f"{MESH_TRAIN_LAYERS} of 28 layers; four ranks share one "
                 f"card",
         train=dict(tokens=list(MESH_TRAIN_TOKENS), dtype="float32",
                    tolerance=f"loss 1e-4 at both steps; every gradient "
                              f"leaf of the first within {MESH_TP_GRAD_TOL} "
                              f"of its largest |g|; params after two "
                              f"AdamW steps within rtol 2e-4 + atol 1e-5 "
                              f"where the first step's |g| exceeds "
                              f"{MESH_TP_PARAM_GRAD_FLOOR}",
                    **{k: v for k, v in train0.items()
                       if k not in ("step_s_tp", "sent_bytes")}),
         serve=dict(tokens=list(MESH_TP_PROMPT), decode=MESH_TP_DECODE,
                    dtype="bfloat16", tolerance=f"{MESH_TP_LOGIT_TOL} of "
                    f"max |logit| of one device with plain attention",
                    max_rel_err=max(errs),
                    one_prefill_s=serve0["one_prefill_s"],
                    one_decode_step_s=serve0["one_decode_step_s"]),
         per_rank=[dict(
             step_s=r["tp"]["train"]["step_s_tp"],
             step_sent_bytes=r["tp"]["train"]["sent_bytes"],
             prefill_s=r["tp"]["serve"]["prefill_s"],
             decode_step_s=r["tp"]["serve"]["decode_step_s"],
             serve_sent_bytes=r["tp"]["serve"]["sent_bytes"],
             flash_shapes=r["tp"]["serve"]["flash_shapes"],
             flash_launches=r["tp"]["serve"]["launches"]["flash_attention"],
             flash=r["tp"]["flash"],
             max_memory_allocated=r["tp"]["max_memory_allocated"])
             for r in ranks],
         launches=launches, script_s=time.perf_counter() - t_script)
    return launches


def _mesh_seq_check(ranks, smi, t_script):
    """Part tp's 1 x 4 line: each model's logits on every rank within
    ``MESH_TP_LOGIT_TOL`` of one device's, the cache back in its
    placements, no decode all-gather of a KV cache leaf, the flash calls
    on the rank's heads; returns their launches (the ranks', summed)."""
    from repro_torch.kernels import ops
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    models = {}
    B, S = MESH_TP_PROMPT
    for arch, layers, why, dtype in ((TRAIN_ARCH, MESH_SEQ_LAYERS,
                                      MESH_SEQ_WHY,
                                      "bfloat16"), *MESH_FAMILIES):
        tag = f"mesh/tp/1x4/{arch}"
        cfg = _seq_model(arch, layers, True, dtype)
        one = ranks[0]["tp"]["seq"][arch]["one_logits"]
        if arch == TRAIN_ARCH:
            calls = [(B, 3, 1, S, S, 128, True)] * cfg.num_layers
        else:
            per = MESH_FAMILY_FLASH[arch]
            n = _attn_per_prefill(cfg) // max(len(per), 1)
            calls = [c for c in per for _ in range(n)]
        errs = []
        for r in ranks:
            got = r["tp"]["seq"][arch]
            for step, (a, b) in enumerate(zip(got["logits"], one)):
                scale = float(np.abs(b).max())
                err = float(np.abs(a - b).max())
                require(np.isfinite(a).all() and a.shape == b.shape,
                        f"{tag}: step {step}: logits {a.shape}")
                require(err <= MESH_TP_LOGIT_TOL * scale,
                        f"{tag}: step {step}: the TP logits are {err} from "
                        f"one device's (tolerance {MESH_TP_LOGIT_TOL} x "
                        f"{scale})")
                errs.append(err / scale)
            require(got["cache_placed"], f"{tag}: the returned cache is not "
                    f"the placed tree")
            require(got["cache_gathers"] == 0, f"{tag}: {got['cache_gathers']}"
                    f" decode all-gathers moved a KV cache leaf")
            want = sorted([b_, h, s, d, kv, c] for b_, h, kv, s, _, d, c
                          in calls)
            require(sorted(got["flash_shapes"]) == want,
                    f"{tag}: flash ran at {got['flash_shapes']}")
            require(got["launches"]["flash_attention"] == len(calls),
                    f"{tag}: {got['launches']['flash_attention']} flash "
                    f"launches a rank")
            for k, v in got["launches"].items():
                launches[k] += v
        if arch == TRAIN_ARCH:
            require(ranks[0]["tp"]["seq"][arch]["cache_local"]["k"][3] ==
                    MESH_SEQ_CACHE // MESH_RANKS,
                    f"{tag}: the cache's sequence is not split 4 ways")
        models[arch] = dict(
            layers=cfg.num_layers, dtype=dtype,
            reduced=None if layers is None or layers == _model_layers(arch)
            else dict(key="num_layers", published=_model_layers(arch),
                      run=layers, why=why),
            max_rel_err=max(errs),
            # every rank's bytes after placing, and without the whole
            # params rank 0 keeps for its one-device run: its shards
            allocated_after_placing=[r["tp"]["seq"][arch][
                "allocated_after_placing"] for r in ranks],
            placed_after_placing=[r["tp"]["seq"][arch][
                "allocated_after_placing"] - r["tp"]["seq"][arch][
                "whole_params_kept"] for r in ranks],
            per_rank=[{k: r["tp"]["seq"][arch][k] for k in (
                "prefill_s", "decode_step_s", "sent_prefill",
                "sent_prefill_decode", "cache_local", "decode_gathers",
                "cache_gathers", "allocated_after_placing",
                "whole_params_kept", "max_memory_allocated")} | dict(
                flash_launches=r["tp"]["seq"][arch]["launches"][
                    "flash_attention"]) for r in ranks],
            flash_calls=sorted({tuple(c) for c in ranks[0]["tp"]["seq"][
                arch]["flash_shapes"]}))
    emit("mesh", part="tp", card=smi, backend="gloo", ranks=MESH_RANKS,
         mesh="1x4", device="cuda:0",
         tokens=dict(qwen2=list(MESH_TP_PROMPT), families=list(
             MESH_FAMILY_PROMPT)),
         decode=dict(qwen2=MESH_TP_DECODE, families=MESH_FAMILY_DECODE),
         cache_len=dict(qwen2=MESH_SEQ_CACHE),
         tolerance=f"{MESH_TP_LOGIT_TOL} of max |logit| of one device with "
                   f"plain attention",
         models=models, launches=launches,
         script_s=time.perf_counter() - t_script)
    return launches


def _model_layers(arch):
    from repro_torch.launch.specs import model_cfg_for
    return model_cfg_for(arch).num_layers


def _mesh_moe_check(ranks, n_model, dev, seed, tag):
    """The ranks' y blocks (one per data rank; the model ranks of a block
    bit-equal) against ``moe_forward`` on the whole batch."""
    from repro_torch.models.moe import moe_forward
    out = {}
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
        cfg, p, x = _mesh_moe_case(dtype, dev, seed)
        t0 = time.perf_counter()
        want, aux = moe_forward(cfg, p, x)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        want = want.float().cpu().numpy()
        scale = float(np.abs(want).max())
        del p, x
        torch.cuda.empty_cache()
        for fn in ("moe_forward_shardmap", "moe_forward_shardmap_ep"):
            key = f"{fn}/{dtype}"
            blocks = [r["moe"][key]["y"] for r in ranks[::n_model]]
            for i, r in enumerate(ranks):
                require(np.array_equal(r["moe"][key]["y"],
                                       blocks[i // n_model]),
                        f"mesh/{tag}: {key}: the model ranks of a batch "
                        f"block disagree")
            err = float(np.abs(np.concatenate(blocks) - want).max())
            require(err <= tol * scale, f"mesh/{tag}: {key} is {err} from "
                    f"moe_forward (tolerance {tol} x {scale})")
            out[key] = dict(max_abs_err=err, rel_err=err / scale,
                            tolerance=tol,
                            aux_err=abs(ranks[0]["moe"][key]["aux"]
                                        - float(aux)),
                            warm_s=[r["moe"][key]["warm_s"] for r in ranks],
                            moe_forward_s=ref_s)
    return out


def _mesh_dryrun(dev):
    """The dry run's mesh records on the card: qwen2-1.5b x train_4k on
    16 x 16 and 2 x 16 x 16, mixtral-8x7b x decode_32k on 16 x 16 with
    the all-to-all lever; per-rank param bytes equal to param_pspec's."""
    import types
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models import init_params
    recs = []
    for arch, shape, mp, a2a in (("qwen2-1.5b", "train_4k", False, False),
                                 ("qwen2-1.5b", "train_4k", True, False),
                                 (MESH_MOE_ARCH, "decode_32k", False, True)):
        rec = run_cell(arch, shape, device=dev, multi_pod=mp,
                       moe_alltoall=a2a)
        require(rec["status"] == "ok", f"mesh/dryrun: {arch} x {shape}")
        names = ("pod", "data", "model") if mp else ("data", "model")
        fake = types.SimpleNamespace(axis_names=names, shape=dict(
            zip(names, (2, 16, 16) if mp else (16, 16))))
        cfg = model_cfg_for(arch)
        leaves, _ = shd.keyed_leaves(init_params(cfg, None, "meta"))
        want = sum(shd.local_numel(tuple(l.shape), shd.param_pspec(
            cfg, fake, k, l.ndim, tuple(l.shape), moe_ep=a2a), fake)
            * l.element_size() for k, l in leaves)
        require(rec["param_bytes_per_rank"] == want,
                f"mesh/dryrun: {arch} per-rank param bytes "
                f"{rec['param_bytes_per_rank']} != {want}")
        require(rec["roofline"]["t_collective"] > 0,
                f"mesh/dryrun: {arch} counted no collective")
        recs.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "chips", "param_bytes_per_rank",
            "collective_bytes_per_chip", "flops_per_chip", "bytes_per_chip",
            "roofline", "lower_s", "compile_s")})
    return recs


def _mesh_dryrun_cluster(dev):
    """The cluster step's dry-run records on the card (rank 1 of 16 x 16
    and 2 x 16 x 16, kernel plane): (the records' lines, the launches of
    the part).  Each distance kernel's counted FLOPs must equal 3·d per
    (row, candidate) slot summed over the calls made under the
    accountant."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from repro_torch.kernels import ops
    from repro_torch.launch import costs
    from repro_torch.launch.dryrun import run_cluster_cell
    names = ("eps_count_batch", "row_min_batch")
    real = {k: getattr(ops, k) for k in names}
    shapes = {k: [] for k in names}

    def keeping(name):
        def call(a, b, *args, **kw):
            if any(isinstance(m, costs.CostMode)
                   for m in _get_current_dispatch_mode_stack()):
                shapes[name].append((*a.shape, b.shape[1]))
            return real[name](a, b, *args, **kw)
        return call

    before = dict(ops.LAUNCHES)
    lines = []
    for name in names:
        setattr(ops, name, keeping(name))
    try:
        for mp in (False, True):
            for v in shapes.values():
                v.clear()
            rec = run_cluster_cell(mp, device=dev)
            tag = f"mesh/dryrun: grit-cluster-step x {rec['mesh']}"
            require(rec["status"] == "ok" and rec["attempts"][-1] == (),
                    f"{tag}: {rec['status']}, trail {rec['attempts']}")
            coll = rec["collective_bytes_per_chip"]
            require(coll.get("collective-permute") == rec["sent"]["exchange"]
                    > 0, f"{tag}: permute {coll} != sent {rec['sent']}")
            require(rec["roofline"]["t_collective"] > 0,
                    f"{tag}: counted no collective")
            require(rec["caps"]["use_kernels"], f"{tag}: plain plane")
            kernels = {}
            for name in names:
                live = [(B, M, d, N) for B, M, d, N in shapes[name] if B * M]
                formula = sum(3.0 * d * B * M * N for B, M, d, N in live)
                got = rec["kernel_ops"].get(f"repro_torch.{name}",
                                            {"calls": 0, "flops": 0.0})
                require(got["calls"] == len(live) > 0 and
                        got["flops"] == formula,
                        f"{tag}: {name}: {got} counted, {len(live)} calls "
                        f"with rows, {formula} FLOPs by the formula")
                kernels[name] = dict(calls=len(live), formula_flops=formula,
                                     counted_flops=got["flops"],
                                     bytes=got["bytes"])
            lines.append({**{k: rec[k] for k in (
                "arch", "shape", "mesh", "kind", "chips", "rank", "caps",
                "attempts", "halo_live", "sent", "core_points",
                "collective_bytes_per_chip", "flops_per_chip",
                "bytes_per_chip", "kernel_flops", "roofline", "lower_s",
                "compile_s", "fake_group", "ghosts")}, "kernels": kernels})
    finally:
        for name in names:
            setattr(ops, name, real[name])
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for name in names:
        require(launches[name] > 0, f"mesh/dryrun: the cluster records "
                f"never launched {name}")
    return lines, launches


def mesh_phase(pts, eps, mesh_carry, fit, seed, dev, smi, t_script):
    """Phase ``mesh``: one line a part (module docstring).  Returns the
    mesh path's launches: the gloo ranks' cold fits and TP prefills and
    the NCCL ranks' fits, each rank's counts set to 0 just before and
    read just after in its own process."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_ranks

    caps, loop = mesh_carry
    n_cards = torch.cuda.device_count()
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.empty_cache()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        pts_path = os.path.join(tmp, "points.npy")
        np.save(pts_path, pts)
        # ---- gloo: MESH_RANKS ranks on the one card ----------------------
        t0 = time.perf_counter()
        ranks = spawn_ranks(mesh_gloo_rank, MESH_RANKS, backend="gloo",
                            device="cuda:0",
                            args=(pts_path, eps, caps, seed), timeout=600,
                            workdir=tmp)
        gloo_s = time.perf_counter() - t0
        fields = ("labels", "core", "point_grid", "shard_of", "cut_coords")
        for r in ranks:
            f = r["fit"]
            for name in fields:
                require(np.array_equal(f[name], getattr(loop, name)),
                        f"mesh/fit: a rank's {name} differs from phase "
                        f"sharded's in-process 4-shard fit")
            require(f["report"] == loop.report.as_vector().tolist(),
                    "mesh/fit: the report differs")
            for k in ("eps_count_batch", "row_min_batch"):
                require(f["launches"][k] > 0, f"mesh/fit: a rank never "
                        f"launched {k}")
            for k, v in f["launches"].items():
                launches[k] += v
        emit("mesh", part="fit", card=smi, backend="gloo",
             ranks=MESH_RANKS, mesh="2x2", device="cuda:0", n=len(pts),
             raw_equal_to_sharded=True,
             cold_s=[r["fit"]["cold_s"] for r in ranks],
             warm_s=[r["fit"]["warm_s"] for r in ranks],
             sent_bytes=[r["fit"]["sent_bytes"] for r in ranks],
             launches_per_rank=[r["fit"]["launches"] for r in ranks],
             spawn_s=gloo_s, script_s=time.perf_counter() - t_script)
        moe_gloo = _mesh_moe_check(ranks, 2, dev, seed, "gloo")
        for k, v in _mesh_tp_check(ranks, smi, t_script).items():
            launches[k] += v
        for k, v in _mesh_seq_check(ranks, smi, t_script).items():
            launches[k] += v
        del ranks
        # ---- NCCL: one rank per card --------------------------------------
        t0 = time.perf_counter()
        nccl = spawn_ranks(mesh_nccl_rank, n_cards, backend="nccl",
                           device=None, args=(pts_path, eps, seed),
                           timeout=600, workdir=tmp)
        nccl_s = time.perf_counter() - t0
    for r in nccl:
        f = r["fit"]
        require(f["overflow"] == [] and f["use_kernels"],
                f"mesh/fit: the NCCL fit ran {f['overflow']}")
        require(np.array_equal(f["core"], fit.core),
                "mesh/fit: NCCL core flags differ from the single-device "
                "fit's")
        lookup = label_map(f["labels"], fit.labels, fit.core)
        require(lookup is not None, "mesh/fit: the NCCL fit's core "
                "partition differs from the single-device fit's")
        require(np.array_equal(f["labels"] == -1, fit.labels == -1),
                "mesh/fit: the NCCL fit's noise differs")
        got = mapped(lookup, f["labels"])
        rows = np.flatnonzero(got != fit.labels)
        require(not fit.core[rows].any(), "mesh/fit: a core point is "
                "labelled otherwise")
        pts64 = torch.as_tensor(pts, dtype=torch.float64, device=dev)
        bad = contested_ok(pts64, torch.as_tensor(fit.core, device=dev),
                           torch.as_tensor(fit.labels, device=dev), rows,
                           got[rows], eps * eps)
        del pts64
        require(bad == 0, f"mesh/fit: {bad} NCCL border labels differ "
                f"from the single-device fit's without being contested")
        r["fit"]["contested_borders_differing"] = int(len(rows))
        for k, v in f["launches"].items():
            launches[k] += v
    emit("mesh", part="fit", card=smi, backend="nccl", ranks=n_cards,
         mesh=f"{n_cards}x1", fit_s=[r["fit"]["s"] for r in nccl],
         attempts=[r["fit"]["attempts"] for r in nccl],
         launches_per_rank=[r["fit"]["launches"] for r in nccl],
         partition_equal_to_single_device=True,
         contested_borders_differing=[
             r["fit"]["contested_borders_differing"] for r in nccl],
         spawn_s=nccl_s,
         script_s=time.perf_counter() - t_script)
    emit("mesh", part="moe", card=smi, arch=MESH_MOE_ARCH,
         tokens=list(MESH_MOE_TOKENS), capacity="E / K (drops nothing)",
         gloo_2x2=moe_gloo,
         nccl=_mesh_moe_check(nccl, 1, dev, seed, "nccl"),
         script_s=time.perf_counter() - t_script)
    for r in nccl:
        t = r["train"]
        require(t["loss_err"] < 1e-4 and t["param_tolerance_excess"] <= 0,
                f"mesh/train: the mesh step differs from the single-device "
                f"step: {t}")
    emit("mesh", part="train", card=smi, arch=TRAIN_ARCH, backend="nccl",
         mesh=f"{n_cards}x1", tokens=list(MESH_TRAIN_TOKENS),
         tolerance="loss 1e-4; params rtol 2e-4, atol 1e-5",
         ranks=[r["train"] for r in nccl],
         script_s=time.perf_counter() - t_script)
    t0 = time.perf_counter()
    recs = _mesh_dryrun(dev)
    cluster, cluster_launches = _mesh_dryrun_cluster(dev)
    for k, v in cluster_launches.items():
        launches[k] += v
    emit("mesh", part="dryrun", card=smi, records=recs, cluster=cluster,
         cluster_launches=cluster_launches,
         seconds=time.perf_counter() - t0,
         script_s=time.perf_counter() - t_script)
    return launches


# --------------------------------------------------------------------------
# guard-band kernels vs their plain versions
# --------------------------------------------------------------------------

def compare_band(ops_mod, a, b, lo, hi, vb, stop):
    """Launch ``eps_count_band_batch``, hold it against the plain
    version's full counts: equal where the row's lo count is below its
    bar (every row without a bar), 0 where the bar is <= 0 (an exempt
    row), never above elsewhere."""
    from repro_torch.kernels.ops import eps_count_band_batch_plain
    glo, ghi = ops_mod.eps_count_band_batch(a, b, lo, hi, vb, stop)
    torch.cuda.synchronize()
    wlo, whi = eps_count_band_batch_plain(a, b, lo, hi, vb)
    done = torch.ones_like(glo, dtype=torch.bool) if stop is None \
        else glo < stop
    exempt = torch.zeros_like(done) if stop is None else stop <= 0
    diff = max(int(((glo - wlo).abs() * done).max().item()),
               int(((ghi - whi).abs() * done).max().item()),
               int(((glo.abs() + ghi.abs()) * exempt).max().item())) \
        if glo.numel() else 0
    over = bool((glo > wlo).any() or (ghi > whi).any())
    return diff, over


def compare_min2(ops_mod, a, b, vb):
    """(max abs error of min and runner-up on finite rows, rtol-1e-6
    ok, argmin mismatches, inf pattern ok)."""
    from repro_torch.kernels.ops import row_min2_batch_plain
    gm, gm2, gi = ops_mod.row_min2_batch(a, b, vb)
    torch.cuda.synchronize()
    wm, wm2, wi = row_min2_batch_plain(a, b, vb)
    err, rel_ok, inf_ok = 0.0, True, True
    for g, w in ((gm, wm), (gm2, wm2)):
        inf_ok &= bool((torch.isinf(g) == torch.isinf(w)).all())
        fin = ~torch.isinf(w)
        if w.numel():
            err = max(err, float(((g - w).abs() * fin).nan_to_num(0.0)
                                 .max().item()))
        rel_ok &= bool((((g - w).abs() <= 1e-6 * w.abs()) | ~fin).all())
    return err, rel_ok, int((gi != wi).sum().item()), inf_ok


def _band_work(vb, B, P, C, d, n_out):
    """(bound ms, by, pairs) of a guard-band call that scans every (row,
    valid candidate) pair."""
    pairs = float(P) * float(vb.sum().item())
    nbytes = (4.0 * d * B * P + 4.0 * d * float(vb.sum().item()) + B * C
              + 4.0 * n_out * B * P)
    return (*_bound(nbytes, 3.0 * d * pairs), pairs)


def edge_bars(va, seed, k=5):
    """Per-row bars in [0, k] for the band kernel on an edge lattice, 0
    (exempt) on the rows that ``va`` marks dead, as the fit's padded rows
    are."""
    rng = np.random.default_rng(seed)
    bar = torch.as_tensor(rng.integers(0, k + 1, tuple(va.shape))
                          .astype(np.int32)).to(va.device)
    return torch.where(va, bar, 0).to(torch.int32).contiguous()


def guard_band_phase(captured_fit, predict_call, eps_lo, eps_hi, dev,
                     baseline=None):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ops import (eps_count_band_batch_plain,
                                         row_min2_batch_plain)
    cases = 0
    # 1. integer lattices (duplicated candidates, one valid candidate in
    # a slot, an all-masked slot): everything equal
    shapes = [(1, 1, 1, 1), (3, 5, 7, 2), (2, 17, 130, 3), (4, 127, 129, 4),
              (2, 64, 1300, 5), (3, 63, 600, 3), (2, 9, 260, 7),
              (5, 63, 2048, 3)]
    for i, (B, P, C, d) in enumerate(shapes):
        for dup in (False, True):
            a, b, vb, _ = lattice_inputs(B, P, C, d, 300 + i, dev, dup)
            if B > 2:
                vb[1] = False
                vb[1, C // 3] = True
            rng = np.random.default_rng(400 + i)
            for bar in (None, 0, 2, 5, 1000):
                stop = None if bar is None else torch.as_tensor(
                    rng.integers(0, bar + 1, (B, P)).astype(np.int32)).to(dev)
                diff, over = compare_band(ops, a, b, 15.0, 17.0, vb, stop)
                require(diff == 0 and not over, f"eps_count_band_batch "
                        f"differs on lattice {(B, P, C, d)} dup={dup} "
                        f"bar={bar}: {diff}")
            err, _, mism, inf_ok = compare_min2(ops, a, b, vb)
            require(err == 0.0 and mism == 0 and inf_ok, f"row_min2_batch "
                    f"differs on lattice {(B, P, C, d)} dup={dup}: "
                    f"err={err} argmin={mism}")
            cases += 6
    # 1b. the edge shapes of the warp-per-task design (50,000 slots, rows
    # around the lane counts, dead slots between live ones, ties across
    # phase and split boundaries, d = 7), with and without bars
    for i, (B, P, C, d, dead, pairs) in enumerate(EDGE_SHAPES):
        a, b, vb, va = lattice_inputs(B, P, C, d, 600 + i, dev, True, dead,
                                      pairs)
        for stop in (None, edge_bars(va, 700 + i),
                     edge_bars(va, 800 + i, 1000)):
            diff, over = compare_band(ops, a, b, 15.0, 17.0, vb, stop)
            require(diff == 0 and not over, f"eps_count_band_batch differs "
                    f"on edge lattice {(B, P, C, d)} (bars: "
                    f"{stop is not None}): {diff}")
        err, _, mism, inf_ok = compare_min2(ops, a, b, vb)
        require(err == 0.0 and mism == 0 and inf_ok, f"row_min2_batch "
                f"differs on edge lattice {(B, P, C, d)}: err={err} "
                f"argmin={mism}")
        cases += 4
    # 2. random reals: d2 within rtol 1e-6, counts equal outside the
    # rows with a candidate inside that band of either threshold
    band_rows = 0
    for i, (B, P, C, d) in enumerate(shapes):
        rng = np.random.default_rng(500 + i)
        a = torch.as_tensor(rng.normal(size=(B, P, d)) * 10,
                            dtype=torch.float32).to(dev)
        b = torch.as_tensor(rng.normal(size=(B, C, d)) * 10,
                            dtype=torch.float32).to(dev)
        vb = torch.as_tensor(rng.uniform(size=(B, C)) > 0.3).to(dev)
        glo, ghi = ops.eps_count_band_batch(a, b, 5.5, 6.5, vb)
        wlo, whi = eps_count_band_batch_plain(a, b, 5.5, 6.5, vb)
        d2 = ops.sq_dists_direct(a, b)
        in_band = torch.zeros_like(glo, dtype=torch.bool)
        for t2 in (5.5 ** 2, 6.5 ** 2):
            in_band |= (((d2 - t2).abs() <= t2 * 1e-6) & vb[:, None, :]
                        ).any(dim=2)
        band_rows += int(in_band.sum().item())
        require(bool((((glo == wlo) & (ghi == whi)) | in_band).all()),
                f"eps_count_band_batch differs outside the band "
                f"{(B, P, C, d)}")
        err, rel_ok, _, inf_ok = compare_min2(ops, a, b, vb)
        require(rel_ok and inf_ok, f"row_min2_batch beyond rtol 1e-6 "
                f"{(B, P, C, d)}")
        cases += 2

    # 3. the largest kernel-mode predict call: both kernels, timed (the
    # summary rows; ``time_distance``: ms eager, graph_ms device time over
    # rotated copies, parent_* beside them when a baseline build is
    # given), the band at the served index's thresholds
    lib = ops._lib()
    a, b, vb = predict_call
    B, P, d = a.shape
    C = b.shape[1]
    err, rel_ok, mism, inf_ok = compare_min2(ops, a, b, vb)
    require(err == 0.0 and mism == 0 and inf_ok, f"row_min2_batch differs "
            f"from its plain version on the predict call: err={err} "
            f"argmin={mism}")
    bound, by, pairs = _band_work(vb, B, P, C, d, 3)
    rows = [dict(name="row_min2_batch", shape=[B, P, C, d],
                 kernel_route=ops.pairwise_route(d), max_abs_err=float(err),
                 **time_distance(lib, baseline, "row_min2_batch", (a, b, vb),
                                 lambda: ops.row_min2_batch(a, b, vb)),
                 plain_ms=cuda_ms(lambda: row_min2_batch_plain(a, b, vb),
                                  reps=2, warmup=1),
                 bound_ms=bound, bound_by=by,
                 floor_ms=floor_ms("row_min2_batch", pairs, d, P))]
    diff, over = compare_band(ops, a, b, eps_lo, eps_hi, vb, None)
    require(diff == 0 and not over, f"eps_count_band_batch differs from its "
            f"plain version on the predict call: {diff}")
    bound, by, pairs = _band_work(vb, B, P, C, d, 2)
    rows.append(dict(
        name="eps_count_band_batch", shape=[B, P, C, d],
        kernel_route=ops.pairwise_route(d), max_abs_err=float(diff),
        **time_distance(lib, baseline, "eps_count_band_batch",
                        (a, b, vb, None, eps_lo, eps_hi),
                        lambda: ops.eps_count_band_batch(a, b, eps_lo,
                                                         eps_hi, vb)),
        plain_ms=cuda_ms(lambda: eps_count_band_batch_plain(
            a, b, eps_lo, eps_hi, vb), reps=2, warmup=1),
        bound_ms=bound, bound_by=by,
        floor_ms=floor_ms("eps_count_band_batch", pairs, d, P)))
    cases += 2

    # 4. the fit's captured eps_count_batch inputs at every width, band
    # thresholds of the served index, with the MinPts bar on live rows
    # (0 on padded rows) and without a bar; timed as the predict call;
    # with the bar, bound and floor count the pairs the bar leaves
    tiers = []
    for C in sorted(captured_fit):
        (a, b, vb, va, _, _), _ = captured_fit[C]
        B, P, d = a.shape
        stop = torch.where(va, MIN_PTS, 0).to(torch.int32).contiguous()
        for bar in (stop, None):
            diff, over = compare_band(ops, a, b, eps_lo, eps_hi, vb, bar)
            require(diff == 0 and not over, f"eps_count_band_batch differs "
                    f"on the fit's inputs at width {C} (bar: "
                    f"{bar is not None}): {diff}")
            bound, by, pairs = (_band_work(vb, B, P, C, d, 2) if bar is None
                                else _work_to_bars(a, b, vb, eps_lo, bar, 4,
                                                   2))
            tiers.append(dict(
                shape=[B, P, C, d], stop_row=bar is not None, pairs=pairs,
                max_abs_err=float(diff),
                **time_distance(lib, baseline, "eps_count_band_batch",
                                (a, b, vb, bar, eps_lo, eps_hi),
                                lambda: ops.eps_count_band_batch(
                                    a, b, eps_lo, eps_hi, vb, bar)),
                plain_ms=cuda_ms(lambda: eps_count_band_batch_plain(
                    a, b, eps_lo, eps_hi, vb), reps=2, warmup=1),
                bound_ms=bound, bound_by=by,
                floor_ms=floor_ms("eps_count_band_batch", pairs, d, P)))
            cases += 1
    return rows, tiers, cases, band_rows


# --------------------------------------------------------------------------
# flash attention vs its plain version
# --------------------------------------------------------------------------

# (case, B, H, H_kv, Sq, Sk, D, dtype, causal, window, softcap); the first
# is the lm path's prefill call (qwen2-1.5b: 12 query heads, 2 KV heads)
FLASH_CASES = [
    ("qwen2_prefill_gqa", 4, 12, 2, 2048, 2048, 128, "bfloat16", True, None,
     None),
    ("qwen2_prefill", 4, 12, 12, 2048, 2048, 128, "bfloat16", True, None,
     None),
    ("prefill_8192", 1, 12, 12, 8192, 8192, 128, "bfloat16", True, None, None),
    ("gemma2_local", 1, 32, 32, 8192, 8192, 128, "bfloat16", True, 4096,
     50.0),
    ("noncausal", 2, 8, 8, 1500, 1500, 64, "float32", False, None, None),
    ("decode", 4, 12, 12, 1, 4100, 128, "bfloat16", True, None, None),
    ("chunked_prefix", 2, 12, 12, 64, 192, 128, "bfloat16", True, None, None),
    ("unaligned", 2, 12, 12, 100, 100, 128, "float32", True, None, None),
    ("head_dim_16", 2, 8, 8, 1000, 1000, 16, "float32", True, 256, None),
    ("head_dim_32", 2, 8, 8, 1000, 1000, 32, "bfloat16", True, None, 30.0),
    ("head_dim_80", 1, 32, 32, 2048, 2048, 80, "bfloat16", True, None, None),
    # mixtral's 8,192-token prefill: window 4,096, 32 heads on 8 KV heads
    ("mixtral_prefill_8192_swa", 1, 32, 8, 8192, 8192, 128, "bfloat16", True,
     4096, None),
    # the families phase's prefill calls of its batch (b), 4 x 2,048
    ("mixtral_prefill", 4, 32, 8, 2048, 2048, 128, "bfloat16", True, 4096,
     None),
    ("arctic_prefill", 4, 56, 8, 2048, 2048, 128, "bfloat16", True, None,
     None),
    ("zamba2_prefill", 4, 32, 32, 2048, 2048, 80, "bfloat16", True, None,
     None),
    # whisper-small's prefill calls of batch (b): the encoder's self-
    # attention over 1,500 frames, the decoder's cross-attention of a
    # 256-token bucket to them (non-causal, ragged Sk); a cross-attention
    # with more queries than keys (a negative q_offset); internvl2-1b's
    # prefill of batch (b), 256 patches + 2,048 tokens, 14 heads on 2
    ("whisper_encoder", 4, 12, 12, 1500, 1500, 64, "bfloat16", False, None,
     None),
    ("whisper_cross", 4, 12, 12, 256, 1500, 64, "bfloat16", False, None,
     None),
    ("cross_sq_over_sk", 2, 12, 12, 2048, 1500, 64, "bfloat16", False, None,
     None),
    ("internvl2_prefill", 4, 14, 2, 2304, 2304, 64, "bfloat16", True, None,
     None),
    # a tensor-parallel rank's prefill call on the 2 x 2 mesh (phase
    # mesh, part tp): 2 of qwen2's 4 prompts, 6 of its 12 heads on 1 of
    # its 2 KV heads
    ("qwen2_prefill_tp_local", *MESH_TP_FLASH, "bfloat16", True, None,
     None),
    # the rank calls of part tp's 1 x 4 mesh: qwen2's 4 prompts on 3 heads
    # and their 1 KV head; whisper's encoder, decoder self- and cross-
    # attention on 3 of 12 heads; zamba2's shared block on 8 of 32, in
    # float32 (the scalar route)
    ("qwen2_prefill_tp_seq", *MESH_SEQ_FLASH, "bfloat16", True, None, None),
    *((f"{arch.split('-')[0]}_tp_{i}", b, h, kv, sq, sk, d, dtype, c,
       None, None)
      for arch, _, _, dtype in MESH_FAMILIES
      for i, (b, h, kv, sq, sk, d, c) in enumerate(MESH_FAMILY_FLASH[arch])),
]
# the kernel against its plain version, elementwise |got - want| <=
# rtol·|want| + atol, and mean |got - want| <= FLASH_MEAN_REL·mean |want|.
# float32: the reference's flash tolerance.  bfloat16: both sides round
# the same float32 function to bf16, so they may differ by one bf16 ulp
# of the output (at most 2^-7 of it) plus the float32 rounding of the sums
FLASH_TOL = {"float32": (0.0, 2e-4), "bfloat16": (2.0 ** -7, 1e-4)}
FLASH_MEAN_REL = 1e-3


def sdpa_call(q, k, v, causal, window, softcap):
    """One ``F.scaled_dot_product_attention`` call computing the same
    function (timed as a yardstick only; the port never calls it), or
    None where none does (the tanh soft-cap).  With fewer KV heads and a
    mask, k / v are broadcast to every query head before the timed call
    (the library's masked backends take no GQA map).  A window of Sk or
    more keys masks nothing, and is dropped."""
    import torch.nn.functional as F
    if softcap is not None:
        return None
    Sq, Sk = q.shape[2], k.shape[2]
    if window is not None and window >= Sk:
        window = None
    if k.shape[1] != q.shape[1]:
        if causal and window is None and Sq == Sk:
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        group = q.shape[1] // k.shape[1]
        k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
    if causal and window is None and Sq == Sk:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    if bool(mask.all()):
        return lambda: F.scaled_dot_product_attention(q, k, v)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def flash_build_report():
    """The bf16 head-dim-128 kernel (``flash_wgmma_kernel<128>``) as built:
    registers, stack and spill bytes from the ptxas report that the build
    keeps beside the library, and its count of HGMMA (tensor-core)
    instructions in the SASS, or of ``wgmma.mma_async`` in the PTX where
    the toolkit has no ``cuobjdump``."""
    from repro_torch.kernels import build
    tag = "flash_wgmma_kernelILi128E"
    lines = build.log_path("flash_attention").read_text().splitlines()
    rep = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and tag in line:
            for nxt in lines[i + 1:i + 4]:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", nxt)
                if m:
                    rep.update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    rep["registers"] = int(m.group(1))
    lib = build._target("flash_attention")[1]
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin")
    cuobjdump = shutil.which("cuobjdump") or shutil.which(
        "cuobjdump", path=cuda_bin)
    if cuobjdump:
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        body = [f for f in re.split(r"\n\s*Function : ", sass)
                if f.split("\n", 1)[0].find(tag) >= 0]
        rep.update(tensor_instr="HGMMA in SASS",
                   tensor_instr_count=sum(f.count("HGMMA") for f in body))
    else:
        ptx = lib.with_suffix(".ptx")
        subprocess.run([shutil.which("nvcc") or os.path.join(cuda_bin, "nvcc"),
                        *build.flags("flash_attention")[:4], "-ptx", "-o",
                        str(ptx), str(build.CSRC / "flash_attention.cu")],
                       capture_output=True, timeout=300, check=True)
        rep.update(tensor_instr="wgmma.mma_async in PTX",
                   tensor_instr_count=ptx.read_text().count("wgmma.mma_async"))
    require({"registers", "spill_store_bytes"} <= rep.keys(),
            f"no ptxas report of {tag} in the build log")
    require(rep["spill_store_bytes"] == 0 and rep["spill_load_bytes"] == 0,
            f"the bf16 flash kernel spills registers: {rep}")
    require(rep["tensor_instr_count"] > 0,
            f"the bf16 flash kernel has no tensor-core instruction: {rep}")
    return rep


def flash_phase(dev, seed):
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed + 40_000)
    rows = []
    for name, B, H, Hkv, Sq, Sk, D, dt, causal, window, cap in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, h, n, D), generator=gen, device=dev)
                   .to(dtype) for h, n in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
        kw = dict(causal=causal, window=window, softcap=cap)
        route = ops.flash_route(dtype, D)
        require(route == ("wgmma" if dt == "bfloat16" else "scalar"),
                f"flash_attention {name}: route {route} for {dt}")
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ops.flash_attention_plain(q, k, v, **kw)
        require(got.dtype == dtype and bool(torch.isfinite(got).all()),
                f"flash_attention {name}: wrong dtype or non-finite output")
        rtol, atol = FLASH_TOL[dt]
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        err = float(diff.max().item())
        # the largest error as a share of its element's bound (<= 1 passes)
        worst = float((diff / (rtol * mag + atol)).max().item())
        mean_rel = float((diff.mean() / mag.mean()).item())
        require(worst <= 1.0 and mean_rel <= FLASH_MEAN_REL,
                f"flash_attention differs from its plain version on {name}: "
                f"max abs {err}, {worst} of the elementwise bound, mean "
                f"{mean_rel} of mean |want|")
        del got, want, diff, mag
        esize = q.element_size()
        nbytes = esize * 2.0 * B * (H * Sq + Hkv * Sk) * D
        nops = 4.0 * D * B * H * ops.live_pairs(Sq, Sk, causal, window)
        peak = PEAK_BF16_OPS_S if dt == "bfloat16" else PEAK_F32_OPS_S
        tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak * 1e3
        lib = sdpa_call(q, k, v, causal, window, cap)
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw))
        library_ms = None if lib is None else cuda_ms(lib)
        # where a window binds, the library has no call that skips the
        # tiles it masks: causal SDPA over the same tokens (more pairs
        # than the window's, but its masked tiles skipped) is timed beside
        causal_lib = None
        if window is not None and window < Sk and causal:
            causal_lib = sdpa_call(q, k, v, True, None, cap)
        rows.append(dict(
            case=name, shape=[B, H, Sq, Sk, D], kv_heads=Hkv, dtype=dt,
            causal=causal, window=window, softcap=cap, route=route,
            max_abs_err=err, bound_share=worst, mean_rel_err=mean_rel,
            tolerance=dict(rtol=rtol, atol=atol, mean_rel=FLASH_MEAN_REL),
            ms=ms,
            plain_ms=cuda_ms(lambda: ops.flash_attention_plain(q, k, v, **kw),
                             reps=2, warmup=1),
            bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
            library_ms=library_ms,
            vs_library=None if library_ms is None else ms / library_ms,
            library_causal_ms=None if causal_lib is None
            else cuda_ms(causal_lib)))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# lm: qwen2-1.5b served through the flash kernel
# --------------------------------------------------------------------------

LM_ARCH = "qwen2-1.5b"
LM_NEW = 16
TOP_KERNELS = 6          # kernels by device time in a profiled prefill


def _first_groups(tree, n):
    if isinstance(tree, dict):
        return {k: _first_groups(v, n) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_first_groups(v, n) for v in tree)
    return tree[:n]


def _serve_part(cfg, params, reqs, slots, max_len, dev, flash_per_prefill=None,
                tag="lm"):
    """Serve ``reqs`` with the launch counts at 0; returns the part's
    readings and its launches.  Each prefill must launch flash
    ``flash_per_prefill`` times (default: once a layer)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_requests
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stats = {}
    t0 = time.perf_counter()
    done = serve_requests(cfg, params, reqs, batch_slots=slots,
                          max_len=max_len, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    n_prefill = len(stats["prefill_s"])
    per = cfg.num_layers if flash_per_prefill is None else flash_per_prefill
    # exactly ``per`` a prefill and none in any decode step
    require(launches["flash_attention"] == per * n_prefill,
            f"{tag}: {launches['flash_attention']} flash_attention launches "
            f"for {n_prefill} prefill calls and {len(stats['decode_s'])} "
            f"decode steps, expected {per} a prefill and 0 a step")
    tokens = sum(len(r.out) for r in done)
    require(all(len(r.out) == r.max_new for r in done)
            and all(0 <= t < cfg.vocab_size for r in done for t in r.out),
            f"{tag}: a request got the wrong number of tokens or an id out "
            "of the vocabulary")
    dec = stats["decode_s"]
    return dict(
        requests=len(done), slots=slots, max_len=max_len,
        prompt_lens=[len(r.prompt) for r in done],
        prefill_len=stats["prefill_len"],
        prefill_ms=[1e3 * x for x in stats["prefill_s"]],
        decode_ms_median=1e3 * float(np.median(dec)),
        decode_ms_mean=1e3 * float(np.mean(dec)), decode_steps=len(dec),
        tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        flash_launches=launches["flash_attention"],
        flash_launches_per_prefill=launches["flash_attention"] / n_prefill,
        first_out=done[0].out[:8]), launches


def _compare_prefill(cfg, params, toks, dev, attn_per_prefill=None,
                     tag="lm", extra=None):
    """Last-position logits of one prefill of ``toks`` (and the stub
    inputs ``extra``: frames, patches) with the flash kernel and with
    the plain attention path: (max |diff| / max |logit|, greedy-token
    agreement, {True: the flash logits, False: the plain ones}).  The
    flash prefill must make no broadcast copy of the KV heads (the kernel
    reads them in place); the plain one makes two per attention
    application (``attn_per_prefill``, default one a layer)."""
    from repro_torch.launch.serve import cache_len
    from repro_torch.models import init_cache, layers, prefill
    out = {}
    real_copy = layers._broadcast_kv
    for flash in (True, False):
        c = cfg.with_overrides(use_flash_kernel=flash)
        cache = init_cache(c, toks.shape[0],
                           cache_len(c, toks.shape[1] + LM_NEW), dev)
        copies = []

        def counted(k, group):
            copies.append(group)
            return real_copy(k, group)

        layers._broadcast_kv = counted
        try:
            out[flash], _ = prefill(c, params,
                                    {"tokens": toks, **(extra or {})}, cache)
        finally:
            layers._broadcast_kv = real_copy
        per = c.num_layers if attn_per_prefill is None else attn_per_prefill
        want = 0 if flash else 2 * per
        require(len(copies) == want,
                f"{tag}: {len(copies)} KV broadcast copies in a prefill with "
                f"use_flash_kernel={flash}, expected {want}")
        del cache
        torch.cuda.empty_cache()
    f, p = out[True], out[False]
    require(bool(torch.isfinite(f).all()), f"{tag}: non-finite logits")
    rel = float((f - p).abs().max().item() / p.abs().max().item())
    agree = float((f.argmax(-1) == p.argmax(-1)).float().mean().item())
    return rel, agree, out


def _warm_prefill(cfg, params, toks, dev, reps=3, flash_per_prefill=None,
                  tag="lm", cpu_trace=True, extra=None):
    """Prefill of ``toks`` at a shape already served: host ms of ``reps``
    synchronised calls, then one call under ``torch.profiler``: the device
    ms of every kernel and of the flash kernel (``flash_per_prefill``
    launches, default one a layer), and the share of that call's wall
    time (profiler overhead included) with no kernel running.  The trace
    holds CPU activity too unless ``cpu_trace`` is False: the families
    trace device activity only, since the CPU op records of an eager
    prefill (some 800,000 for rwkv6's chunk loops) take longer to read
    back than the phase's serving; phase lm keeps both, as it has since
    its idle share was first read.  ``extra``: the stub inputs (frames,
    patches) the served batch carries."""
    from repro_torch.launch.serve import cache_len
    from repro_torch.models import init_cache, prefill
    batch = {"tokens": toks, **(extra or {})}
    n_cache = cache_len(cfg, toks.shape[1] + LM_NEW)

    def once():
        cache = init_cache(cfg, toks.shape[0], n_cache, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(cfg, params, batch, cache)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    host_ms = [once() for _ in range(reps)]
    per = cfg.num_layers if flash_per_prefill is None else flash_per_prefill
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu_trace:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    # the trace must hold every launch of the call: a trace that lost a
    # kernel record (seen once in a run of this script) is taken again,
    # once; the launch counts of ops.LAUNCHES must match either way
    shown = []
    for _ in range(2):
        from repro_torch.kernels import ops
        before = ops.LAUNCHES["flash_attention"]
        cache = init_cache(cfg, toks.shape[0], n_cache, dev)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill(cfg, params, batch, cache)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        del cache
        require(ops.LAUNCHES["flash_attention"] - before == per,
                f"{tag}: the profiled prefill launched flash "
                f"{ops.LAUNCHES['flash_attention'] - before} times, not {per}")
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Command Buffer" not in e.name]
        flash = [e for e in kern if "flash_wgmma_kernel" in e.name]
        shown.append(len(flash))
        if len(flash) == per:
            break
    require(len(flash) == per,
            f"{tag}: the profiled prefills show {shown} flash kernels")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        n = e.name[:80]
        ms, calls = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return dict(batch=list(toks.shape), host_ms=host_ms,
                cpu_traced=cpu_trace, profiled_wall_ms=wall, kernel_ms=busy,
                flash_kernel_ms=sum(e.time_range.elapsed_us()
                                    for e in flash) / 1e3,
                flash_kernels=len(flash), flash_kernels_traced=shown,
                idle_share=max(0.0, 1.0 - busy / wall), kernels=len(kern),
                top_kernels=[dict(name=n, ms=ms, calls=c)
                             for n, (ms, c) in top])


def lm_phase(dev, seed):
    """Returns (summary, per-kernel launches of the served parts)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (Request, _pow2_at_least,
                                          cli_requests)
    from repro_torch.models import count_params, init_params
    cfg = get_config(LM_ARCH).with_overrides(use_flash_kernel=True)
    require((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.num_heads,
             cfg.num_kv_heads, cfg.head_dim) == (28, 1536, 151936, 12, 2, 128),
            f"lm: {LM_ARCH} is not at its published width")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(cfg)
    params_bytes = torch.cuda.max_memory_allocated()

    parts = {}
    # (a) the reference CLI's traffic
    parts["cli"], la = _serve_part(cfg, params, cli_requests(cfg, 8, LM_NEW),
                                   4, 128, dev)
    rng = np.random.default_rng(seed + 50_000)
    long_reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                         size=int(n)).tolist(), LM_NEW)
                 for i, n in enumerate(rng.integers(1500, 2049, size=4))]
    require(_pow2_at_least(max(len(r.prompt) for r in long_reqs)) == 2048,
            "lm: the long prompts do not bucket to 2,048")
    # (b) four long prompts in one batch, then one of 8,192 tokens
    parts["long_2048"], lb = _serve_part(cfg, params, long_reqs, 4,
                                         2048 + LM_NEW, dev)
    req_8k = [Request(4, rng.integers(0, cfg.vocab_size, size=8192).tolist(),
                      LM_NEW)]
    parts["long_8192"], lc = _serve_part(cfg, params, req_8k, 1,
                                         8192 + LM_NEW, dev)
    launches = {k: la[k] + lb[k] + lc[k] for k in la}
    # the batch of (b), left-padded to its bucket as the serve loop pads it
    toks = np.zeros((4, 2048), np.int64)
    for i, r in enumerate(long_reqs):
        toks[i, 2048 - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).to(dev)
    warm = [_warm_prefill(cfg, params, toks, dev),
            _warm_prefill(cfg, params,
                          torch.tensor([req_8k[0].prompt], device=dev), dev)]

    # the batch of (b) again: flash against the plain attention path, in
    # bfloat16 at full depth and in float32 at 4 layers
    rel_bf16, agree_bf16, _ = _compare_prefill(cfg, params, toks, dev)
    require(rel_bf16 <= 3e-2, f"lm: flash and plain prefill logits differ "
            f"by {rel_bf16} of the largest logit (bfloat16)")
    cfg4 = cfg.with_overrides(num_layers=4, dtype="float32")
    params4 = dict(params, blocks=_first_groups(params["blocks"], 4))
    rel_f32, agree_f32, _ = _compare_prefill(cfg4, params4, toks, dev)
    require(rel_f32 <= 1e-3, f"lm: flash and plain prefill logits differ "
            f"by {rel_f32} of the largest logit (float32, 4 layers)")
    del params, params4
    torch.cuda.empty_cache()
    summary = dict(
        arch=LM_ARCH, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
        vocab=cfg.vocab_size, params=n_params, param_dtype=cfg.param_dtype,
        dtype=cfg.dtype, init_s=init_s, params_bytes=params_bytes,
        parts=parts, warm_prefill=warm,
        flash_vs_plain=dict(
            bf16_rel=rel_bf16, bf16_tol=3e-2, bf16_greedy_agree=agree_bf16,
            f32_4layers_rel=rel_f32, f32_tol=1e-3,
            f32_greedy_agree=agree_f32, batch=[4, 2048]))
    return summary, launches


# --------------------------------------------------------------------------
# families: the other families at their published widths
# --------------------------------------------------------------------------

# (arch, its published widths as its config states them, layers run on
# the one card (None: all), why the depth is cut); the widths are
# required before anything is cut
FAMILIES = [
    ("mixtral-8x7b",
     dict(layers=32, d_model=4096, heads=32, kv_heads=8, head_dim=128,
          d_ff=14336, vocab=32000, window=4096, experts=8, top_k=2,
          expert_d_ff=14336, dense_residual=False, param_dtype="float32"),
     8, "32 layers of float32 params need 186 GB (5.8 GB a layer)"),
    ("arctic-480b",
     dict(layers=35, d_model=7168, heads=56, kv_heads=8, head_dim=128,
          d_ff=4864, vocab=32000, window=None, experts=128, top_k=2,
          expert_d_ff=4864, dense_residual=True, param_dtype="bfloat16"),
     2, "35 layers of bfloat16 params need 953 GB (27.2 GB a layer)"),
    ("zamba2-2.7b",
     dict(layers=54, d_model=2560, heads=32, kv_heads=32, head_dim=80,
          d_ff=10240, vocab=32000, ssm_state=64, ssm_heads=80,
          shared_attn_every=6, chunk=256, param_dtype="float32"),
     12, "the script's wall time, within 970 s: its 54 layers took 29 s of a "
         "1,029 s run on an H100; 2 of 9 shared-block applications"),
    ("rwkv6-3b",
     dict(layers=32, d_model=2560, heads=40, kv_heads=40, head_dim=64,
          d_ff=8960, vocab=65536, chunk=16, attn_kind="none",
          param_dtype="float32"),
     8, "the script's wall time, within 970 s: its 32 layers took 72 s of a "
        "1,158 s run on an H100"),
    ("whisper-small",
     dict(layers=12, enc_layers=12, enc_seq=1500, d_model=768, heads=12,
          kv_heads=12, head_dim=64, d_ff=3072, vocab=51865,
          param_dtype="float32"),
     None, None),
    ("internvl2-1b",
     dict(layers=24, d_model=896, heads=14, kv_heads=2, head_dim=64,
          d_ff=4864, vocab=151655, num_patches=256, param_dtype="float32"),
     None, None),
]
WIDTH_OF = {
    "layers": lambda c: c.num_layers, "d_model": lambda c: c.d_model,
    "heads": lambda c: c.num_heads, "kv_heads": lambda c: c.num_kv_heads,
    "head_dim": lambda c: c.head_dim, "d_ff": lambda c: c.d_ff,
    "vocab": lambda c: c.vocab_size, "param_dtype": lambda c: c.param_dtype,
    "window": lambda c: c.window if c.attn_kind == "swa" else None,
    "experts": lambda c: c.moe.num_experts, "top_k": lambda c: c.moe.top_k,
    "expert_d_ff": lambda c: c.moe.d_ff,
    "dense_residual": lambda c: c.moe.dense_residual,
    "ssm_state": lambda c: c.ssm_state, "ssm_heads": lambda c: c.n_ssm_heads,
    "shared_attn_every": lambda c: c.shared_attn_every,
    "chunk": lambda c: c.chunk_size, "attn_kind": lambda c: c.attn_kind,
    "enc_layers": lambda c: c.enc_layers, "enc_seq": lambda c: c.enc_seq,
    "num_patches": lambda c: c.num_patches,
}
# flash launches per prefill of the depth run: one per attention
# application (every moe layer, every application of zamba2's shared
# block, none in rwkv6; whisper's 12 encoder layers, 12 decoder self-
# and 12 cross-attentions; internvl2's 24 layers); a decode step none
FAMILY_FLASH = {"mixtral-8x7b": 8, "arctic-480b": 2, "zamba2-2.7b": 2,
                "rwkv6-3b": 0, "whisper-small": 36, "internvl2-1b": 24}
# the MoE check's tolerance: the unit tests' bf16 bound on max |diff| /
# max |y| (tests/test_torch_moe.py); the recurrences': the reference's
# elementwise rtol = atol = 1e-4 (tests/test_recurrences.py)
MOE_TOL = 2e-2
REC_TOL = 1e-4
FLASH_F32_TOL = 1e-3
# flash against plain in bfloat16: phase lm's bound on max |diff| / max
# |logit| (whisper's encoder output: of max |enc_out|), read for zamba2
# at this many groups; and, at the depth run,
# flash's distance from the float32 plain logits as a multiple of the
# plain path's own bfloat16 distance from them
FLASH_BF16_TOL = 3e-2
FLASH_BF16_GROUPS = 1
FLASH_BF16_NOISE = 1.1
DENSE_BLOCK = 1024


def _attn_per_prefill(cfg) -> int:
    return {"moe": cfg.num_layers,
            "hybrid": cfg.num_layers // cfg.shared_attn_every,
            "rwkv": 0, "vlm": cfg.num_layers,
            "encdec": cfg.enc_layers + 2 * cfg.num_layers}[cfg.family]


def _moe_check(cfg, params, toks, tag):
    """The first layer's MoE input at batch (b), captured from a forward
    of ``toks``, in blocks of ``DENSE_BLOCK`` tokens: per block the sparse
    ``moe_forward`` at a capacity factor whose capacity holds the block's
    fullest expert (0 pairs dropped) against
    ``moe_forward_dense_fallback`` (with nothing dropped each token's
    result is its own, so the blocks change nothing; whole, the random
    router's skew would ask a capacity near T of every expert, and the
    oracle's [T, E, ff] buffers would not fit beside arctic's params);
    then, over the whole batch, the share of (token, choice) pairs the
    config's own capacity factor drops and the per-expert load."""
    from repro_torch.models import forward, moe
    seen = []
    real = moe.moe_forward

    def capture(c, p, x):
        if not seen:
            seen.append((p, x))
        return real(c, p, x)

    moe.moe_forward = capture
    try:
        forward(cfg, params, {"tokens": toks})
    finally:
        moe.moe_forward = real
    p, x = seen[0]
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    xs = x.reshape(1, T, -1)
    _, top_p, top_e = moe.route(cfg, p, xs[0])
    load = torch.bincount(top_e.reshape(-1), minlength=m.num_experts)
    c_cfg = moe.capacity(cfg, T)
    _, _, dropped_cfg = moe.dispatch(cfg, top_p, top_e, c_cfg, x.dtype)
    err = mag = sparse_ms = dense_ms = 0.0
    cfs = []
    for i in range(0, T, DENSE_BLOCK):
        xb = xs[:, i:i + DENSE_BLOCK]
        tb = xb.shape[1]
        bload = torch.bincount(top_e[i:i + tb].reshape(-1),
                               minlength=m.num_experts)
        cf = (int(bload.max().item()) + 8) * m.num_experts / (m.top_k * tb)
        cfg_nd = cfg.with_overrides(
            moe=dataclasses.replace(m, capacity_factor=cf))
        _, _, dropped = moe.dispatch(cfg_nd, top_p[i:i + tb], top_e[i:i + tb],
                                     moe.capacity(cfg_nd, tb), x.dtype)
        require(int(dropped.item()) == 0,
                f"{tag}: {int(dropped.item())} pairs dropped in block {i}")
        cfs.append(cf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse, _ = moe.moe_forward(cfg_nd, p, xb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense, _ = moe.moe_forward_dense_fallback(cfg, p, xb)
        torch.cuda.synchronize()
        sparse_ms += 1e3 * (t1 - t0)
        dense_ms += 1e3 * (time.perf_counter() - t1)
        require(bool(torch.isfinite(sparse).all()),
                f"{tag}: non-finite sparse MoE output")
        err = max(err, float((sparse.float() - dense.float()).abs().max()
                             .item()))
        mag = max(mag, float(dense.float().abs().max().item()))
        del sparse, dense
    rel = err / mag
    require(rel <= MOE_TOL, f"{tag}: sparse MoE differs from the dense oracle "
            f"by {rel} of the largest |y| (tolerance {MOE_TOL})")
    _, aux = moe.moe_forward(cfg, p, x)
    # the per-call cast of one layer's expert stacks to the activations'
    # dtype, as moe_forward makes it (none when the params are bf16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        casts = [p[k].to(x.dtype) for k in ("w_gate", "w_up", "w_down")]
        del casts
    torch.cuda.synchronize()
    cast_ms = 1e3 * (time.perf_counter() - t0) / 3
    lo = load.float()
    return dict(layer=0, tokens=T, block=DENSE_BLOCK,
                expert_cast_ms_per_layer=cast_ms,
                expert_cast_bytes_per_layer=sum(
                    p[k].numel() * (p[k].element_size() + x.element_size())
                    if p[k].dtype != x.dtype else 0
                    for k in ("w_gate", "w_up", "w_down")),
                dtype=str(x.dtype).split(".")[-1],
                capacity_factor_max=max(cfs), dropped=0,
                max_abs_err=err, rel_err=rel, tol=MOE_TOL,
                sparse_ms=sparse_ms, dense_ms=dense_ms,
                aux_loss=float(aux.item()),
                config_capacity_factor=m.capacity_factor,
                config_capacity=c_cfg,
                dropped_share_at_config=int(dropped_cfg.item()) / (T * m.top_k),
                load=load.tolist(), load_min=int(lo.min().item()),
                load_max=int(lo.max().item()), load_mean=float(lo.mean().item()))


def _recurrence_check(cfg, params, toks, tag):
    """The first recurrent layer (zamba2's first mamba layer, rwkv6's
    first time mix) at full width on the prompt ``toks`` in float32: its
    chunked scan against the sequential oracle on the inputs the layer
    hands the scan (y and the final state), and the layer's output with
    each; every element within rtol = atol = ``REC_TOL``."""
    from repro_torch.models import layers, lm, rwkv, ssm, transformer
    c32 = cfg.with_overrides(dtype="float32")
    x = lm.embed(c32, params, toks)
    if cfg.family == "hybrid":
        p = transformer._index(params["blocks"][1], 0)
        h = layers.apply_norm(c32, p["ln"], x)
        mod, name, oracle = ssm, "_ssd_scan", ssm.ssd_sequential

        def layer():
            return ssm.mamba_forward(c32, p["mamba"], h)[0]
    else:
        p = transformer._index(params["blocks"][0], 0)
        h = layers.apply_norm(c32, p["ln1"], x)
        mod, name, oracle = rwkv, "_wkv_scan", rwkv.wkv_sequential

        def layer():
            return rwkv.rwkv_time_mix(c32, p["tm"], h)[0]
    real = getattr(mod, name)
    seen = []

    def capture(*a):
        seen.append(a)
        return real(*a)

    def run(scan):
        setattr(mod, name, scan)
        try:
            return layer()
        finally:
            setattr(mod, name, real)

    out_chunked = run(capture)
    out_seq = run(lambda *a: oracle(*a[:6]))
    args = seen[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_c, s_c = real(*args)
    torch.cuda.synchronize()
    chunked_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    y_s, s_s = oracle(*args[:6])
    torch.cuda.synchronize()
    seq_ms = 1e3 * (time.perf_counter() - t0)

    def share(a, b):
        """The largest |a - b| as a share of its element's bound."""
        return float(((a - b).abs() / (REC_TOL + REC_TOL * b.abs())).max()
                     .item())

    shares = dict(y=share(y_c, y_s), state=share(s_c, s_s),
                  layer_out=share(out_chunked, out_seq))
    require(max(shares.values()) <= 1.0,
            f"{tag}: the chunked scan differs from the sequential oracle: "
            f"{shares} of the bound rtol = atol = {REC_TOL}")
    return dict(layer=name.strip("_").replace("_scan", ""),
                tokens=int(toks.shape[1]), chunk=cfg.chunk_size,
                chunks=max(1, int(toks.shape[1]) // cfg.chunk_size),
                bound_share=shares, tol=dict(rtol=REC_TOL, atol=REC_TOL),
                max_abs_err_y=float((y_c - y_s).abs().max().item()),
                chunked_ms=chunked_ms, sequential_ms=seq_ms)


def _family_flash_vs_plain(cfg, params, toks, dev, attn, tag, extra=None):
    """Last-position logits of batch (b) (with the seeded stub inputs
    ``extra``), flash against the plain attention path (phase flash holds
    the kernel's bfloat16 route to its plain version elementwise at these
    very calls).

    bfloat16: max |flash - plain| within ``FLASH_BF16_TOL`` of the largest
    logit, as in phase lm, at the depth run for the MoE models and at
    ``FLASH_BF16_GROUPS`` group (6 layers, one application of the shared
    block) for the hybrid: zamba2's 54 layers carry bfloat16 rounding to
    6.8 % of the largest logit on the plain path alone (on an H100 80GB
    HBM3 at 700 W), so two bfloat16 runs that round at other places
    drift apart with depth (0.023 at 6 layers, 0.066 at 54).  At the
    depth run, flash's bfloat16 logits lie no farther from the plain
    path's float32 logits than ``FLASH_BF16_NOISE`` times the plain
    path's bfloat16 logits do.  float32 (the kernel's scalar route):
    within ``FLASH_F32_TOL`` of the largest logit, at the depth run."""
    rel, agree, bf = _compare_prefill(cfg, params, toks, dev, attn, tag,
                                      extra)
    c32 = cfg.with_overrides(dtype="float32")
    rel32, agree32, f32 = _compare_prefill(c32, params, toks, dev, attn, tag,
                                           extra)
    require(rel32 <= FLASH_F32_TOL, f"{tag}: flash and plain prefill logits "
            f"differ by {rel32} of the largest logit (float32)")
    exact = f32[False]
    top = float(exact.abs().max().item())
    noise = float((bf[False] - exact).abs().max().item()) / top
    flash_vs_f32 = float((bf[True] - exact).abs().max().item()) / top
    require(flash_vs_f32 <= FLASH_BF16_NOISE * noise,
            f"{tag}: flash's bfloat16 logits lie {flash_vs_f32} of the "
            f"largest logit from the float32 plain ones, the plain path's "
            f"{noise} (bound {FLASH_BF16_NOISE}x)")
    del bf, f32, exact
    layers_checked = cfg.num_layers
    rel_checked = rel
    if cfg.family == "hybrid":
        cfg_g = cfg.with_overrides(
            num_layers=FLASH_BF16_GROUPS * cfg.shared_attn_every)
        params_g = dict(params, blocks=_first_groups(params["blocks"],
                                                     FLASH_BF16_GROUPS))
        rel_checked, _, _ = _compare_prefill(cfg_g, params_g, toks, dev,
                                             FLASH_BF16_GROUPS, tag)
        layers_checked = cfg_g.num_layers
        del params_g
    require(rel_checked <= FLASH_BF16_TOL,
            f"{tag}: flash and plain prefill logits differ by {rel_checked} "
            f"of the largest logit (bfloat16, {layers_checked} layers; bound "
            f"{FLASH_BF16_TOL})")
    return dict(bf16_rel=rel_checked, bf16_layers=layers_checked,
                bf16_tol=FLASH_BF16_TOL, bf16_rel_depth_run=rel,
                bf16_greedy_agree=agree, bf16_flash_vs_f32=flash_vs_f32,
                bf16_plain_vs_f32=noise,
                bf16_flash_vs_f32_tol=FLASH_BF16_NOISE * noise,
                f32_rel=rel32, f32_tol=FLASH_F32_TOL,
                f32_greedy_agree=agree32, batch=list(toks.shape))


def _seeded_stubs(cfg, batch, dev, seed):
    """Stub frontend inputs that differ row by row, drawn as the
    reference's tests draw them (``tests/test_models.py::_batch``): frames
    N(0, 1), patches N(0, 1) x 0.02.  The served traffic keeps the
    reference CLI's zeros, on which every encoder row is the same (the
    LayerNorm of a zero row is its bias), so a comparison on them would
    check little."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "encdec":
        return {"frames": torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                      generator=gen, device=dev)}
    if cfg.family == "vlm":
        return {"patches": torch.randn((batch, cfg.num_patches, cfg.d_model),
                                       generator=gen, device=dev) * 0.02}
    return {}


def _encode_flash_vs_plain(cfg, params, frames, tag):
    """Whisper's encoder output on seeded frames, flash against the plain
    attention path in the run's dtype: max |diff| within
    ``FLASH_BF16_TOL`` of max |enc_out|; flash launched once a layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import encode
    before = ops.LAUNCHES["flash_attention"]
    out = {flash: encode(cfg.with_overrides(use_flash_kernel=flash), params,
                         frames) for flash in (True, False)}
    n = ops.LAUNCHES["flash_attention"] - before
    require(n == cfg.enc_layers, f"{tag}: encode launched flash {n} times, "
            f"not once for each of {cfg.enc_layers} layers")
    f, p = (out[k].float() for k in (True, False))
    require(bool(torch.isfinite(f).all()), f"{tag}: non-finite enc_out")
    rel = float((f - p).abs().max().item() / p.abs().max().item())
    require(rel <= FLASH_BF16_TOL, f"{tag}: flash and plain encoder outputs "
            f"differ by {rel} of the largest |enc_out| (bound "
            f"{FLASH_BF16_TOL})")
    return dict(rel=rel, tol=FLASH_BF16_TOL, dtype=cfg.dtype,
                shape=list(f.shape), flash_launches=n)


def _family_run(k, arch, published, layers_run, why, dev, seed):
    """One family at its published width, depth cut to ``layers_run``;
    returns (its phase line, its launches on the served parts).  Batch
    (b) is 4 prompts of 1,500 - 2,048 tokens, except whisper's: 128 - 256
    (its decoder's published context is 448 tokens), under 1,500 frames."""
    from repro_torch.launch.serve import (Request, _pow2_at_least,
                                          cli_requests, stub_inputs)
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models import active_params, count_params, init_params
    tag = f"families/{arch}"
    t_model = time.perf_counter()
    full = model_cfg_for(arch)
    widths = {key: WIDTH_OF[key](full) for key in published}
    require(widths == published,
            f"{tag}: not at its published width: {widths}")
    cfg = full.with_overrides(use_flash_kernel=True)
    reduced = []
    if layers_run is not None:
        cfg = cfg.with_overrides(num_layers=layers_run)
        reduced.append(dict(key="num_layers", published=full.num_layers,
                            run=layers_run, why=why))
    attn = _attn_per_prefill(cfg)
    require(attn == FAMILY_FLASH[arch],
            f"{tag}: {attn} attention applications a prefill")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed + 70_000 + k), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_bytes = torch.cuda.max_memory_allocated()

    parts = {}
    parts["cli"], launches = _serve_part(
        cfg, params, cli_requests(cfg, 8, LM_NEW), 4, 128, dev, attn, tag)
    rng = np.random.default_rng(seed + 60_000 + k)
    lo, bucket = (128, 256) if cfg.family == "encdec" else (1500, 2048)
    long_reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                         size=int(n)).tolist(), LM_NEW)
                 for i, n in enumerate(rng.integers(lo, bucket + 1, size=4))]
    require(_pow2_at_least(max(len(r.prompt) for r in long_reqs)) == bucket,
            f"{tag}: the long prompts do not bucket to {bucket}")
    parts[f"long_{bucket}"], lb = _serve_part(cfg, params, long_reqs, 4,
                                              bucket + LM_NEW, dev, attn, tag)
    launches = {n: launches[n] + lb[n] for n in launches}
    if arch == "mixtral-8x7b":
        # past the 4,096-token window: flash's window mask and the ring
        req_8k = [Request(4, rng.integers(0, cfg.vocab_size,
                                          size=8192).tolist(), LM_NEW)]
        parts["long_8192"], lc = _serve_part(cfg, params, req_8k, 1,
                                             8192 + LM_NEW, dev, attn, tag)
        launches = {n: launches[n] + lc[n] for n in launches}
    toks = np.zeros((4, bucket), np.int64)
    for i, r in enumerate(long_reqs):
        toks[i, bucket - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).to(dev)
    warm = _warm_prefill(cfg, params, toks, dev, flash_per_prefill=attn,
                         tag=tag, cpu_trace=False,
                         extra=stub_inputs(cfg, 4, dev))
    checks = {}
    if arch in ("mixtral-8x7b", "zamba2-2.7b", "whisper-small",
                "internvl2-1b"):
        stubs = _seeded_stubs(cfg, 4, dev, seed + 80_000 + k)
        checks["flash_vs_plain"] = _family_flash_vs_plain(
            cfg, params, toks, dev, attn, tag, stubs)
        if cfg.family == "encdec":
            checks["encode_flash_vs_plain"] = _encode_flash_vs_plain(
                cfg, params, stubs["frames"], tag)
    if cfg.moe is not None:
        checks["moe_vs_dense"] = _moe_check(cfg, params, toks, tag)
    if cfg.family in ("hybrid", "rwkv"):
        lens = (256, 512) if cfg.family == "hybrid" else (256,)
        checks["recurrence"] = [_recurrence_check(
            cfg, params, torch.tensor([long_reqs[0].prompt[:n]], device=dev),
            tag) for n in lens]
    n_params = count_params(cfg)
    row = dict(
        arch=arch, family=cfg.family, published=published,
        layers=cfg.num_layers, reduced=reduced, param_dtype=cfg.param_dtype,
        dtype=cfg.dtype, params=n_params,
        params_published=count_params(full), active_params=active_params(cfg),
        params_bytes=params_bytes, init_s=init_s,
        flash_per_prefill=attn, parts=parts, warm_prefill=warm,
        checks=checks, model_s=time.perf_counter() - t_model)
    del params, toks
    torch.cuda.empty_cache()
    return row, launches


def families_phase(dev, seed, t_script):
    """Each family served in turn (each model freed before the next);
    emits one line per model and returns the summed launches of the
    served parts (the path's own runs: comparisons not counted)."""
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    total = dict.fromkeys(ops.LAUNCHES, 0)
    t_phase = time.perf_counter()
    for k, (arch, published, layers_run, why) in enumerate(FAMILIES):
        row, launches = _family_run(k, arch, published, layers_run, why,
                                    dev, seed)
        total = {n: total[n] + launches[n] for n in total}
        emit("families", **row, launches=launches,
             phase_s=time.perf_counter() - t_phase,
             script_s=time.perf_counter() - t_script)
    return total


# --------------------------------------------------------------------------
# train: the training path at published widths
# --------------------------------------------------------------------------

# (a) qwen2-1.5b at full width and depth on train_4k's sequence length;
# the global batch cut from 256 to 8, run as 2 microbatches of 4
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_BATCH = 8
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 5
# (b) the resilient loop at full width, 2 layers: 6 steps, a checkpoint
# every 2, a failure injected at step 3 (restores step 2)
RESILIENT_LAYERS = 2
RESILIENT_SHAPE = (2, 1024)        # batch, sequence
RESILIENT_STEPS = 6
RESILIENT_EVERY = 2
RESILIENT_FAIL_AT = 3
TRAIN_CKPT_DIR = os.path.join("build", "chip_smoke_train_ckpt")
# (c) one step (and a warm second) of each other family at its published
# widths, batch 1 x 1,024 (whisper 1 x 256 under its 1,500 frames), the
# depth cut to what one card holds with AdamW state (16 B a parameter)
TRAIN_FAMILIES = [
    ("mixtral-8x7b", 1, "1 layer: 1.71 G params x 16 B of AdamW state "
     "= 27 GB, plus the same again while the update writes the new state"),
    ("zamba2-2.7b", 6, "one group: 6 mamba blocks and one application of "
     "the shared attention block"),
    ("rwkv6-3b", 8, "8 of 32 layers: the chunk loop's backward at 64 chunks "
     "a layer; 32 layers need 49 GB of state before activations"),
    ("whisper-small", None, None),
    ("internvl2-1b", None, None),
]
TRAIN_FAMILY_SEQ = {"whisper-small": 256}
TRAIN_FAMILY_SEQ_DEFAULT = 1024


def _step_ms(step, state, batch):
    """One train step timed by CUDA events (synchronised); returns (state,
    metrics, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    state, m = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return state, m, start.elapsed_time(end)


def _metrics_host(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def _traced_step(step, state, batch, tag):
    """One step under ``torch.profiler`` (device activity only): the
    share of its wall time with no kernel running, kernel ms, and the
    top kernels by device time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "Command Buffer" not in e.name]
    require(kern, f"{tag}: the traced step shows no kernel")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        n = e.name[:80]
        ms, calls = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return state, m, dict(
        profiled_wall_ms=wall, kernel_ms=busy, kernels=len(kern),
        idle_share=max(0.0, 1.0 - busy / wall),
        top_kernels=[dict(name=n, ms=ms, calls=c) for n, (ms, c) in top])


def _finite(m, tag):
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        require(math.isfinite(m[k]), f"{tag}: {k} is {m[k]}")


def _train_qwen2(dev, seed):
    """(a): 5 steps of qwen2-1.5b at its published width and depth on
    ``TokenPipeline(seed=0)`` batches of 8 x 4,096 in 2 microbatches,
    then one traced step."""
    from repro_torch.configs import get_shape
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.specs import (model_cfg_for, train_batch,
                                          train_cfg_for)
    from repro_torch.models import count_params, init_params
    from repro_torch.train import (get_optimizer, init_state,
                                   make_train_step, warmup_cosine)
    from repro_torch.train.tree import flatten
    tag = "train/qwen2"
    shape = get_shape("train_4k")
    cfg = model_cfg_for(TRAIN_ARCH)
    require(cfg.remat and not cfg.use_flash_kernel
            and cfg.param_dtype == "float32" and cfg.dtype == "bfloat16",
            f"{tag}: not the float32-master, bf16, remat config")
    tcfg = dataclasses.replace(train_cfg_for(TRAIN_ARCH),
                               microbatches=TRAIN_MICROBATCHES)
    opt = get_optimizer(tcfg.optimizer)
    step = make_train_step(cfg, tcfg, opt, warmup_cosine(
        tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 90_000), dev)
    state = init_state(cfg, tcfg, opt, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = torch.cuda.max_memory_allocated()
    first = [p.clone() for p in flatten(params)[0][:2]]
    del params
    pipe = TokenPipeline(cfg.vocab_size, shape.seq_len, TRAIN_BATCH, seed=0)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = train_batch(cfg, pipe.next_batch()["tokens"], dev)
        state, m, ms = _step_ms(step, state, batch)
        mh = _metrics_host(m)
        _finite(mh, tag)
        steps.append(dict(ms=ms, **mh))
    peak = torch.cuda.max_memory_allocated()
    state, m, traced = _traced_step(
        step, state, train_batch(cfg, pipe.next_batch()["tokens"], dev), tag)
    _finite(_metrics_host(m), tag)
    ln_v = math.log(cfg.vocab_size)
    require(abs(steps[0]["ce"] - ln_v) <= 0.5,
            f"{tag}: first-step CE {steps[0]['ce']} not within 0.5 of "
            f"ln V = {ln_v}")
    changed = [bool((p != q).any()) for p, q in
               zip(first, flatten(state["params"])[0][:2])]
    require(all(changed), f"{tag}: params unchanged after "
            f"{TRAIN_STEPS + 1} steps: {changed}")
    warm = sorted(s["ms"] for s in steps[1:])
    step_ms = warm[len(warm) // 2] if len(warm) % 2 else \
        0.5 * (warm[len(warm) // 2 - 1] + warm[len(warm) // 2])
    tokens = TRAIN_BATCH * shape.seq_len
    del state, first
    torch.cuda.empty_cache()
    return dict(
        arch=TRAIN_ARCH, layers=cfg.num_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=count_params(cfg),
        param_dtype=cfg.param_dtype, dtype=cfg.dtype, remat=cfg.remat,
        optimizer=tcfg.optimizer, seq_len=shape.seq_len,
        global_batch=TRAIN_BATCH, microbatches=TRAIN_MICROBATCHES,
        reduced=[dict(key="global_batch", published=shape.global_batch,
                      run=TRAIN_BATCH,
                      why=f"{shape.name}'s 256 x 4,096 tokens a step: "
                          f"a 5-step smoke run takes 8, as 2 microbatches "
                          f"of 4")],
        init_s=init_s, state_bytes=state_bytes, steps=steps,
        step_s_median_2_5=step_ms / 1e3,
        tokens_per_s=tokens / (step_ms / 1e3),
        max_memory_allocated=peak, first_ce=steps[0]["ce"], ln_vocab=ln_v,
        traced_step=traced)


def _train_resilient(dev, seed):
    """(b): ``run_resilient`` (``StepGuard``, ``Heartbeat``, async
    checkpoints, ``gc_checkpoints``) at qwen2's width, 2 layers: 6 steps,
    a checkpoint every 2, a failure injected at step 3 that restores step
    2, the pipeline rewound to the restored cursor; the final params equal
    those of an uninterrupted run bit for bit, under
    ``torch.use_deterministic_algorithms(True)``."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.cluster import Heartbeat, StepGuard, run_resilient
    from repro_torch.launch.specs import (model_cfg_for, train_batch,
                                          train_cfg_for)
    from repro_torch.models import count_params, init_params
    from repro_torch.train import (get_optimizer, init_state,
                                   make_train_step, warmup_cosine)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import flatten
    tag = "train/resilient"
    full = model_cfg_for(TRAIN_ARCH)
    cfg = full.with_overrides(num_layers=RESILIENT_LAYERS)
    B, S = RESILIENT_SHAPE
    tcfg = dataclasses.replace(train_cfg_for(TRAIN_ARCH), warmup_steps=1,
                               total_steps=RESILIENT_STEPS)
    opt = get_optimizer(tcfg.optimizer)
    step = make_train_step(cfg, tcfg, opt, warmup_cosine(
        tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))

    def fresh():
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed + 91_000), dev)
        return init_state(cfg, tcfg, opt, params)

    def pipeline():
        return TokenPipeline(cfg.vocab_size, S, B, seed=0)

    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        state, pipe = fresh(), pipeline()
        for _ in range(RESILIENT_STEPS):
            state, _ = step(state, train_batch(
                cfg, pipe.next_batch()["tokens"], dev))
        want = [p.clone() for p in flatten(state["params"])[0]]
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        del state

        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
        live = {"pipe": pipeline()}
        saved, restored, losses, fired = {}, [], [], []

        def pipeline_state():
            cur = live["pipe"].state()
            saved[cur["cursor"]] = dict(cur)
            return {"pipeline": cur}

        def on_restore(extra):
            restored.append(dict(extra["pipeline"]))
            live["pipe"] = TokenPipeline.from_state(
                cfg.vocab_size, S, B, extra["pipeline"])

        def inject(i):
            if i == RESILIENT_FAIL_AT and not fired:
                fired.append(i)
                return RuntimeError("injected failure")
            return None

        hb = Heartbeat(TRAIN_CKPT_DIR, host_id=0)

        def on_metrics(i, m):
            hb.beat()
            losses.append(float(m["loss"]))

        t0 = time.perf_counter()
        final, ran = run_resilient(
            fresh(), step,
            lambda: train_batch(cfg, live["pipe"].next_batch()["tokens"],
                                dev),
            ckpt_dir=TRAIN_CKPT_DIR, num_steps=RESILIENT_STEPS,
            ckpt_every=RESILIENT_EVERY, keep=2,
            guard=StepGuard(factor=50.0),
            pipeline_state=pipeline_state, on_metrics=on_metrics,
            inject_failure=inject, on_restore=on_restore)
        torch.cuda.synchronize()
        resilient_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    got = flatten(final["params"])[0]
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    kept = sorted(n for n in os.listdir(TRAIN_CKPT_DIR)
                  if n.startswith("step_"))
    ckpt_bytes = sum(
        os.path.getsize(os.path.join(TRAIN_CKPT_DIR, kept[-1], "arrays", f))
        for f in os.listdir(os.path.join(TRAIN_CKPT_DIR, kept[-1], "arrays")))
    require(fired == [RESILIENT_FAIL_AT], f"{tag}: failure not injected")
    require(len(restored) == 1 and restored[0] == saved.get(
        RESILIENT_EVERY), f"{tag}: restored cursor {restored} is not the "
        f"one saved at step {RESILIENT_EVERY}: {saved}")
    require(int(final["step"]) == RESILIENT_STEPS,
            f"{tag}: ended at step {int(final['step'])}")
    require(equal, f"{tag}: the restored run's params differ from the "
            f"uninterrupted run's")
    # gc keeps the newest 2 complete checkpoints; the one still being
    # written when it runs is not yet complete, so 3 may remain
    require(ckpt.latest_step(TRAIN_CKPT_DIR) == RESILIENT_STEPS
            and kept[-2:] == [f"step_{s:09d}" for s in (4, 6)]
            and len(kept) <= 3, f"{tag}: checkpoints kept: {kept}")
    require(all(math.isfinite(x) for x in losses), f"{tag}: {losses}")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    del final, got, want
    torch.cuda.empty_cache()
    return dict(
        arch=TRAIN_ARCH, layers=cfg.num_layers, params=count_params(cfg),
        batch=[B, S], steps=RESILIENT_STEPS, ckpt_every=RESILIENT_EVERY,
        fail_at=RESILIENT_FAIL_AT, restored_cursor=restored[0],
        saved_cursors=saved, steps_run=ran, losses=losses,
        checkpoint_bytes=ckpt_bytes, params_equal_uninterrupted=equal,
        deterministic_algorithms=True,
        cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        uninterrupted_s=plain_s, resilient_s=resilient_s,
        reduced=[dict(key="num_layers", published=full.num_layers,
                      run=RESILIENT_LAYERS,
                      why="a checkpoint of 2 layers' state is about 4 GB, "
                          "of 28 layers' 18.5 GB")])


def _train_family(k, arch, layers_run, why, dev, seed):
    """(c): two steps of ``arch`` at its published widths (the second
    warm), depth cut to ``layers_run``; seeded frames / patches."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.specs import (model_cfg_for, train_batch,
                                          train_cfg_for)
    from repro_torch.models import count_params, init_params
    from repro_torch.train import (get_optimizer, init_state,
                                   make_train_step, warmup_cosine)
    tag = f"train/{arch}"
    published = next(p for a, p, _, _ in FAMILIES if a == arch)
    full = model_cfg_for(arch)
    widths = {key: WIDTH_OF[key](full) for key in published}
    require(widths == published, f"{tag}: not at its published width")
    cfg, reduced = full, []
    if layers_run is not None:
        cfg = cfg.with_overrides(num_layers=layers_run)
        reduced.append(dict(key="num_layers", published=full.num_layers,
                            run=layers_run, why=why))
    S = TRAIN_FAMILY_SEQ.get(arch, TRAIN_FAMILY_SEQ_DEFAULT)
    tcfg = train_cfg_for(arch)
    if tcfg.microbatches != 1:
        reduced.append(dict(key="microbatches", published=tcfg.microbatches,
                            run=1, why="a batch of 1 has one microbatch"))
        tcfg = dataclasses.replace(tcfg, microbatches=1)
    tcfg = dataclasses.replace(tcfg, warmup_steps=1)
    opt = get_optimizer(tcfg.optimizer)
    step = make_train_step(cfg, tcfg, opt, warmup_cosine(
        tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed + 92_000 + k)
    state = init_state(cfg, tcfg, opt, init_params(cfg, gen, dev))
    pipe = TokenPipeline(cfg.vocab_size, S, 1, seed=0)
    steps = []
    for _ in range(2):
        batch = train_batch(cfg, pipe.next_batch()["tokens"], dev, gen=gen)
        state, m, ms = _step_ms(step, state, batch)
        mh = _metrics_host(m)
        _finite(mh, tag)
        steps.append(dict(ms=ms, **mh))
    if cfg.moe is not None:
        require(all(s["aux"] > 0 for s in steps), f"{tag}: aux loss is 0")
    peak = torch.cuda.max_memory_allocated()
    del state, batch
    torch.cuda.empty_cache()
    return dict(arch=arch, family=cfg.family, layers=cfg.num_layers,
                params=count_params(cfg), optimizer=tcfg.optimizer,
                batch=[1, S], steps=steps, step_s=steps[-1]["ms"] / 1e3,
                max_memory_allocated=peak, reduced=reduced)


def train_phase(dev, seed, t_script):
    """(a), (b), (c); emits one line for each; returns the launches of
    the whole phase (the training path launches no kernel: the flash
    kernel has no backward and refuses grad)."""
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launches()
    t_phase = time.perf_counter()
    emit("train", part="qwen2", **_train_qwen2(dev, seed),
         phase_s=time.perf_counter() - t_phase)
    emit("train", part="resilient", **_train_resilient(dev, seed),
         phase_s=time.perf_counter() - t_phase)
    for k, (arch, layers, why) in enumerate(TRAIN_FAMILIES):
        emit("train", part="family", **_train_family(k, arch, layers, why,
                                                      dev, seed),
             phase_s=time.perf_counter() - t_phase)
    launches = dict(ops.LAUNCHES)
    require(all(v == 0 for v in launches.values()),
            f"train: the training path launched kernels: {launches}")
    emit("train", part="summary", launches=launches,
         reduced_elsewhere=[dict(
             arch="arctic-480b", run="the CPU tests only",
             why="one layer is 14 G bf16 params and as many grads, and "
                 "its adafactor update upcasts a 4.46 G-element expert "
                 "leaf to float32; its adafactor and bf16 path is pinned "
                 "by tests/test_torch_train.py")],
         phase_s=time.perf_counter() - t_phase,
         script_s=time.perf_counter() - t_script)
    return launches


# --------------------------------------------------------------------------
# cost: the accountant's counts held against the card's time
# --------------------------------------------------------------------------

COST_ARCH = "qwen2-1.5b"
# (a) the programs phases lm and train run: the warm prefill of (b), a
# decode step of the CLI traffic (4 slots, 128 positions), the train step
COST_PREFILL = (4, 2048)
COST_DECODE = (4, 128)
COST_DECODE_AT = 16                   # the cache holds a 16-token prompt
COST_REPS = 5                         # timed prefills / decode steps
COST_TRAIN_REPS = 2                   # timed train steps (7.7 s each)
COST_FIT_REPS = 3                     # timed warm fits
COST_SHARE_MAX = 1.05                 # a count above the card's peak is wrong
COST_DRYRUN = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _events_ms(fn, reps):
    """Milliseconds of each of ``reps`` synchronised calls of ``fn()`` by
    CUDA events."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _cost_share(tag, count, ms, smi):
    """The roofline bound of ``count`` and its share of ``ms`` measured;
    a share above ``COST_SHARE_MAX`` fails."""
    from repro_torch.launch.roofline import roofline_terms
    r = roofline_terms(count["flops_by_class"], count["bytes"],
                       count["coll_bytes"])
    bound_ms = 1e3 * r["bound"]
    share = bound_ms / ms
    require(0 < share <= COST_SHARE_MAX,
            f"cost/{tag}: the bound {bound_ms} ms is {share} of the "
            f"{ms} ms measured ({smi})")
    return dict(bound_ms=bound_ms, measured_ms=ms, share=share,
                dominant=r["dominant"], t_compute_ms=1e3 * r["t_compute"],
                t_memory_ms=1e3 * r["t_memory"], card=smi)


def _count_line(c, top=8):
    """A count's totals and its ``top`` operators by bytes."""
    ranked = sorted(c["ops"].items(), key=lambda kv: -kv[1]["bytes"])
    return dict({k: c[k] for k in ("flops", "flops_by_class", "dot_flops",
                                   "kernel_flops", "bytes", "coll_bytes",
                                   "torch_flop_counter", "peak_live_bytes")},
                top_ops=[dict(op=k, **v) for k, v in ranked[:top]])


def _real_vs_fake(tag, real, fake):
    """(a): the accountant over the real run and over ``build_cell``'s
    fake run of the same program must agree exactly."""
    for key in ("flops", "flops_by_class", "bytes"):
        require(real[key] == fake[key],
                f"cost/{tag}: {key} of the real run {real[key]} != "
                f"{fake[key]} of build_cell's fake run")


def _weight_products(cfg):
    """Weight-product parameters one token meets in the trunk (GQA
    projections and the GLU), and in the head (d x V)."""
    d, H, KV, Dh, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    layer = d * H * Dh + 2 * d * KV * Dh + H * Dh * d + 3 * d * ff
    return cfg.num_layers * layer, d * cfg.vocab_size


def _cost_program(tag, fn, cell, reps, smi):
    """(a) and (b) for one program: ``fn()`` once under the accountant,
    the same program as ``build_cell``'s fake ``cell`` (fn, args), then
    ``reps`` timed runs without the accountant (median)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import costs, dryrun
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    _, real = costs.measure(fn)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for k, n in launched.items():
        require(real["ops"].get(f"repro_torch.{k}", {}).get("calls", 0) == n,
                f"cost/{tag}: {n} {k} launches, the accountant saw "
                f"{real['ops'].get(f'repro_torch.{k}')}")
    t0 = time.perf_counter()
    _, fake, memory = dryrun.count_cell(*cell)
    fake_s = time.perf_counter() - t0
    _real_vs_fake(tag, real, fake)
    ms = _events_ms(fn, reps)
    med = float(np.median(ms))
    return real, dict(count=_count_line(real), launches=launched,
                      counted_s=counted_s, fake_s=fake_s,
                      fake_memory=memory, ms=ms, ms_median=med,
                      **_cost_share(tag, real, med, smi))


def _cost_lm(dev, seed, smi):
    """(a) / (b) for qwen2's warm prefill and a decode step (flash on, as
    phase lm serves), and the counts of (e)."""
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import (count_params, decode_step, init_cache,
                                    init_params, prefill)
    flash = {"use_flash_kernel": True}
    cfg = get_config(COST_ARCH).with_overrides(**flash)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 95_000), dev)
    gen = np.random.default_rng(seed + 95_000)
    B, S = COST_PREFILL
    batch = {"tokens": torch.from_numpy(gen.integers(
        0, cfg.vocab_size, size=(B, S))).to(dev, torch.int32)}
    cache = init_cache(cfg, B, S, dev)
    real_p, prefill_line = _cost_program(
        "prefill", lambda: prefill(cfg, params, batch, cache),
        build_cell(COST_ARCH, ShapeCfg("prefill_4x2048", "prefill", S, B),
                   device=dev, overrides=flash)[:2], COST_REPS, smi)
    require(prefill_line["launches"]["flash_attention"] == cfg.num_layers,
            f"cost/prefill: {prefill_line['launches']} launches")
    del cache
    B, S = COST_DECODE
    cache = init_cache(cfg, B, S, dev)
    _, cache = prefill(cfg, params, {"tokens": batch["tokens"][
        :B, :COST_DECODE_AT]}, cache)
    tok = batch["tokens"][:B, COST_DECODE_AT]
    real_d, decode_line = _cost_program(
        "decode", lambda: decode_step(cfg, params, tok, cache),
        build_cell(COST_ARCH, ShapeCfg("decode_cli", "decode", S, B),
                   device=dev, overrides=flash)[:2], COST_REPS, smi)
    del params, cache
    torch.cuda.empty_cache()
    P = count_params(cfg)
    trunk, head = _weight_products(cfg)
    Bp, Sp = COST_PREFILL
    out = dict(prefill=prefill_line, decode=decode_line)
    out["dots"] = {
        "prefill": dict(dot_flops=real_p["dot_flops"],
                        two_params_tokens=2 * P * Bp * Sp,
                        analytic_no_attention=2 * Bp * Sp * trunk
                        + 2 * Bp * head),
        "decode": dict(dot_flops=real_d["dot_flops"],
                       two_params_tokens=2 * P * B,
                       analytic_no_attention=2 * B * (trunk + head))}
    return out


def _cost_train(dev, seed, smi):
    """(a) / (b) for phase train's qwen2 step: 8 x 4,096 tokens in 2
    microbatches, remat, AdamW, the plain attention."""
    from repro_torch.configs import ShapeCfg, get_shape
    from repro_torch.launch.specs import (build_cell, model_cfg_for,
                                          train_batch, train_cfg_for)
    from repro_torch.models import count_params, init_params
    from repro_torch.train import (get_optimizer, init_state,
                                   make_train_step, warmup_cosine)
    cfg = model_cfg_for(TRAIN_ARCH)
    tcfg = dataclasses.replace(train_cfg_for(TRAIN_ARCH),
                               microbatches=TRAIN_MICROBATCHES)
    opt = get_optimizer(tcfg.optimizer)
    step = make_train_step(cfg, tcfg, opt, warmup_cosine(
        tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))
    S = get_shape("train_4k").seq_len
    holder = {"state": init_state(cfg, tcfg, opt, init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed + 96_000), dev))}
    gen = np.random.default_rng(seed + 96_000)
    batch = train_batch(cfg, gen.integers(0, cfg.vocab_size, size=(
        TRAIN_BATCH, S + 1)), dev)

    def one():
        holder["state"], _ = step(holder["state"], batch)

    real, line = _cost_program(
        "train", one,
        build_cell(TRAIN_ARCH, ShapeCfg("train_8x4096", "train", S,
                                        TRAIN_BATCH), device=dev,
                   microbatches=TRAIN_MICROBATCHES)[:2],
        COST_TRAIN_REPS, smi)
    del holder, batch
    torch.cuda.empty_cache()
    trunk, head = _weight_products(cfg)
    T = TRAIN_BATCH * S
    line["dots"] = dict(dot_flops=real["dot_flops"],
                        eight_params_tokens=8 * count_params(cfg) * T,
                        analytic_no_attention=8 * T * (trunk + head))
    return line


def _cost_fit(fit, smi):
    """(c): one warm fit under the accountant; the distance kernels'
    formula FLOPs equal the sum over launches of 3·d per (row,
    candidate) slot of each launch's shapes."""
    from repro_torch.engine import cluster
    from repro_torch.kernels import ops
    from repro_torch.launch import costs
    pts, eps, caps, labels = fit
    shapes = {"eps_count_batch": [], "row_min_batch": []}
    real_count, real_min = ops.eps_count_batch, ops.row_min_batch

    def keep_count(a, b, eps_, valid_b=None, valid_a=None, *, stop_at=None):
        shapes["eps_count_batch"].append((*a.shape, b.shape[1]))
        return real_count(a, b, eps_, valid_b, valid_a, stop_at=stop_at)

    def keep_min(a, b, valid_b=None):
        shapes["row_min_batch"].append((*a.shape, b.shape[1]))
        return real_min(a, b, valid_b)

    before = dict(ops.LAUNCHES)
    ops.eps_count_batch, ops.row_min_batch = keep_count, keep_min
    try:
        res, c = costs.measure(cluster, pts, eps, MIN_PTS,
                               engine="device-kernels", caps=caps)
    finally:
        ops.eps_count_batch, ops.row_min_batch = real_count, real_min
    require(np.array_equal(res.labels, labels),
            "cost/fit: the counted fit gave other labels")
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    kernels, k_flops, k_bytes = {}, 0.0, 0.0
    for name, calls in shapes.items():
        live = [(B, M, d, N) for B, M, d, N in calls if B * M]
        formula = sum(3.0 * d * B * M * N for B, M, d, N in live)
        rec = c["ops"].get(f"repro_torch.{name}",
                           {"calls": 0, "flops": 0.0, "bytes": 0.0})
        require(rec["calls"] == launched[name] == len(live) > 0,
                f"cost/fit: {name}: {rec['calls']} counted, "
                f"{launched[name]} launched, {len(live)} calls with rows")
        require(rec["flops"] == formula,
                f"cost/fit: {name}: {rec['flops']} counted FLOPs, "
                f"{formula} by the formula over its launches")
        kernels[name] = dict(launches=len(live), formula_flops=formula,
                             counted_flops=rec["flops"],
                             bytes=rec["bytes"])
        k_flops += formula
        k_bytes += rec["bytes"]
    wall = []
    for _ in range(COST_FIT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cluster(pts, eps, MIN_PTS, engine="device-kernels", caps=caps)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    med = float(np.median(wall))
    kernel_bound_ms = _bound(k_bytes, k_flops)[0]
    return dict(n=len(pts), count=_count_line(c), kernels=kernels,
                launches=launched, warm_ms=wall, warm_ms_median=med,
                kernel_bound_ms=kernel_bound_ms,
                kernel_share=kernel_bound_ms / med,
                **_cost_share("fit", c, med, smi))


def cost_phase(dev, seed, fit, smi, t_script):
    """(a) - (e); emits one line for each part; returns the launches of
    the whole phase (the counted and timed runs; none is a new path)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import run_cell
    t_phase = time.perf_counter()
    before = dict(ops.LAUNCHES)
    lm = _cost_lm(dev, seed, smi)
    for part in ("prefill", "decode"):
        emit("cost", part=part, arch=COST_ARCH, **lm[part],
             phase_s=time.perf_counter() - t_phase)
    train = _cost_train(dev, seed, smi)
    emit("cost", part="train", arch=TRAIN_ARCH, **train,
         phase_s=time.perf_counter() - t_phase)
    emit("cost", part="fit", **_cost_fit(fit, smi),
         phase_s=time.perf_counter() - t_phase)
    total = torch.cuda.get_device_properties(0).total_memory
    for shape in COST_DRYRUN:
        rec = run_cell(COST_ARCH, shape, device=dev, overrides=(
            None if shape.startswith("train") else {"use_flash_kernel": True}))
        mem = rec.get("memory")
        emit("cost", part="dryrun", card=smi, **rec,
             fits_card=None if mem is None else
             mem["argument_size"] + mem["temp_size"] <= total,
             phase_s=time.perf_counter() - t_phase)
    dots = dict(lm["dots"], train=train["dots"])
    for kind, d in dots.items():
        require(d["dot_flops"] >= d["analytic_no_attention"],
                f"cost/{kind}: {d['dot_flops']} dot FLOPs, below the "
                f"{d['analytic_no_attention']} of the weight products alone")
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    emit("cost", part="summary", dots=dots, launches=launches, card=smi,
         phase_s=time.perf_counter() - t_phase,
         script_s=time.perf_counter() - t_script)
    return launches


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-pairwise", metavar="PATH", default=None,
                    help="another version of kernels/csrc/pairwise.cu, built "
                         "beside this one and timed against it at every "
                         "captured width (phase kernels, parent_ms)")
    args = ap.parse_args()
    t_script = time.perf_counter()
    # cuBLAS's deterministic workspace, read when CUDA starts: phase
    # train's resume check runs under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=smi,
         device_name=torch.cuda.get_device_name(0))

    from repro_torch.core import sync
    from repro_torch.core.device_dbscan import GritCaps
    from repro_torch.core.validate import assert_labels_conformant
    from repro_torch.engine import cluster, estimate_caps
    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    libs = build.build_all()
    baseline = None
    if args.baseline_pairwise:
        baseline = ops.declare_distance(build.load_source(
            args.baseline_pairwise, "pairwise_baseline", "pairwise"))
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(p.name for p in libs.values()),
         baseline_pairwise=args.baseline_pairwise)

    # ---- fit ------------------------------------------------------------
    t0 = time.perf_counter()
    pts, eps = make_points(args.n, args.seed)
    t_data = time.perf_counter() - t0
    # the host part of a cold fit, timed on its own (the cold fit below
    # repeats it: cluster() estimates its own caps)
    t0 = time.perf_counter()
    estimate_caps(pts, eps, MIN_PTS, use_kernels=True)
    estimate_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    sync.READS["count"] = 0
    t0 = time.perf_counter()
    res = cluster(pts, eps, MIN_PTS, engine="device-kernels")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cold_reads = sync.READS["count"]
    peak_bytes = torch.cuda.max_memory_allocated()
    for k in ("eps_count_batch", "row_min_batch"):
        require(launches[k] > 0, f"the main path never launched {k}")
    require(res.overflow == (), f"unresolved overflow {res.overflow}")
    require(res.labels.shape == (args.n,) and res.core.shape == (args.n,),
            "labels / core have the wrong shape")
    require(res.n_clusters >= 1, "the fit found no cluster")
    caps = GritCaps(**res.attempts[-1]["caps"])

    sync.READS["count"] = 0
    t0 = time.perf_counter()
    warm = cluster(pts, eps, MIN_PTS, engine="device-kernels", caps=caps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_reads = sync.READS["count"]
    require(np.array_equal(warm.labels, res.labels)
            and np.array_equal(warm.core, res.core),
            "a second fit gave other labels")

    # per-stage times; the largest call of each batched kernel is kept
    captured = {"eps_count_batch": {}, "row_min_batch": {}}
    real_count, real_min = ops.eps_count_batch, ops.row_min_batch

    def keep(name, args):
        """Per candidate width: the largest call's operands, and the
        number of calls."""
        slot = captured[name].setdefault(args[1].shape[1], [args, 0])
        if args[1].numel() > slot[0][1].numel():
            slot[0] = args
        slot[1] += 1

    def keep_count(a, b, eps_, valid_b=None, valid_a=None, *, stop_at=None):
        keep("eps_count_batch", (a, b, valid_b, valid_a, eps_, stop_at))
        return real_count(a, b, eps_, valid_b, valid_a, stop_at=stop_at)

    def keep_min(a, b, valid_b=None):
        keep("row_min_batch", (a, b, valid_b))
        return real_min(a, b, valid_b)

    ops.eps_count_batch, ops.row_min_batch = keep_count, keep_min
    sync.TIMING["on"] = True
    sync.STAGES.clear()
    try:
        staged = cluster(pts, eps, MIN_PTS, engine="device-kernels", caps=caps)
    finally:
        sync.TIMING["on"] = False
        ops.eps_count_batch, ops.row_min_batch = real_count, real_min
    require(np.array_equal(staged.labels, res.labels), "staged fit differs")
    emit("fit", n=args.n, d=int(pts.shape[1]), eps=eps, min_pts=MIN_PTS,
         data_s=t_data, estimate_caps_s=estimate_s, cold_s=cold_s,
         warm_s=warm_s,
         attempts=[list(a["overflow"]) for a in res.attempts],
         caps=dataclasses.asdict(caps), clusters=res.n_clusters,
         noise=res.noise_count, core=int(res.core.sum()),
         launches=launches, host_reads_cold=cold_reads,
         host_reads_warm=warm_reads,
         stage_s={k: round(v, 6) for k, v in sync.STAGES.items()},
         max_memory_allocated=peak_bytes)

    # ---- kernels --------------------------------------------------------
    pairwise_build = pairwise_build_report()
    rows, tiers, main_path, cases, band_rows, routes = kernels_phase(
        captured, dev, baseline)
    emit("kernels", comparisons=cases, rows_in_eps_band=band_rows,
         tolerance="integer outputs equal; d2 rtol 1e-6 (equal on lattices)",
         shapes={r["name"]: r["shape"] for r in rows}, routes=routes,
         pairwise_build=pairwise_build, main_path_widths=tiers,
         main_path=main_path,
         floor_ms_is="an instruction-count estimate at the 1.98 GHz boost "
                     "clock, not a measurement",
         unbatched=[r for r in rows if r["name"] in ("eps_count", "row_min")])

    # ---- check ----------------------------------------------------------
    t0 = time.perf_counter()
    plain = cluster(pts, eps, MIN_PTS, engine="device", caps=caps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(np.array_equal(plain.labels, res.labels),
            "engine 'device' (plain plane) gives other labels")
    require(np.array_equal(plain.core, res.core),
            "engine 'device' (plain plane) gives other core flags")
    t0 = time.perf_counter()
    small, small_eps = make_points(20_000, args.seed + 1)
    got = cluster(small, small_eps, MIN_PTS, engine="device-kernels")
    ref = cluster(small, small_eps, MIN_PTS, engine="brute")
    assert_labels_conformant(small, small_eps, MIN_PTS, ref.labels,
                             got.labels, core=ref.core)
    require(np.array_equal(got.core, ref.core),
            "core flags differ from brute at n = 20,000")
    emit("check", plain_plane_equal=True, plain_plane_s=plain_s,
         brute_n=20_000, brute_eps=small_eps, brute_clusters=ref.n_clusters,
         brute_s=time.perf_counter() - t0)

    # ---- serve ----------------------------------------------------------
    before_serve = dict(ops.LAUNCHES)    # serve_phase resets the counts
    serve, serve_launches, predict_call, index, serve_carry = serve_phase(
        pts, eps, caps, res.labels, args.seed, dev)
    require(serve_launches["row_min_batch"] > 0,
            "kernel-mode predict never launched row_min_batch")
    # the largest kernel-mode predict call: row_min_batch against its
    # plain version, timed (beside the baseline build when one is given)
    pa, pb, pvb = predict_call
    err, _, mism = compare_row_min(ops, pa, pb, pvb, True)
    require(err == 0.0 and mism == 0, f"row_min_batch differs from its "
            f"plain version on the predict call: err={err} argmin={mism}")
    predict_row_min = dict(shape=[*pa.shape[:2], pb.shape[1], pa.shape[2]],
                           kernel_route=ops.pairwise_route(pa.shape[2]),
                           **time_distance(ops._lib(), baseline,
                                           "row_min_batch", (pa, pb, pvb),
                                           lambda: ops.row_min_batch(pa, pb,
                                                                     pvb)))
    emit("serve", **serve, launches=serve_launches,
         predict_row_min=predict_row_min)

    # ---- brute ------------------------------------------------------------
    emit("brute", **brute_phase(pts, eps, res, index, dev),
         script_s=time.perf_counter() - t_script)

    # ---- server ---------------------------------------------------------
    before_server = dict(ops.LAUNCHES)  # server_phase resets the counts
    server, server_launches, server_call, server_carry = server_phase(
        index, pts, eps, args.seed, smi)
    # server B's largest kernel-mode predict call against the plain version
    sa_, sb_, svb_ = server_call
    err, _, mism = compare_row_min(ops, sa_, sb_, svb_, True)
    require(err == 0.0 and mism == 0, f"row_min_batch differs from its "
            f"plain version on server B's call: err={err} argmin={mism}")
    emit("server", **server, launches=server_launches,
         reduced=[dict(key="predicts", published=96, run=SERVER_PREDICTS,
                       why="the script's wall time: within 970 s (with 96 "
                           "it took up to 1,158 s on an H100 machine)")],
         row_min_batch_call=dict(shape=[*sa_.shape[:2], sb_.shape[1],
                                        sa_.shape[2]],
                                 max_abs_err=err, argmin_mismatches=mism),
         script_s=time.perf_counter() - t_script)
    del server_call, sa_, sb_, svb_

    # ---- syncs ------------------------------------------------------------
    syncs = syncs_phase(index, server_carry, smi)
    emit("syncs", **syncs, script_s=time.perf_counter() - t_script)

    # ---- sharded ----------------------------------------------------------
    before_sharded = dict(ops.LAUNCHES)  # sharded_phase resets the counts
    sharded, sharded_launches, sharded_spent, mesh_carry = sharded_phase(
        pts, eps, res, serve_carry, server_carry, args.seed, dev, smi)
    emit("sharded", **sharded, launches=sharded_launches,
         script_s=time.perf_counter() - t_script)
    del serve_carry, server_carry
    torch.cuda.empty_cache()

    # ---- mesh ---------------------------------------------------------------
    mesh_launches = mesh_phase(pts, eps, mesh_carry, res, args.seed, dev,
                               smi, t_script)
    del mesh_carry
    torch.cuda.empty_cache()

    # ---- guard-band kernels ---------------------------------------------
    _, lo2, hi2 = index.device_state.thresholds(index)
    eps_lo, eps_hi = math.sqrt(lo2), math.sqrt(hi2)
    band_rows_, band_tiers, band_cases, band_in = guard_band_phase(
        captured["eps_count_batch"], predict_call, eps_lo, eps_hi, dev,
        baseline)
    captured.clear()
    emit("guard_band", comparisons=band_cases, rows_in_band=band_in,
         eps_lo=eps_lo, eps_hi=eps_hi,
         tolerance="integer outputs and argmins equal; min and runner-up "
                   "equal on lattices and on the predict call, rtol 1e-6 "
                   "on random reals",
         predict_call=band_rows_, fit_widths=band_tiers,
         floor_ms_is="an instruction-count estimate at the 1.98 GHz boost "
                     "clock, not a measurement",
         script_s=time.perf_counter() - t_script)
    after_band = dict(ops.LAUNCHES)
    # phase cost fits the same points again, warm (host arrays only)
    cost_fit = (pts, eps, caps, res.labels)
    del index, predict_call, band_tiers, pts, res, warm, staged, plain
    torch.cuda.empty_cache()

    # ---- flash attention ------------------------------------------------
    flash_build = flash_build_report()
    flash_rows = flash_phase(dev, args.seed)
    emit("flash", cases=flash_rows, wgmma_build=flash_build,
         script_s=time.perf_counter() - t_script)
    flash_compare = ops.LAUNCHES["flash_attention"]
    torch.cuda.empty_cache()

    # ---- lm -------------------------------------------------------------
    lm, lm_launches = lm_phase(dev, args.seed)
    emit("lm", **lm, script_s=time.perf_counter() - t_script)
    torch.cuda.empty_cache()

    # ---- families ---------------------------------------------------------
    families_launches = families_phase(dev, args.seed, t_script)
    require(families_launches["flash_attention"] > 0,
            "families: the served families never launched flash_attention")
    torch.cuda.empty_cache()

    # ---- train ------------------------------------------------------------
    train_launches = train_phase(dev, args.seed, t_script)
    torch.cuda.empty_cache()

    # ---- cost -------------------------------------------------------------
    cost_launches = cost_phase(dev, args.seed, cost_fit, smi, t_script)
    del cost_fit

    # launches on the eight driven paths (the cold fit, the serve phase,
    # the server phase, the sharded phase's cold distributed fit plus
    # server C, the mesh phase's rank fits, the lm and families phases'
    # served parts, the train phase), each counted on its own run; the
    # distance kernels have no place on the LM paths and flash none on
    # the other five; the train path launches none (its phase requires
    # it); launches_script also counts the comparison launches and phase
    # cost's counted and timed runs
    by_path = {name: {"fit": launches[name], "serve": serve_launches[name],
                      "server": server_launches[name],
                      "sharded": sharded_launches[name],
                      "mesh": mesh_launches[name],
                      "lm": lm_launches[name],
                      "families": families_launches[name],
                      "train": train_launches[name]}
               for name in REPLACES}
    for name, paths in by_path.items():
        off = (("fit", "serve", "server", "sharded", "train")
               if name == "flash_attention"
               else ("lm", "families", "train"))
        require(all(paths[p] == 0 for p in off),
                f"{name} launched on a path it has no place on: {paths}")
    extra = ("kernel_route", "graph_ms", "parent_ms", "parent_graph_ms")
    kernels = [dict(name=r["name"], route="cuda", source=PAIRWISE_SOURCE,
                    replaces=REPLACES[r["name"]],
                    launches=sum(by_path[r["name"]].values()),
                    launches_by_path=by_path[r["name"]],
                    launches_script=(before_serve[r["name"]]
                                     + before_server[r["name"]]
                                     + before_sharded[r["name"]]
                                     + sharded_spent[r["name"]]
                                     + mesh_launches[r["name"]]
                                     + after_band[r["name"]]
                                     + lm_launches[r["name"]]
                                     + families_launches[r["name"]]
                                     + train_launches[r["name"]]
                                     + cost_launches[r["name"]]),
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None,
                    **{k: r[k] for k in extra if k in r})
               for r in rows + band_rows_]
    fr = flash_rows[0]                  # the lm path's prefill call
    kernels.append(dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE,
        kernel_route=fr["route"], kv_heads=fr["kv_heads"],
        replaces=REPLACES["flash_attention"],
        launches=sum(by_path["flash_attention"].values()),
        launches_by_path=by_path["flash_attention"],
        launches_script=(before_serve["flash_attention"]
                         + before_server["flash_attention"]
                         + before_sharded["flash_attention"]
                         + sharded_spent["flash_attention"]
                         + mesh_launches["flash_attention"]
                         + flash_compare + lm_launches["flash_attention"]
                         + families_launches["flash_attention"]
                         + train_launches["flash_attention"]
                         + cost_launches["flash_attention"]),
        shape=fr["shape"], dtype=fr["dtype"], max_abs_err=fr["max_abs_err"],
        ms=fr["ms"], plain_ms=fr["plain_ms"], bound_ms=fr["bound_ms"],
        bound_by=fr["bound_by"], library_ms=fr["library_ms"]))
    require(len(kernels) == 7, f"{len(kernels)} kernels in the summary")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
