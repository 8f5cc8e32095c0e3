"""Serving on a mesh without gathering the KV cache, and the tensor-parallel
rwkv6, whisper and zamba2 (``launch/specs.py::prefill_on_mesh`` /
``decode_on_mesh``, ``models/tensor_parallel.py``).

Four ranks of a gloo process group on the CPU, in one spawn, lay a 2 x 2
and a 1 x 4 ``DeviceMesh`` over the same ranks.  Every case runs through
the entry points a caller uses: params placed by ``param_shardings``,
the batch by ``batch_shardings``, a cache made whole by ``init_cache``
and placed by ``cache_shardings``, then ``prefill_on_mesh`` and
``decode_on_mesh`` on the placed trees, each decode step on the cache the
last call returned.  Float32, and every logit held at 1e-4 to the port's
single process and to the reference's single-device jit ``prefill`` /
``decode_step`` on the same numpy params:

* (a) qwen2's smoke config on 1 x 4: its 2 KV heads do not split 4 ways,
  so the cache's sequence is sharded over 'model' (4 of 16 positions a
  rank).  Every returned cache leaf is the placed tree's own ``DTensor``
  in ``cache_shardings``' placements, no ``_c10d_functional`` all-gather
  moves a cache leaf (a dispatch mode records them), and a decode step's
  all-reduces of its attention are, a layer, the reference's three: the
  row max [B, H, 1], its sum of ``exp`` [B, H, 1] and ``P V`` [B, H, 1,
  Dh], after an all-gather of q's heads (one a rank);
* (b) batch 1 on 2 x 2, qwen2's smoke config with one KV head: the
  sequence over ('data', 'model');
* (c) mixtral's smoke config on 1 x 4 (window 16, 2 KV heads: a 16-slot
  ring, 4 slots a rank), a 20-token prompt and 3 decode steps, so the
  ring's slot wraps across the shards; whisper's with one KV head on 2 x
  2, whose cross-attention K / V are sharded over the frames too (the
  prefill's cross-attention is split over them as a decode step's is);
* (d) rwkv6, whisper and zamba2 smoke served on 2 x 2 and 1 x 4 (rwkv6's
  time mix splits its 2 heads on 2 x 2 and stays whole on 1 x 4; zamba2's
  ``ssm`` state, split over heads on 2 x 2, is computed whole and written
  back as the rank's slice), and their TP train step on 2 x 2 against one
  device's, the port's and the reference's (loss 1e-4, params rtol 2e-4 +
  atol 1e-5 wherever the first step's |g| exceeds 1e-5: AdamW moves an
  entry whose gradient is near 0 by up to lr either way);
* (f) the placed tree comes back: the leaves ``prefill_on_mesh`` and
  ``decode_on_mesh`` return are the caller's ``DTensor`` s, and a decode
  through the caller's own placed cache gives one device's logits.

In this process: (e) the per-rank dot FLOPs of the new families' split
parts halve at a model axis of 2 (over a fake process group), and (g)
the reference's own decode attention compiled with k / v sharded on the
sequence over 'model' on a 4-device host mesh has no all-gather and the
three all-reduces the port's combine sends.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeCfg

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPAWN_TIMEOUT = 300
LOGIT_TOL, LOSS_TOL, RTOL, ATOL = 1e-4, 1e-4, 2e-4, 1e-5
GRAD_FLOOR = 1e-5
AGAINST = ("port", "reference")
BATCH = 4

# (arch, mesh, config overrides, batch, prompt length, decode steps, cache
# length): each cache length divides over the sequence group
SEQ_CASES = {
    "qwen2_1x4": ("qwen2-1.5b", (1, 4), {}, BATCH, 12, 3, 16),
    "qwen2_b1_2x2": ("qwen2-1.5b", (2, 2), {"num_kv_heads": 1}, 1, 12, 3,
                     16),
    "mixtral_ring_1x4": ("mixtral-8x7b", (1, 4), {}, BATCH, 20, 3, 24),
    # one KV head: the decoder's cache and the cross-attention K / V of the
    # 24 frames both sequence-sharded over 'model'
    "whisper_kv1_2x2": ("whisper-small", (2, 2), {"num_kv_heads": 1}, BATCH,
                        12, 3, 16),
}
FAMILY_ARCHS = ("rwkv6-3b", "whisper-small", "zamba2-2.7b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
FAMILY_SEQ, FAMILY_DECODE = 16, 2


def _cfg(arch, **kw):
    from repro_torch.launch.specs import model_cfg_for
    cfg = model_cfg_for(arch, smoke=True).with_overrides(
        dtype="float32", remat=False, **kw)
    if cfg.moe is not None:         # nothing dropped
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


def _case(arch, overrides, batch, prompt, decode, seed):
    """(config, seeded numpy params, prompt batch (+ whisper's frames),
    decode tokens [steps, batch])."""
    from repro_torch import convert
    from repro_torch.models import init_params
    cfg = _cfg(arch, **overrides)
    params = convert.lm_params_to_numpy(
        init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt)
                                ).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)
                                 ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (decode, batch)).astype(np.int32)
    return cfg, params, b, toks


def _seq_case(name):
    arch, _, kw, batch, prompt, decode, _ = SEQ_CASES[name]
    return _case(arch, kw, batch, prompt, decode, 27)


def _family_case(arch):
    return _case(arch, {}, BATCH, FAMILY_SEQ, FAMILY_DECODE, 28)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

class _Collectives(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (collective, group name, input shape, reduce op) of every
    ``_c10d_functional`` collective dispatched under it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name.startswith("_c10d_functional::") and "wait" not in name:
            op = args[1] if name.endswith("::all_reduce") else None
            self.calls.append((name.split("::")[1], args[-1],
                               tuple(args[0].shape), op))
        return func(*args, **(kwargs or {}))


def _place(tree, shardings):
    from repro_torch.launch import sharding as shd
    return shd.place_tree(tree, shardings)


def _serve_on_mesh(cfg, mesh, params, batch, toks, max_len, record=False):
    """Last-position logits of this rank's rows through ``prefill_on_mesh``
    and a ``decode_on_mesh`` per step of ``toks``, each on the cache the
    last call returned; and what came back: whether every returned cache
    leaf is the placed tree's own ``DTensor`` in ``cache_shardings``'
    placements, the local shapes, and (``record``) the decode steps'
    collectives."""
    from torch.distributed.tensor import DTensor

    from repro_torch import convert
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import decode_on_mesh, prefill_on_mesh
    from repro_torch.models import init_cache
    from repro_torch.train.tree import flatten
    p = convert.lm_params_from_numpy(params)
    placed = _place(p, shd.param_shardings(cfg, mesh, p))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    pb = _place(b, shd.batch_shardings(cfg, mesh, b))
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    whole = init_cache(cfg, b["tokens"].shape[0], max_len + extra, "cpu")
    shardings = shd.cache_shardings(cfg, mesh, whole)
    pc = _place(whole, shardings)
    rec = _Collectives()
    with torch.no_grad():
        logits, c = prefill_on_mesh(cfg, mesh, placed, pb, pc)
        got = [logits.numpy()]
        for t in toks:
            tt = {"tokens": torch.from_numpy(t)}
            tt = _place(tt, shd.batch_shardings(cfg, mesh, tt))
            if record:
                with rec:
                    logits, c = decode_on_mesh(cfg, mesh, placed,
                                               tt["tokens"], c)
            else:
                logits, c = decode_on_mesh(cfg, mesh, placed, tt["tokens"],
                                           c)
            got.append(logits.numpy())
    leaves = flatten(pc["slots"])[0]
    back = flatten(c["slots"])[0]
    sh = flatten(shardings["slots"])[0]
    same = [a is b and isinstance(a, DTensor)
            and tuple(a.placements) == shd.placements(mesh, s.spec)
            for a, b, s in zip(leaves, back, sh)]
    keys = [k for slot in whole["slots"] for k in sorted(slot)]
    return {"logits": got, "pos": c["pos"], "same": same,
            "local": {k: tuple(t.to_local().shape)
                      for k, t in zip(keys, back)},
            "cache_dims": sorted({tuple(sorted(t.to_local().shape))
                                  for t in back}),
            "calls": rec.calls, "model_group":
                mesh.get_group("model").group_name}


def _seq_placed_again(mesh):
    """(f): prefill + 2 decode steps, then a third step through the
    caller's own placed cache (its ``pos`` set by the caller)."""
    from repro_torch import convert
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import decode_on_mesh, prefill_on_mesh
    from repro_torch.models import init_cache
    cfg, params, batch, toks = _seq_case("qwen2_1x4")
    max_len = SEQ_CASES["qwen2_1x4"][-1]
    p = convert.lm_params_from_numpy(params)
    placed = _place(p, shd.param_shardings(cfg, mesh, p))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    pb = _place(b, shd.batch_shardings(cfg, mesh, b))
    whole = init_cache(cfg, BATCH, max_len, "cpu")
    pc = _place(whole, shd.cache_shardings(cfg, mesh, whole))
    kinds = []
    with torch.no_grad():
        _, c = prefill_on_mesh(cfg, mesh, placed, pb, pc)
        kinds.append([type(t).__name__ for t in
                      (c["slots"][0]["k"], c["slots"][0]["v"])])
        for t in toks[:2]:
            tt = {"tokens": torch.from_numpy(t)}
            tt = _place(tt, shd.batch_shardings(cfg, mesh, tt))
            _, c = decode_on_mesh(cfg, mesh, placed, tt["tokens"], c)
        same = c["slots"][0]["k"] is pc["slots"][0]["k"]
        pc["pos"] = c["pos"]
        tt = {"tokens": torch.from_numpy(toks[2])}
        tt = _place(tt, shd.batch_shardings(cfg, mesh, tt))
        logits, _ = decode_on_mesh(cfg, mesh, placed, tt["tokens"], pc)
    return {"kinds": kinds, "same": same, "logits": logits.numpy()}


def _train_on_mesh(cfg, mesh, params, batch):
    """One TP train step (adamw, no weight decay, lr 1e-3) on placed
    state: (loss, the params after it, whole, in leaf order)."""
    from repro_torch import convert
    from repro_torch.launch import sharding as shd
    from repro_torch.train import (TrainCfg, get_optimizer, init_state,
                                   make_train_step)
    from repro_torch.train.tree import flatten
    tcfg, opt = TrainCfg(), get_optimizer("adamw", weight_decay=0.0)
    step = make_train_step(cfg, tcfg, opt, lambda s: 1e-3, mesh=mesh)
    state = init_state(cfg, tcfg, opt, convert.lm_params_from_numpy(params))
    state = _place(state, shd.state_shardings(cfg, mesh, state))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, m = step(state, _place(b, shd.batch_shardings(cfg, mesh, b)))
    return float(m["loss"]), [t.numpy() for t in flatten(
        shd.gather_tree(state["params"]))[0]]


def _train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, FAMILY_SEQ + 1)
                                ).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(BATCH, cfg.enc_seq, cfg.d_model)
                                 ).astype(np.float32)
    return b


def _rank_work(rank, world, dev, _):
    torch.set_num_threads(2)
    from repro_torch.launch.mesh import make_mesh
    meshes = {name: make_mesh(shape, ("data", "model"), "cpu")
              for name, shape in MESHES.items()}
    out = {"seq": {}, "families": {}, "train": {}}
    for name, (arch, shape, kw, batch, prompt, decode, S_c) in \
            SEQ_CASES.items():
        cfg, params, b, toks = _seq_case(name)
        mesh = meshes["x".join(map(str, shape))]
        out["seq"][name] = _serve_on_mesh(cfg, mesh, params, b, toks, S_c,
                                          record=True)
    out["again"] = _seq_placed_again(meshes["1x4"])
    for arch in FAMILY_ARCHS:
        cfg, params, b, toks = _family_case(arch)
        for name, mesh in meshes.items():
            out["families"][arch, name] = _serve_on_mesh(
                cfg, mesh, params, b, toks, FAMILY_SEQ + FAMILY_DECODE)
        out["train"][arch] = _train_on_mesh(cfg, meshes["2x2"], params,
                                            _train_batch(cfg, 29))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks
    return spawn_ranks(_rank_work, 4, device="cpu", args=(None,),
                       timeout=SPAWN_TIMEOUT,
                       workdir=str(tmp_path_factory.mktemp("tp_serve")))


# --------------------------------------------------------------------------
# one device: the port's and the reference's
# --------------------------------------------------------------------------

def _port_serve(cfg, params, batch, toks, max_len):
    from repro_torch import convert
    from repro_torch.models import decode_step, init_cache, prefill
    p = convert.lm_params_from_numpy(params)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        cache = init_cache(cfg, b["tokens"].shape[0], max_len, "cpu")
        logits, cache = prefill(cfg, p, b, cache)
        out = [logits.numpy()]
        for t in toks:
            logits, cache = decode_step(cfg, p, torch.from_numpy(t), cache)
            out.append(logits.numpy())
    return out


def _jax_cfg(cfg):
    """The reference's ``LMConfig`` of the port's ``cfg`` (the same
    schema, field for field), its attention plain."""
    from repro.models.config import LMConfig, MoECfg
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        kw["moe"] = MoECfg(**dataclasses.asdict(cfg.moe))
    return LMConfig(**kw).with_overrides(use_flash_kernel=False)


def _reference_serve(cfg, params, batch, toks, max_len):
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    jcfg = _jax_cfg(cfg)
    p = jax.tree.map(jnp.asarray, params)
    cache = jlm.init_cache(jcfg, batch["tokens"].shape[0], max_len)
    logits, cache = jax.jit(lambda p, b, c: jlm.prefill(jcfg, p, b, c))(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, cache)
    out = [np.asarray(logits, np.float32)]
    step = jax.jit(lambda p, t, c: jlm.decode_step(jcfg, p, t, c))
    for t in toks:
        logits, cache = step(p, jnp.asarray(t), cache)
        out.append(np.asarray(logits, np.float32))
    return out


def _one_device(against, cfg, params, batch, toks, max_len):
    fn = _port_serve if against == "port" else _reference_serve
    return fn(cfg, params, batch, toks, max_len)


def _rank_rows(i, mesh_shape, batch):
    """The batch rows rank ``i`` serves: its data block's, or every row
    where the batch axes do not split the batch."""
    n_data, n_model = mesh_shape
    if batch % n_data:
        return slice(None)
    k = batch // n_data
    return slice((i // n_model) * k, (i // n_model + 1) * k)


def _assert_logits(got, want, rows):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w[rows].shape
        np.testing.assert_allclose(g, w[rows], rtol=0, atol=LOGIT_TOL)


# --------------------------------------------------------------------------
# (a) - (c): a sequence-sharded cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_sequence_sharded_cache_serves_as_one_device(ranks, case, against):
    cfg, params, batch, toks = _seq_case(case)
    _, shape, _, B, _, _, S_c = SEQ_CASES[case]
    want = _one_device(against, cfg, params, batch, toks, S_c)
    for i, r in enumerate(ranks):
        _assert_logits(r["seq"][case]["logits"], want,
                       _rank_rows(i, shape, B))


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_cache_comes_back_in_its_placements(ranks, case):
    """Every returned cache leaf is the placed tree's own ``DTensor`` in
    ``cache_shardings``' placements, its KV caches holding every KV head
    and ``1 / G`` of the sequence."""
    cfg, _, _, _ = _seq_case(case)
    _, shape, _, B, prompt, decode, S_c = SEQ_CASES[case]
    if cfg.attn_kind == "swa":
        S_c = min(S_c, cfg.window)
    G = shape[1] if B % shape[0] == 0 and shape[0] > 1 else shape[0] * \
        shape[1]
    rows = B // shape[0] if B % shape[0] == 0 else B
    for r in ranks:
        got = r["seq"][case]
        assert all(got["same"]) and got["pos"] == prompt + decode
        for name in ("k", "v"):
            assert got["local"][name] == (cfg.num_layers, rows,
                                          cfg.num_kv_heads, S_c // G,
                                          cfg.head_dim)
        if cfg.family == "encdec":
            assert got["local"]["xk"][3] == cfg.enc_seq // G


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_no_collective_moves_a_cache_leaf(ranks, case):
    """No all-gather of a decode step sends a local cache leaf
    (``gather_leaf`` sends it whole, the gathered dim moved first: the
    same dims in another order)."""
    for r in ranks:
        got = r["seq"][case]
        moved = {tuple(sorted(s)) for c, _, s, _ in got["calls"]
                 if c == "all_gather_into_tensor"}
        assert moved and not moved & {tuple(d) for d in got["cache_dims"]}


def _combine_calls(got, B, H, Dh):
    """The decode steps' all-reduces of the split attention's shapes, as
    (shape, op) in order."""
    shapes = {(B, H, 1), (B, H, 1, Dh)}
    return [(s, op) for c, _, s, op in got["calls"]
            if c == "all_reduce" and s in shapes]


def test_decode_combine_sends_the_references_three_all_reduces(ranks):
    """qwen2 on 1 x 4: a layer's decode attention sends the row max [B, H,
    1], its sum [B, H, 1] and ``P V`` [B, H, 1, Dh] over 'model', the
    shapes of the reference's compiled HLO (test (g)), after the q heads'
    all-gather (one head a rank)."""
    cfg, _, _, toks = _seq_case("qwen2_1x4")
    B, H, Dh, L = BATCH, cfg.num_heads, cfg.head_dim, cfg.num_layers
    per_layer = [((B, H, 1), "max"), ((B, H, 1), "sum"),
                 ((B, H, 1, Dh), "sum")]
    for r in ranks:
        got = r["seq"]["qwen2_1x4"]
        calls = _combine_calls(got, B, H, Dh)
        assert calls == per_layer * (L * len(toks))
        q = [s for c, g, s, _ in got["calls"]
             if c == "all_gather_into_tensor" and s == (1, B, 1, Dh)]
        assert len(q) == L * len(toks)
        assert all(g == got["model_group"] for c, g, s, op in got["calls"]
                   if c == "all_reduce" and (s, op) in per_layer)


def test_batch_one_combines_over_data_and_model(ranks):
    """Batch 1 on 2 x 2: the sequence over ('data', 'model'), each of the
    three sums over 'model' and then 'data'."""
    cfg, _, _, toks = _seq_case("qwen2_b1_2x2")
    calls = _combine_calls(ranks[0]["seq"]["qwen2_b1_2x2"], 1,
                           cfg.num_heads, cfg.head_dim)
    per_layer = [((1, 4, 1), "max")] * 2 + [((1, 4, 1), "sum")] * 2 + \
        [((1, 4, 1, cfg.head_dim), "sum")] * 2
    assert calls == per_layer * (cfg.num_layers * len(toks))


# --------------------------------------------------------------------------
# (d) rwkv6, whisper, zamba2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_serves_tensor_parallel(ranks, arch, mesh, against):
    cfg, params, batch, toks = _family_case(arch)
    want = _one_device(against, cfg, params, batch, toks,
                       FAMILY_SEQ + FAMILY_DECODE)
    for i, r in enumerate(ranks):
        got = r["families"][arch, mesh]
        assert all(got["same"])
        _assert_logits(got["logits"], want, _rank_rows(i, MESHES[mesh],
                                                       BATCH))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_cache_keeps_its_head_shards(ranks, arch):
    """On 2 x 2 each rank's KV caches hold its half of the KV heads, and
    rwkv6's ``wkv`` / zamba2's ``ssm`` state its half of the heads (the
    ``ssm`` state written back after a whole compute)."""
    cfg, _, _, _ = _family_case(arch)
    for r in ranks:
        local = r["families"][arch, "2x2"]["local"]
        for name in ("k", "v", "xk", "xv"):
            if name in local:
                assert local[name][2] == cfg.num_kv_heads // 2
        if "wkv" in local:
            assert local["wkv"][2] == cfg.num_heads // 2
        if "ssm" in local:
            assert local["ssm"][2] == cfg.n_ssm_heads // 2


def _single_step(cfg, params, batch):
    """The port's single-process step and its gradients (for the floor)."""
    from repro_torch import convert
    from repro_torch.train import (TrainCfg, get_optimizer, init_state,
                                   make_train_step)
    from repro_torch.train.step import grads_of
    from repro_torch.train.tree import flatten
    opt = get_optimizer("adamw", weight_decay=0.0)
    step = make_train_step(cfg, TrainCfg(), opt, lambda s: 1e-3)
    p = convert.lm_params_from_numpy(params)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = [g.numpy() for g in flatten(grads_of(cfg, p, b)[2])[0]]
    state, m = step(init_state(cfg, TrainCfg(), opt, p), b)
    return float(m["loss"]), [t.numpy() for t in flatten(
        state["params"])[0]], grads


def _reference_step(cfg, params, batch):
    import jax
    import jax.numpy as jnp
    from repro import train as jtrain
    from repro_torch.train.tree import flatten
    jcfg = _jax_cfg(cfg)
    tcfg = jtrain.TrainCfg()
    opt = jtrain.get_optimizer("adamw", weight_decay=0.0)
    step = jax.jit(jtrain.make_train_step(jcfg, tcfg, opt, lambda s: 1e-3))
    state = jtrain.init_state(jcfg, tcfg, opt,
                              jax.tree.map(jnp.asarray, params))
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m["loss"]), flatten(jax.tree.map(np.asarray,
                                                  state["params"]))[0]


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_tp_train_step_equals_one_device(ranks, arch, against):
    cfg, params, _, _ = _family_case(arch)
    batch = _train_batch(cfg, 29)
    loss, want, grads = _single_step(cfg, params, batch)
    if against == "reference":
        loss, want = _reference_step(cfg, params, batch)
    for r in ranks:
        got_loss, got = r["train"][arch]
        assert abs(got_loss - loss) < LOSS_TOL
        assert len(got) == len(want)
        for a, b, g in zip(got, want, grads):
            held = np.abs(g) > GRAD_FLOOR
            np.testing.assert_allclose(a[held], np.asarray(b)[held],
                                       rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# (f) the placed tree comes back
# --------------------------------------------------------------------------

@pytest.mark.parametrize("against", AGAINST)
def test_decode_through_the_callers_placed_cache(ranks, against):
    """The returned KV leaves are ``DTensor`` s, the caller's own, and a
    decode step through the caller's placed cache (its ``pos`` moved on)
    gives the logits of one device's third step."""
    cfg, params, batch, toks = _seq_case("qwen2_1x4")
    want = _one_device(against, cfg, params, batch, toks,
                       SEQ_CASES["qwen2_1x4"][-1])[3]
    for r in ranks:
        got = r["again"]
        assert got["kinds"] == [["DTensor", "DTensor"]] and got["same"]
        np.testing.assert_allclose(got["logits"], want, rtol=0,
                                   atol=LOGIT_TOL)


# --------------------------------------------------------------------------
# (e) the per-rank dot FLOPs at a model axis of 2
# --------------------------------------------------------------------------

def _dot_flops(arch, shape, mesh_shape):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import sharding_ctx
    if mesh_shape is None:
        fn, args, _ = build_cell(arch, shape, device="cpu", smoke=True)
        return dryrun.count_cell(fn, args)[1]["dot_flops"]
    with fake_world(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
        try:
            fn, args, _ = build_cell(arch, shape, device="cpu", smoke=True,
                                     mesh=mesh)
            return dryrun.count_cell(fn, args)[1]["dot_flops"]
        finally:
            sharding_ctx.set_policy(None)
            sharding_ctx.set_shardmap_moe(None)


def _split_part(arch, B, S, one):
    """The dot FLOPs of a prefill of ``B`` x ``S`` that split over the
    model axis, of the one-device count ``one``: rwkv6's all but the
    decay's low-rank input product and the channel mix's ``w_r``; zamba2's
    shared block (direct attention, its GLU) at each application and the
    head."""
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models.rwkv import LORA_DIM
    cfg = model_cfg_for(arch, smoke=True)
    T, d = B * S, cfg.d_model
    if cfg.family == "rwkv":
        return one - cfg.num_layers * (2 * T * d * LORA_DIM + 2 * T * d * d)
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shared = 2 * T * d * (H + 2 * KV) * Dh + 2 * T * H * Dh * d + \
        4 * B * H * S * S * Dh + 3 * 2 * T * d * cfg.d_ff
    groups = cfg.num_layers // cfg.shared_attn_every
    return groups * shared + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_whisper_dot_flops_halve_on_a_model_axis_of_2(kind):
    """Every product of whisper splits: the encoder's and the decoder's
    attention and MLPs, the cross-attention K / V, the head."""
    shape = ShapeCfg(f"tp_{kind}", kind, 16, 4)
    one = _dot_flops("whisper-small", shape, None)
    assert one > 0
    assert _dot_flops("whisper-small", shape, (1, 2)) == one / 2


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_split_parts_dot_flops_halve_on_a_model_axis_of_2(arch):
    """A prefill's split parts halve and the rest stays whole: rwkv6's
    time-mix projections, decay columns, scan and ``w_o``, its channel
    mix's ``w_k`` / ``w_v`` and the head halve, its decay low-rank input
    and ``w_r`` stay; zamba2's shared block and head halve, mamba
    stays."""
    B, S = 4, 16
    shape = ShapeCfg("tp_prefill", "prefill", S, B)
    one = _dot_flops(arch, shape, None)
    two = _dot_flops(arch, shape, (1, 2))
    assert 0 < _split_part(arch, B, S, one) < one
    assert two == one - _split_part(arch, B, S, one) / 2


# --------------------------------------------------------------------------
# (g) what the reference compiles
# --------------------------------------------------------------------------

PROBE = textwrap.dedent("""
    import json
    import re

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.models.layers import _broadcast_kv, _masked_decode_attn

    B, S = {B}, {S}
    cfg = get_config("qwen2-1.5b", smoke=True).with_overrides(
        dtype="float32")
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))

    def step(q, k, v, pos):
        idx = jnp.arange(S)
        valid = (idx <= pos) | (pos >= S)
        return _masked_decode_attn(cfg, q, _broadcast_kv(k, cfg.q_per_kv),
                                   _broadcast_kv(v, cfg.q_per_kv), valid,
                                   softcap=cfg.attn_softcap)

    whole = NamedSharding(mesh, P())
    seq = NamedSharding(mesh, P(None, None, "model", None))
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((B, H, 1, Dh), f32),
            jax.ShapeDtypeStruct((B, KV, S, Dh), f32),
            jax.ShapeDtypeStruct((B, KV, S, Dh), f32),
            jax.ShapeDtypeStruct((), jnp.int32))
    hlo = jax.jit(step, in_shardings=(whole, seq, seq, whole)).lower(
        *args).compile().as_text()
    ops = re.findall(r"= (\\w+)\\[([\\d,]*)\\][^=]*? (all-reduce|all-gather)"
                     r"(?:-start)?\\(", hlo)
    print(json.dumps({{"ops": [[kind, [int(x) for x in dims.split(",")
                                        if x]] for _, dims, kind in ops]}}))
""")


def test_reference_decode_attention_compiles_to_the_ports_combine():
    B, S = BATCH, SEQ_CASES["qwen2_1x4"][-1]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", PROBE.format(B=B, S=S)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ops = json.loads(proc.stdout.strip().splitlines()[-1])["ops"]
    from repro_torch.launch.specs import model_cfg_for
    cfg = model_cfg_for("qwen2-1.5b", smoke=True)
    H, Dh = cfg.num_heads, cfg.head_dim
    assert [k for k, _ in ops] == ["all-reduce"] * 3
    assert sorted(s for _, s in ops) == sorted(
        [[B, H, 1], [B, H, 1], [B, H, 1, Dh]])
