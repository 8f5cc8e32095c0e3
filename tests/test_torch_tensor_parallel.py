"""Tensor-parallel compute on the model axis (``models/tensor_parallel.py``).

Four ranks of a gloo process group on the CPU, in one spawn, lay two
``DeviceMesh`` es over the same ranks: 2 x 2 (a model axis of 2 splits
qwen2's smoke config, 4 heads and 2 KV heads, one KV head a rank) and
1 x 4 (one q head a rank, whose KV head is half a rank's columns of
``wk``: the ``M`` does not divide ``KV`` branch, which gathers ``wk`` /
``wv`` and projects the one KV head read).  Float32, remat off.  On each
mesh:

* (a) one TP train step (adamw without weight decay, lr 1e-3) equals the
  port's single-process step on the same params and batch (loss 1e-4;
  params rtol 2e-4 + atol 1e-5) and the reference's step.  The
  reference's sharded ``jit`` step on a 4-device host mesh raises
  ``DuplicateSpecError`` at the embed gather (``src/repro/models/lm.py``'s
  ``params["embed"][tokens]`` under the ("model", "data") embed spec with
  a batch sharded over "data", JAX 0.9.0, as the reference's own LM dry
  run does), so the TP step is held to the reference's single-device
  step, at the same tolerances;
* (b) the vocab-parallel CE of one chunk (its sum, count and the
  gradient of the sum w.r.t. the hidden states) against ``_ce_chunk``
  on whole tensors at 1e-5, and the TP forward's loss of the rank's
  rows against ``loss_fn`` on whole tensors: the port's and the
  reference's (``jax.value_and_grad`` of its ``_ce_chunk``);
* (c) a prefill + 3 decode steps with the flash path on (its plain
  version on the CPU) on each rank's local heads, from a cache that
  ``init_cache`` made under the TP context (the rank's KV heads), against
  the single process and the reference's single-device jit ``prefill`` /
  ``decode_step`` (plain attention) on the same numpy params:
  last-position logits at 1e-4; on 2 x 2 also ``specs.prefill_on_mesh`` /
  ``decode_on_mesh`` over a placed cache whose KV heads stay sharded over
  the model axis;
* (d) what a TP step sends: no all-gather of a dense-trunk param over the
  model axis on 2 x 2 (on 1 x 4 only ``wk`` / ``wv`` / ``bk`` / ``bv``,
  the branch above), counted by a dispatch mode over the
  ``_c10d_functional`` collectives and by ``tensor_parallel.SENT``, both
  counts zeroed and restored around the step;
* the other families' smoke configs (gemma2, stablelm, internvl2,
  mixtral) served on 2 x 2 against the single process and the
  reference's single-device run at 1e-4;
* the MoE variants' gradients on 2 x 2 against ``moe_forward``'s, the
  port's and the reference's (under ``jax.grad``): the expert path's
  tokens and combine weights enter through ``copy_in``, so every model
  rank's gradient w.r.t. its batch block is the whole one.

And in this process, over a fake process group: (e) the dry run's per-rank
dot FLOPs of qwen2's smoke train step and prefill on a model axis of 2 are
exactly half of the one-device count; on 16 x 16 (``M`` does not divide
the 4 heads) a prefill's attention dot FLOPs stay whole while the MLP's
and the head's are 1/16.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeCfg

ARCH = "qwen2-1.5b"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
BATCH, SEQ = 8, 64                 # two CE chunks of the smoke ce_chunk 32
PROMPT, DECODE = 12, 3
LOSS_TOL, RTOL, ATOL = 1e-4, 2e-4, 1e-5
CE_TOL, LOGIT_TOL = 1e-5, 1e-4
SPAWN_TIMEOUT = 300
AGAINST = ("port", "reference")


def _cfg(**kw):
    from repro_torch.launch.specs import model_cfg_for
    return model_cfg_for(ARCH, smoke=True).with_overrides(
        dtype="float32", remat=False, **kw)


def _inputs():
    """Seeded numpy params (the port's init, seed 0), the train batch
    [8, 65], a CE chunk's hidden states and labels, the prompt and the
    decode tokens."""
    from repro_torch import convert
    from repro_torch.models import init_params
    cfg = _cfg()
    params = convert.lm_params_to_numpy(
        init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(26)
    V = cfg.vocab_size
    return {"params": params,
            "tokens": rng.integers(0, V, (BATCH, SEQ + 1)).astype(np.int32),
            "h": rng.normal(size=(BATCH, 32, cfg.d_model)).astype(
                np.float32),
            "labels": rng.integers(0, V, (BATCH, 32)).astype(np.int64),
            "prompt": rng.integers(0, V, (BATCH, PROMPT)).astype(np.int32),
            "decode": rng.integers(0, V, (DECODE, BATCH)).astype(np.int32)}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

class _Collectives(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (collective, group name, elements) of every
    ``_c10d_functional`` collective dispatched under it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name.startswith("_c10d_functional::") and "wait" not in name:
            self.calls.append((name.split("::")[1], args[-1],
                               args[0].numel()))
        return func(*args, **(kwargs or {}))


def _rows(a, mesh):
    r, n = mesh.get_local_rank("data"), mesh.size(0)
    k = a.shape[0] // n
    return a[r * k:(r + 1) * k]


def _on_mesh(mesh, inp):
    """One mesh's cases on this rank."""
    from repro_torch import convert
    from repro_torch.dist import comm
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import decode_on_mesh, prefill_on_mesh
    from repro_torch.models import (decode_step, init_cache, lm, prefill,
                                    sharding_ctx)
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.train import (TrainCfg, get_optimizer, init_state,
                                   make_train_step)
    from repro_torch.train.tree import flatten

    out = {}
    cfg = _cfg()
    params = convert.lm_params_from_numpy(inp["params"])
    model_group = mesh.get_group("model").group_name

    # (a) + (d): one TP train step, its collectives recorded
    tcfg, opt = TrainCfg(), get_optimizer("adamw", weight_decay=0.0)
    step = make_train_step(cfg, tcfg, opt, lambda s: 1e-3, mesh=mesh)
    state = init_state(cfg, tcfg, opt, params)
    state = shd.place_tree(state, shd.state_shardings(cfg, mesh, state))
    batch = {"tokens": torch.from_numpy(inp["tokens"])}
    placed = shd.place_tree(batch, shd.batch_shardings(cfg, mesh, batch))
    saved = dict(tp.SENT), dict(comm.SENT)
    for d in (tp.SENT, comm.SENT):
        d.update(dict.fromkeys(d, 0))
    rec = _Collectives()
    try:
        with rec:
            state, metrics = step(state, placed)
        out["sent"] = dict(tp.SENT), dict(comm.SENT)
    finally:
        tp.SENT.update(saved[0])
        comm.SENT.update(saved[1])
    out["model_gathers"] = sorted(
        n for c, g, n in rec.calls
        if c == "all_gather_into_tensor" and g == model_group)
    out["model_reduces"] = sum(1 for c, g, _ in rec.calls
                               if c == "all_reduce" and g == model_group)
    out["train"] = (float(metrics["loss"]), int(state["step"]),
                    [l.numpy() for l in flatten(
                        shd.gather_tree(state["params"]))[0]])

    # (b) the vocab-parallel CE of one chunk, and the TP forward's loss
    placed_p = shd.place_tree(params, shd.param_shardings(cfg, mesh, params))
    local = tp.local_params(cfg, placed_p)
    h = torch.from_numpy(_rows(inp["h"], mesh)).requires_grad_(True)
    labels = torch.from_numpy(_rows(inp["labels"], mesh))
    mask = torch.ones(labels.shape)
    with sharding_ctx.tensor_parallel((mesh, "model")):
        s, n = lm._ce_chunk(cfg, local, h, labels, mask)
        (dh,) = torch.autograd.grad(s, h)
        with torch.no_grad():
            loss, _ = lm.loss_fn(cfg, local, {"tokens": torch.from_numpy(
                _rows(inp["tokens"], mesh))})
    out["ce"] = (float(s), float(n), dh.numpy(), float(loss))

    # (c) prefill + decode on the local heads, flash on
    fcfg = cfg.with_overrides(use_flash_kernel=True)
    prompt = torch.from_numpy(_rows(inp["prompt"], mesh))
    toks = [torch.from_numpy(_rows(t, mesh)) for t in inp["decode"]]
    with torch.no_grad(), sharding_ctx.tensor_parallel((mesh, "model")):
        cache = init_cache(fcfg, prompt.shape[0], PROMPT + DECODE, "cpu")
        out["cache_heads"] = cache["slots"][0]["k"].shape[2]
        logits, cache = prefill(fcfg, local, {"tokens": prompt}, cache)
        got = [logits.numpy()]
        for t in toks:
            logits, cache = decode_step(fcfg, local, t, cache)
            got.append(logits.numpy())
    out["serve"] = got
    if mesh.size(1) == 2:
        # the placed cache keeps its KV heads sharded over the model axis
        whole = init_cache(fcfg, BATCH, PROMPT + DECODE, "cpu")
        pc = shd.place_tree(whole, shd.cache_shardings(fcfg, mesh, whole))
        pb = shd.place_tree({"tokens": torch.from_numpy(inp["prompt"])},
                            shd.batch_shardings(fcfg, mesh, {
                                "tokens": torch.from_numpy(inp["prompt"])}))
        with torch.no_grad():
            logits, c = prefill_on_mesh(fcfg, mesh, placed_p, pb, pc)
            placed_got = [logits.numpy()]
            for t in inp["decode"]:
                tt = {"tokens": torch.from_numpy(t)}
                tt = shd.place_tree(tt, shd.batch_shardings(fcfg, mesh, tt))
                pc["pos"] = c["pos"]
                logits, c = decode_on_mesh(fcfg, mesh, placed_p,
                                           tt["tokens"], pc)
                placed_got.append(logits.numpy())
        out["placed_serve"] = placed_got
        out["placed_heads"] = pc["slots"][0]["k"].to_local().shape[2]
    return out


def _moe_cfg(E):
    from repro_torch.models.config import LMConfig, MoECfg
    return LMConfig(name="t", family="moe", num_layers=1, d_model=32,
                    num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                    vocab_size=64, dtype="float32",
                    moe=MoECfg(num_experts=E, top_k=2, d_ff=64,
                               capacity_factor=16.0))


def _moe_inputs(E):
    """Router, expert weights, x [4, 8, 32] and a probe of y's shape."""
    rng = np.random.default_rng(200 + E)
    d, ff = 32, 64
    p = {"router": rng.normal(0, 0.2, (d, E)),
         "w_gate": rng.normal(0, d ** -0.5, (E, d, ff)),
         "w_up": rng.normal(0, d ** -0.5, (E, d, ff)),
         "w_down": rng.normal(0, ff ** -0.5, (E, ff, d))}
    return ({k: v.astype(np.float32) for k, v in p.items()},
            rng.normal(size=(4, 8, d)).astype(np.float32),
            rng.normal(size=(4, 8, d)).astype(np.float32))


def _moe_grads(mesh, E, fn):
    """The gradients of sum(y * probe) through an explicit-collective MoE
    variant on this rank's batch block: w.r.t. the block and the whole
    weights."""
    from repro_torch.models import moe as M
    p, x, probe = _moe_inputs(E)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xb = torch.from_numpy(_rows(x, mesh)).requires_grad_(True)
    y, _ = getattr(M, fn)(_moe_cfg(E), p, xb, mesh, ("data",), "model")
    (y * torch.from_numpy(_rows(probe, mesh))).sum().backward()
    return xb.grad.numpy(), {k: v.grad.numpy() for k, v in p.items()}


MOE_GRAD_CASES = ((4, "moe_forward_shardmap"), (4, "moe_forward_shardmap_ep"))
# the other tensor-parallel families' smoke configs: soft-caps, a local /
# global window past its ring, partial RoPE with layer norm, a VLM's
# patches, a MoE block (nothing dropped) behind split attention
FAMILY_ARCHS = ("gemma2-27b", "stablelm-3b", "internvl2-1b", "mixtral-8x7b")
FAMILY_SEQ = 24


def _family_case(arch):
    """(config, seeded numpy params, prompt batch [4, 24] (+ patches),
    2 decode steps' tokens) of ``arch``'s smoke config in float32."""
    from repro_torch import convert
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models import init_params
    cfg = model_cfg_for(arch, smoke=True).with_overrides(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    params = convert.lm_params_to_numpy(
        init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    rng = np.random.default_rng(len(arch))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, FAMILY_SEQ)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (rng.normal(size=(4, cfg.num_patches,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    return cfg, params, batch, toks


def _family_serve(cfg, params, batch, toks, rows=slice(None)):
    """Last-position logits of a prefill of ``batch``'s ``rows`` and of
    each decode step."""
    from repro_torch.models import decode_step, init_cache, prefill
    b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    B = b["tokens"].shape[0]
    extra = cfg.num_patches if "patches" in b else 0
    with torch.no_grad():
        cache = init_cache(cfg, B, FAMILY_SEQ + extra + len(toks), "cpu")
        logits, cache = prefill(cfg, params, b, cache)
        out = [logits.numpy()]
        for t in toks:
            logits, cache = decode_step(cfg, params, torch.from_numpy(
                t[rows]), cache)
            out.append(logits.numpy())
    return out


def _families_on_mesh(mesh):
    from repro_torch import convert
    from repro_torch.launch import sharding as shd
    from repro_torch.models import sharding_ctx
    from repro_torch.models import tensor_parallel as tp
    out = {}
    r = mesh.get_local_rank("data")
    for arch in FAMILY_ARCHS:
        cfg, params, batch, toks = _family_case(arch)
        params = convert.lm_params_from_numpy(params)
        placed = shd.place_tree(params, shd.param_shardings(cfg, mesh,
                                                            params))
        with sharding_ctx.tensor_parallel((mesh, "model")):
            out[arch] = _family_serve(cfg, tp.local_params(cfg, placed),
                                      batch, toks, slice(2 * r, 2 * r + 2))
    return out


def _rank_work(rank, world, dev, inp):
    torch.set_num_threads(2)
    from repro_torch.launch.mesh import make_mesh
    out = {name: _on_mesh(make_mesh(shape, ("data", "model"), "cpu"), inp)
           for name, shape in MESHES.items()}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out["moe"] = [_moe_grads(mesh, E, fn) for E, fn in MOE_GRAD_CASES]
    out["families"] = _families_on_mesh(mesh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_ranks
    inp = _inputs()
    ranks = spawn_ranks(_rank_work, 4, device="cpu", args=(inp,),
                        timeout=SPAWN_TIMEOUT,
                        workdir=str(tmp_path_factory.mktemp("tp")))
    return inp, ranks


def _single_step(inp):
    """The port's single-process step on the same params and batch."""
    from repro_torch import convert
    from repro_torch.train import (TrainCfg, get_optimizer, init_state,
                                   make_train_step)
    from repro_torch.train.tree import flatten
    cfg = _cfg()
    opt = get_optimizer("adamw", weight_decay=0.0)
    step = make_train_step(cfg, TrainCfg(), opt, lambda s: 1e-3)
    state = init_state(cfg, TrainCfg(), opt,
                       convert.lm_params_from_numpy(inp["params"]))
    state, m = step(state, {"tokens": torch.from_numpy(inp["tokens"])})
    return float(m["loss"]), [l.numpy() for l in flatten(
        state["params"])[0]]


def _reference_step(inp):
    """The reference's single-device jit step on the same numpy params,
    its params in the port's leaf order."""
    import jax
    import jax.numpy as jnp
    from repro import train as jtrain
    from repro.configs import get_config
    from repro_torch.train.tree import flatten
    cfg = get_config(ARCH, smoke=True).with_overrides(dtype="float32",
                                                      remat=False)
    tcfg = jtrain.TrainCfg()
    opt = jtrain.get_optimizer("adamw", weight_decay=0.0)
    step = jax.jit(jtrain.make_train_step(cfg, tcfg, opt, lambda s: 1e-3))
    state = jtrain.init_state(cfg, tcfg, opt,
                              jax.tree.map(jnp.asarray, inp["params"]))
    state, m = step(state, {"tokens": jnp.asarray(inp["tokens"])})
    got = jax.tree.map(np.asarray, state["params"])
    return float(m["loss"]), flatten(got)[0]


def _jax_cfg(cfg):
    """The reference's ``LMConfig`` of the port's ``cfg`` (the same
    schema, field for field), its attention plain."""
    from repro.models.config import LMConfig, MoECfg
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        kw["moe"] = MoECfg(**dataclasses.asdict(cfg.moe))
    return LMConfig(**kw).with_overrides(use_flash_kernel=False)


def _reference_serve(cfg, params, batch, toks, max_len):
    """Last-position logits of the reference's single-device jit
    ``prefill`` of ``batch`` into a ``max_len`` cache and of a
    ``decode_step`` of each of ``toks``, on the numpy ``params``."""
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


# --------------------------------------------------------------------------
# (a) the train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_train_step_equals_one_device(runs, mesh, against):
    inp, ranks = runs
    loss, want = (_single_step if against == "port"
                  else _reference_step)(inp)
    for r in ranks:
        got_loss, steps, got = r[mesh]["train"]
        assert steps == 1
        assert abs(got_loss - loss) < LOSS_TOL
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# (b) the vocab-parallel CE
# --------------------------------------------------------------------------

def _whole_ce(against, inp, rows):
    """(sum, count, d sum / dh, loss) of one CE chunk and of ``loss_fn``
    on ``rows`` with whole logits: the port's or the reference's."""
    cfg = _cfg()
    h, labels = inp["h"][rows], inp["labels"][rows]
    tokens = inp["tokens"][rows]
    if against == "port":
        from repro_torch import convert
        from repro_torch.models import lm
        params = convert.lm_params_from_numpy(inp["params"])
        ht = torch.from_numpy(h).requires_grad_(True)
        lt = torch.from_numpy(labels)
        s, n = lm._ce_chunk(cfg, params, ht, lt, torch.ones(lt.shape))
        (dh,) = torch.autograd.grad(s, ht)
        with torch.no_grad():
            loss, _ = lm.loss_fn(cfg, params,
                                 {"tokens": torch.from_numpy(tokens)})
        return float(s.detach()), float(n), dh.numpy(), float(loss)
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    jcfg = _jax_cfg(cfg)
    p = jax.tree.map(jnp.asarray, inp["params"])
    mask = jnp.ones(labels.shape, jnp.float32)
    s, dh = jax.jit(jax.value_and_grad(lambda x: jlm._ce_chunk(
        jcfg, p, x, jnp.asarray(labels), mask)[0]))(jnp.asarray(h))
    loss, _ = jax.jit(lambda t: jlm.loss_fn(jcfg, p, {"tokens": t}))(
        jnp.asarray(tokens))
    return float(s), float(labels.size), np.asarray(dh), float(loss)


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_vocab_parallel_ce_equals_whole_logits(runs, mesh, against):
    inp, ranks = runs
    k = BATCH // MESHES[mesh][0]
    for i, r in enumerate(ranks):
        rows = slice((i // MESHES[mesh][1]) * k,
                     (i // MESHES[mesh][1] + 1) * k)
        s, n, dh, loss = _whole_ce(against, inp, rows)
        got_s, got_n, got_dh, got_loss = r[mesh]["ce"]
        assert got_n == n
        assert abs(got_s - s) <= CE_TOL * abs(s)
        np.testing.assert_allclose(got_dh, dh, rtol=0,
                                   atol=CE_TOL * float(np.abs(dh).max()))
        assert abs(got_loss - loss) <= CE_TOL * loss


# --------------------------------------------------------------------------
# (c) prefill and decode
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_serve(runs):
    """The whole batch's last-position logits of a prefill and each
    decode step on one device: the port's (flash path on) and the
    reference's."""
    from repro_torch import convert
    from repro_torch.models import decode_step, init_cache, prefill
    inp, _ = runs
    cfg = _cfg(use_flash_kernel=True)
    params = convert.lm_params_from_numpy(inp["params"])
    with torch.no_grad():
        cache = init_cache(cfg, BATCH, PROMPT + DECODE, "cpu")
        logits, cache = prefill(cfg, params, {"tokens": torch.from_numpy(
            inp["prompt"])}, cache)
        out = [logits.numpy()]
        for t in inp["decode"]:
            logits, cache = decode_step(cfg, params, torch.from_numpy(t),
                                        cache)
            out.append(logits.numpy())
    return {"port": out,
            "reference": _reference_serve(_cfg(), inp["params"],
                                          {"tokens": inp["prompt"]},
                                          inp["decode"], PROMPT + DECODE)}


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_and_decode_on_local_heads(runs, single_serve, mesh,
                                           against):
    _, ranks = runs
    n_data, n_model = MESHES[mesh]
    k = BATCH // n_data
    for i, r in enumerate(ranks):
        rows = slice((i // n_model) * k, (i // n_model + 1) * k)
        # one KV head a rank on both meshes: 2 / 2, and the one that the
        # rank's single q head reads on 1 x 4
        assert r[mesh]["cache_heads"] == 1
        for got, want in zip(r[mesh]["serve"], single_serve[against]):
            assert got.shape == want[rows].shape
            np.testing.assert_allclose(got, want[rows], rtol=0,
                                       atol=LOGIT_TOL)


@pytest.mark.parametrize("against", AGAINST)
def test_placed_cache_keeps_its_kv_heads_local(runs, single_serve, against):
    _, ranks = runs
    k = BATCH // 2
    for i, r in enumerate(ranks):
        rows = slice((i // 2) * k, (i // 2 + 1) * k)
        assert r["2x2"]["placed_heads"] == 1
        for got, want in zip(r["2x2"]["placed_serve"],
                             single_serve[against]):
            np.testing.assert_allclose(got, want[rows], rtol=0,
                                       atol=LOGIT_TOL)


# --------------------------------------------------------------------------
# (d) what a TP step sends over the model axis
# --------------------------------------------------------------------------

def _kv_slice_sizes(cfg, M):
    """Elements of a rank's slice of one layer's ``wk`` / ``wv`` and of
    ``bk`` / ``bv`` on a model axis of ``M``: what the ``M`` does not
    divide ``KV`` branch gathers."""
    kv = cfg.num_kv_heads * cfg.head_dim
    return {cfg.d_model * kv // M, kv // M}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_trunk_param_is_gathered_over_the_model_axis(runs, mesh):
    _, ranks = runs
    cfg = _cfg()
    M = MESHES[mesh][1]
    for r in ranks:
        got = r[mesh]
        tp_sent, comm_sent = got["sent"]
        assert comm_sent == {"exchange": 0, "gather": 0, "any": 0}
        assert tp_sent["reduce"] > 0 and tp_sent["max"] > 0
        assert got["model_reduces"] > 0
        if M == 2:
            assert got["model_gathers"] == []
            assert tp_sent["gather"] == 0
        else:
            # a layer's slice of wk / wv (or bk / bv)
            assert got["model_gathers"] and \
                set(got["model_gathers"]) <= _kv_slice_sizes(cfg, M)
            assert tp_sent["gather"] > 0


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_other_families_serve_tensor_parallel(runs, arch, against):
    """The other families' smoke configs on 2 x 2: each rank's prefill +
    2 decode steps of its two rows equal the single process's (the
    port's, the reference's) at 1e-4."""
    from repro_torch import convert
    _, ranks = runs
    cfg, params, batch, toks = _family_case(arch)
    if against == "port":
        want = _family_serve(cfg, convert.lm_params_from_numpy(params),
                             batch, toks)
    else:
        extra = cfg.num_patches if "patches" in batch else 0
        want = _reference_serve(cfg, params, batch, toks,
                                FAMILY_SEQ + extra + len(toks))
    for i, r in enumerate(ranks):
        rows = slice(2 * (i // 2), 2 * (i // 2) + 2)
        for got, w in zip(r["families"][arch], want):
            np.testing.assert_allclose(got, w[rows], rtol=0,
                                       atol=LOGIT_TOL)


# --------------------------------------------------------------------------
# the MoE variants' gradients on a mesh
# --------------------------------------------------------------------------

def _whole_moe_grads(against, E):
    """The gradients of sum(y * probe) through ``moe_forward`` on the
    whole batch w.r.t. x and the weights: the port's or the
    reference's (``jax.grad``)."""
    p, x, probe = _moe_inputs(E)
    if against == "port":
        from repro_torch.models import moe as M
        pt = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        y, _ = M.moe_forward(_moe_cfg(E), pt, xt)
        (y * torch.from_numpy(probe)).sum().backward()
        return xt.grad.numpy(), {k: v.grad.numpy() for k, v in pt.items()}
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JM
    jcfg = _jax_cfg(_moe_cfg(E))

    def f(p, x):
        return (JM.moe_forward(jcfg, p, x)[0] * jnp.asarray(probe)).sum()

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


@pytest.mark.parametrize("against", AGAINST)
@pytest.mark.parametrize("i", range(len(MOE_GRAD_CASES)),
                         ids=[fn for _, fn in MOE_GRAD_CASES])
def test_moe_variant_gradients_equal_one_device(runs, i, against):
    """Each rank's gradient w.r.t. its batch block is the whole one (the
    model ranks' partial gradients summed by ``copy_in``); the router's,
    the same on the model ranks of a block, summed over the blocks, and
    the experts' summed over every rank (the train step's ``Partial``
    on 'model') equal ``moe_forward``'s on the whole batch (the port's,
    the reference's) at 1e-5 of each largest |g| (capacity factor 16:
    nothing dropped)."""
    _, ranks = runs
    E, _ = MOE_GRAD_CASES[i]
    gx, gp = _whole_moe_grads(against, E)
    got_x = np.concatenate([ranks[r]["moe"][i][0] for r in (0, 2)])
    np.testing.assert_allclose(got_x, gx, rtol=0,
                               atol=1e-5 * float(np.abs(gx).max()))
    for k, v in gp.items():
        blocks = (0, 2) if k == "router" else range(4)
        got = sum(ranks[r]["moe"][i][1][k] for r in blocks)
        np.testing.assert_allclose(got, v, rtol=0,
                                   atol=1e-5 * float(np.abs(v).max()),
                                   err_msg=k)


# --------------------------------------------------------------------------
# (e) the dry run's per-rank dot FLOPs
# --------------------------------------------------------------------------

def _dot_flops(shape, mesh_shape):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import sharding_ctx
    if mesh_shape is None:
        fn, args, _ = build_cell(ARCH, shape, device="cpu", smoke=True)
        return dryrun.count_cell(fn, args)[1]["dot_flops"]
    n = int(np.prod(mesh_shape))
    with fake_world(n):
        mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
        try:
            fn, args, _ = build_cell(ARCH, shape, device="cpu", smoke=True,
                                     mesh=mesh)
            return dryrun.count_cell(fn, args)[1]["dot_flops"]
        finally:
            sharding_ctx.set_policy(None)
            sharding_ctx.set_shardmap_moe(None)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dot_flops_halve_on_a_model_axis_of_2(kind):
    shape = ShapeCfg(f"tp_{kind}", kind, 64, 4)
    one = _dot_flops(shape, None)
    assert one > 0
    assert _dot_flops(shape, (1, 2)) == one / 2


def _prefill_dot_flops(cfg, B, S):
    """A prefill's dot FLOPs by hand, (attention, MLP + head): the q / k /
    v / o products, the direct path's QK^T and PV over every head, the
    GLU's three products per layer, the head at the last position."""
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    T = B * S
    attn = cfg.num_layers * (2 * T * d * (H + 2 * KV) * Dh
                             + 2 * T * H * Dh * d + 4 * B * H * S * S * Dh)
    mlp = cfg.num_layers * 3 * 2 * T * d * cfg.d_ff
    return attn, mlp + 2 * B * d * cfg.vocab_size


def test_attention_stays_whole_where_the_model_axis_does_not_divide_heads():
    from repro_torch.launch.specs import model_cfg_for
    cfg = model_cfg_for(ARCH, smoke=True)
    assert cfg.num_heads % 16 and cfg.mlp_kind == "glu"
    S = 64
    shape = ShapeCfg("tp_prefill", "prefill", S, 16)
    attn, rest = _prefill_dot_flops(cfg, 16, S)
    assert _dot_flops(shape, None) == attn + rest
    # 16 x 16: one batch row a rank
    attn, rest = _prefill_dot_flops(cfg, 1, S)
    assert _dot_flops(shape, (16, 16)) == attn + rest / 16
